"""The port's checkpoint I/O, checkpoint manager and serving snapshots: the
JAX package's checkpoint and snapshot tests on the port, and the same files
read across the two packages in both directions."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import io as jio, snapshots as jsnap
from repro.core import rtlda as jrtlda
from repro_torch.checkpoint import io, snapshots
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core import rtlda

pytestmark = pytest.mark.port

K, V = 6, 40


def _nested():
    """A tree with every container kind a checkpoint holds, numpy leaves."""
    rng = np.random.default_rng(0)
    return {"state": (rng.integers(0, 9, (1, 4, 3)).astype(np.int32),
                      np.arange(3, dtype=np.int32),
                      np.arange(5, dtype=np.uint32) * 7),
            "alpha": rng.random(3).astype(np.float32),
            "b": [np.float32(0.5), None, {"y": np.ones(2, np.int8), "x": np.zeros(1)}],
            "a": None}


def _model(seed=0):
    rng = np.random.default_rng(seed)
    phi = torch.from_numpy(rng.integers(0, 20, (V, K)).astype(np.int32))
    return rtlda.build_model(phi, torch.tensor(0.01), torch.full((K,), 0.5), device="cpu")


def _same_model(a, b):
    for f in ("pvk", "alpha", "r_topic", "r_value"):
        np.testing.assert_array_equal(np.asarray(getattr(a, f)), np.asarray(getattr(b, f)),
                                      err_msg=f)


# ------------------------------ checkpoint ---------------------------------

def test_leaf_order_is_jax_tree_flatten():
    tree = _nested()
    mine = list(io.leaves(tree))
    ref = jax.tree.leaves(tree)
    assert len(mine) == len(ref)
    for a, b in zip(mine, ref):
        assert a is b
    back = io.unflatten(tree, [np.asarray(x) * 0 for x in mine])
    assert back["b"][1] is None and back["a"] is None and isinstance(back["state"], tuple)


def test_save_load_roundtrip(tmp_path):
    tree = {"a": torch.arange(10), "b": {"c": torch.ones((3, 4)),
                                         "d": np.uint32(7)}}
    p = str(tmp_path / "ckpt")
    io.save(p, tree, meta={"step": 3})
    restored, meta = io.load(p, tree)
    assert meta["step"] == 3
    for a, b in zip(io.leaves(tree), io.leaves(restored)):
        np.testing.assert_array_equal(io.to_numpy(a), b)
        assert io.to_numpy(a).dtype == b.dtype


def test_incomplete_checkpoint_invisible(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    tree = {"x": torch.ones(4)}
    mgr.save(1, tree)
    broken = str(tmp_path / "step_00000002")          # a crash mid-write
    os.makedirs(broken)
    with open(os.path.join(broken, io.PAYLOAD), "wb") as f:
        f.write(b"partial garbage")
    assert mgr.steps() == [1]
    _, meta = mgr.restore_latest(tree)
    assert meta["step"] == 1


def test_rotation_keeps_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in range(5):
        mgr.save(s, {"x": torch.ones(2) * s})
    assert mgr.steps() == [3, 4]


def test_async_save(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    mgr.save(7, {"x": torch.arange(5)})
    mgr.wait()
    assert mgr.steps() == [7]


def test_async_save_snapshots_before_mutation(tmp_path):
    """The host copy happens in ``save``: the caller may update its tensors
    in place right after it returns."""
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    tree = {"x": torch.arange(8, dtype=torch.int32)}
    mgr.save(1, tree)
    tree["x"][:] = -1
    mgr.wait()
    restored, meta = mgr.restore_latest({"x": np.zeros(8, np.int32)})
    assert meta["step"] == 1
    np.testing.assert_array_equal(restored["x"], np.arange(8))


def test_async_save_wait_serializes_back_to_back(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=True, keep=5)
    mgr.save(1, {"x": torch.zeros(4)})
    mgr.save(2, {"x": torch.ones(4)})       # waits for step 1
    mgr.wait()
    mgr.wait()
    assert mgr.steps() == [1, 2]
    restored, _ = mgr.restore_latest({"x": np.zeros(4)})
    np.testing.assert_array_equal(restored["x"], np.ones(4))


def test_corrupt_checkpoint_raises_and_restore_falls_back(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=5)
    mgr.save(1, {"x": torch.zeros(4)})
    mgr.save(2, {"x": torch.ones(4)})
    payload = os.path.join(mgr.step_dir(2), io.PAYLOAD)
    with open(payload, "r+b") as f:
        f.seek(-8, os.SEEK_END)
        f.write(b"\xff" * 8)
    with pytest.raises(io.IntegrityError):
        io.load(mgr.step_dir(2), {"x": 0})
    with pytest.raises(io.IntegrityError):
        io.verify(mgr.step_dir(2))
    restored, meta = mgr.restore_latest({"x": 0})
    assert meta["step"] == 1 and mgr.steps() == [1]
    assert os.path.isdir(mgr.step_dir(2) + ".corrupt")
    with pytest.raises(ValueError, match="leaves"):
        io.load(mgr.step_dir(1), {"x": 0, "y": 0})


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_crosses_packages(tmp_path, writer):
    tree = _nested()
    p = str(tmp_path / "ck")
    if writer == "jax":
        jio.save(p, jax.tree.map(jnp.asarray, tree), meta={"step": 4, "epoch": 4})
        restored, meta = io.load(p, tree)
    else:
        io.save(p, {**tree, "alpha": torch.from_numpy(tree["alpha"])},
                meta={"step": 4, "epoch": 4})
        restored, meta = jio.load(p, tree)
    assert meta == {"step": 4, "epoch": 4}
    ref = jax.tree.leaves(tree)
    got = jax.tree.leaves(restored)
    assert len(got) == len(ref)
    for a, b in zip(ref, got):
        # x64 is off on the JAX side: its float64 leaf is written as float32
        b = np.asarray(b)
        np.testing.assert_array_equal(b, np.asarray(a).astype(b.dtype))
        if np.asarray(a).dtype != np.float64:
            assert b.dtype == np.asarray(a).dtype


# ------------------------------ snapshots ----------------------------------

def test_snapshot_roundtrip(tmp_path):
    root = str(tmp_path)
    m = _model()
    snapshots.save_snapshot(root, 0, m, meta={"epoch": 3})
    model, meta = snapshots.load_snapshot(root, device="cpu")
    assert meta["version"] == 0 and meta["epoch"] == 3
    _same_model(model, m)


def test_snapshot_versions_skip_incomplete(tmp_path):
    root = str(tmp_path)
    snapshots.save_snapshot(root, 0, _model())
    snapshots.save_snapshot(root, 1, _model(1))
    broken = snapshots.snapshot_path(root, 2)
    os.makedirs(broken)
    with open(os.path.join(broken, io.PAYLOAD), "wb") as f:
        f.write(b"partial garbage")
    os.makedirs(str(tmp_path / "not_a_snapshot"))
    assert snapshots.snapshot_versions(root) == [0, 1]
    assert snapshots.latest_version(root) == 1


def test_snapshot_rotation_and_quarantine(tmp_path):
    root = str(tmp_path)
    for v in range(5):
        snapshots.save_snapshot(root, v, _model(v))
    assert snapshots.rotate_snapshots(root, keep=2) == [0, 1, 2]
    assert snapshots.snapshot_versions(root) == [3, 4]
    dst = snapshots.quarantine_snapshot(root, 4)
    assert dst.endswith(".corrupt") and snapshots.snapshot_versions(root) == [3]
    assert snapshots.quarantine_snapshot(root, 4) is None


def test_delta_snapshot_reconstructs_and_rotation_keeps_its_base(tmp_path):
    root = str(tmp_path)
    base = _model(0)
    snapshots.save_snapshot(root, 0, base)
    pvk = base.pvk.clone()
    pvk[[3, 17]] += 0.25
    new = rtlda.RTLDAModel(pvk=pvk, alpha=base.alpha * 2, r_topic=base.r_topic,
                           r_value=base.r_value)
    snapshots.save_delta_snapshot(root, 1, new, 0, base.pvk, meta={"epoch": 2})
    d = snapshots.read_meta(root, 1)["delta"]
    assert d == {"base_version": 0, "n_rows": 2, "n_rows_total": V}
    model, meta = snapshots.load_snapshot(root, device="cpu")
    assert meta["version"] == 1
    _same_model(model, new)
    snapshots.save_snapshot(root, 2, _model(2))
    assert snapshots.rotate_snapshots(root, keep=2) == []        # v0 is v1's base
    with pytest.raises(ValueError, match="shape"):
        snapshots.save_delta_snapshot(root, 3, new, 0, base.pvk[:, :3])
    # a corrupt base is attributed to its own version
    with open(os.path.join(snapshots.snapshot_path(root, 0), io.PAYLOAD), "r+b") as f:
        f.seek(-8, os.SEEK_END)
        f.write(b"\xff" * 8)
    with pytest.raises(io.IntegrityError) as exc:
        snapshots.load_snapshot(root, 1, device="cpu")
    assert exc.value.version == 0


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_snapshot_crosses_packages(tmp_path, writer):
    root = str(tmp_path)
    rng = np.random.default_rng(1)
    phi = rng.integers(0, 20, (V, K)).astype(np.int32)
    jm = jrtlda.build_model(jnp.asarray(phi), jnp.float32(0.01), jnp.full((K,), 0.5))
    tm = rtlda.build_model(torch.from_numpy(phi), torch.tensor(0.01),
                           torch.full((K,), 0.5), device="cpu")
    phi2 = phi.copy()
    phi2[5] += 3
    jm2 = jrtlda.build_model(jnp.asarray(phi2), jnp.float32(0.01), jnp.full((K,), 0.5))
    tm2 = rtlda.build_model(torch.from_numpy(phi2), torch.tensor(0.01),
                            torch.full((K,), 0.5), device="cpu")
    if writer == "jax":
        jsnap.save_snapshot(root, 0, jm, {"epoch": 1})
        jsnap.save_delta_snapshot(root, 1, jm2, 0, jm.pvk, {"epoch": 2})
        wrote = (jm, jm2)
        loaded = [snapshots.load_snapshot(root, v, device="cpu") for v in (0, 1)]
    else:
        snapshots.save_snapshot(root, 0, tm, {"epoch": 1})
        snapshots.save_delta_snapshot(root, 1, tm2, 0, tm.pvk, {"epoch": 2})
        wrote = (tm, tm2)
        loaded = [jsnap.load_snapshot(root, v) for v in (0, 1)]
    for (model, meta), ref, v in zip(loaded, wrote, (0, 1)):
        assert meta["version"] == v and meta["epoch"] == v + 1
        _same_model(model, ref)
