"""The port's streamed ring of several ranks (one ``SegmentStream`` and one
``Trainer`` per rank, gloo over CPU processes) against the JAX package's
streamed ``Trainer`` on XLA host devices.

Every session's global Φ (assembled from the ranks' views), Ψ and global z
store must equal JAX's bit for bit, and so must α where it is held; where
the ``AlphaOptimizer`` moves α, its Ω statistics are equal bit for bit and α
itself goes through digamma sums that round differently in each package, so
it is held at rtol 1e-5 (``test_torch_trainer.py`` does the same on one
device).

- JAX's ``STREAM_EQUIV_CODE`` on a 2×2 ring: from memory with prefetch on
  and off, from a directory written by either package, and one mmap'd
  segment equal to the resident rank run.
- The alias sampler on a 4×1 ring in 3 segments, from memory and disk.
- Word-sharded (P = 2) streaming on a 2×2 mesh from a directory written by
  each package and read by the other.
- JAX's ``CORPUS_DIR_E2E_CODE`` through the port's ``launch.train`` across
  ranks: memory, ``--corpus-dir``, a kill at a segment boundary and the
  resume.
- A killed streamed 2×2 checkpoint resumes in the other package.
- A ``disk.segment_read`` fault on rank 1 only: retried there, the same
  plane hits as JAX's plane, the same model; a corrupt segment fails the
  world.
- The sessions that the port refused before (a streamed corpus on 2×2,
  2×1, 1×2 and word-sharded 1×2 meshes) train one epoch equal to JAX.
"""
import os

import numpy as np
import pytest

import _torch_ranks as R
from _torch_port import one_torch_thread as _one_torch_thread  # noqa: F401  (autouse)
from repro_torch.launch import mesh

pytestmark = pytest.mark.port

BASE = dict(n_docs=200, vocab_size=120, n_topics=8, true_topics=6)
D2 = dict(BASE, n_epochs=4, alpha_opt_from=2, data_shards=2, model_shards=2)
A4 = dict(BASE, n_epochs=4, agg_every=2, alpha_opt_from=99, sampler="alias", data_shards=4,
          model_shards=1, n_segments=3)
P2 = dict(BASE, n_epochs=3, alpha_opt_from=99, data_shards=2, model_shards=2,
          n_model_shards=2)
E2 = dict(D2, n_segments=3, alpha_opt_from=99)
# the four sessions of several ranks that the port used to refuse, one epoch each
SESSION = dict(n_docs=300, vocab_size=150, n_topics=16, true_topics=8, n_epochs=1,
               agg_every=2, alpha_opt_from=99, seed=3)
REFUSED = {"2x2 in 3 segments": dict(data_shards=2, model_shards=2, n_segments=3),
           "2x1 in 2 segments": dict(data_shards=2, n_segments=2),
           "1x2 in 2 segments": dict(model_shards=2, n_segments=2),
           "1x2 word-sharded in 2 segments": dict(n_model_shards=2, model_shards=2,
                                                  n_segments=2)}

JAX_CODE = r"""
import numpy as np
from repro.data import save_segments
from repro.launch import train
from repro.reliability import faults
from repro.training import (AlphaOptimizer, Checkpointing, KillSwitch, Trainer,
                            TrainerConfig)

out = {}
def keep(label, tr):
    for i, x in enumerate(tr.state):
        out[f"{label}/state{i}"] = np.asarray(x)
    out[f"{label}/alpha"] = np.asarray(tr.alpha)
    if tr._z is not None:
        out[f"{label}/z"] = np.asarray(tr._z)
    if tr._streaming:
        tr._omega_parts.clear()
        out[f"{label}/omega"] = np.asarray(tr.alpha_statistics()[0])

def run(cfg_kw, cbs=(), **kw):
    tr = Trainer(TrainerConfig(**cfg_kw, **kw), callbacks=list(cbs))
    tr.log = lambda m: None
    try:
        tr.fit()
    except SystemExit as exc:
        assert exc.code == 17, exc.code
        return None
    return tr

D = %(DIRS)r
# STREAM_EQUIV on 2x2
mem = run(%(D2)r, n_segments=2, prefetch=False)
keep("a_mem", mem)
save_segments(mem.source, D["jax_a"])
keep("a_disk", run(%(D2)r, corpus_dir=D["jax_a"], prefetch=True))
gold = run(%(D2)r)
keep("a_gold", gold)
keep("a_alpha", run(%(D2)r, [AlphaOptimizer()], n_segments=2))
# alias on 4x1 in 3 segments
b = run(%(A4)r)
keep("b_mem", b)
save_segments(b.source, D["jax_b"])
# word-sharded P = 2, each package's directory read by the other
c = run(%(P2)r, n_segments=2)
keep("c_mem", c)
save_segments(c.source, D["jax_c"])
keep("c_from_port", run(%(P2)r, corpus_dir=D["port_c"]))
# checkpoints across packages
keep("e_gold", run(%(E2)r))
assert run(%(E2)r, [Checkpointing(every_segments=1), KillSwitch(3, at_segment=1)],
           ckpt_dir=D["jax_ck"]) is None
keep("e_jax_resumes_port", run(%(E2)r, [Checkpointing(every_segments=1)],
                               ckpt_dir=D["port_ck"], resume=True))
# a disk.segment_read fault: the first read of segment 0 fails, the retry reads
plane = faults.FaultPlane().fail("disk.segment_read", key="0", nth=1)
with faults.injected(plane):
    f = run(%(D2)r, corpus_dir=D["jax_a"])
keep("f_fault", f)
out["f_hits"] = np.array([plane.hits("disk.segment_read"), plane.injected("disk.segment_read")])
# CORPUS_DIR_E2E through the driver
def argv(ck, extra=()):
    return ["--docs","200","--vocab","120","--topics","8","--true-topics","6",
            "--epochs","4","--data-shards","2","--model-shards","2",
            "--alpha-opt-from","2","--ckpt-dir",ck,"--ckpt-every","2",
            "--bench-out",""] + list(extra)
keep("d_mem", train.main(argv(D["jax_d_ck"], ["--n-segments","4"])))
# the sessions the port used to refuse
for i, kw in enumerate(%(REFUSED)r):
    keep(f"h{i}", run(%(SESSION)r, **kw))
np.savez(OUT, **out)
"""


def _port_dirs(root):
    """The port's save_segments directories (its own synthetic corpora)."""
    from repro_torch.data import sources

    def source(cfg, n_segments):
        P = cfg.get("n_model_shards", 1)
        M = cfg["data_shards"] * (1 if P > 1 else cfg["model_shards"])
        return sources.SyntheticSource(
            n_docs=cfg["n_docs"], vocab_size=cfg["vocab_size"], true_topics=cfg["true_topics"],
            doc_len_mean=8, gen_seed=0, n_segments=n_segments, n_data_shards=M,
            n_vocab_shards=M, n_topics=cfg["n_topics"], seed=1, n_model_shards=P)

    for name, cfg, n in (("port_a", D2, 2), ("port_a1", D2, 1), ("port_c", P2, 2),
                         ("port_d", D2, 4)):
        sources.save_segments(source(cfg, n), os.path.join(root, name))


def _spawn(world, runs, **kw):
    return mesh.spawn(R.stream_world, data=world, device="cpu", threads=1,
                      timeout_s=R.TIMEOUT_S, args=(runs,), **kw)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from conftest import run_with_devices

    root = str(tmp_path_factory.mktemp("stream_ranks"))
    dirs = {k: os.path.join(root, k) for k in ("jax_a", "jax_b", "jax_c", "port_a", "port_a1",
                                               "port_c", "port_d", "jax_ck", "port_ck",
                                               "jax_d_ck")}
    _port_dirs(root)
    killed = _spawn(4, [("e_killed", (2, 2), dict(cfg_kw=E2, ckpt=dirs["port_ck"], kill=3,
                                                   ckpt_segments=1, kill_segment=1))])
    jax = R.jax_run(run_with_devices, JAX_CODE % dict(
        DIRS=dirs, D2=D2, A4=A4, P2=P2, E2=E2, SESSION=SESSION, REFUSED=list(REFUSED.values())),
        n_devices=4)
    fault = (1, "0", 1)         # rank 1's first read of segment 0 fails
    port = _spawn(4, [
        ("a_mem", (2, 2), dict(cfg_kw=dict(D2, n_segments=2, prefetch=False))),
        ("a_prefetch", (2, 2), dict(cfg_kw=dict(D2, n_segments=2, prefetch=True))),
        ("a_disk_jax", (2, 2), dict(cfg_kw=dict(D2, corpus_dir=dirs["jax_a"]))),
        ("a_disk_port", (2, 2), dict(cfg_kw=dict(D2, corpus_dir=dirs["port_a"], prefetch=False))),
        ("a_gold", (2, 2), dict(cfg_kw=D2)),
        ("a_one", (2, 2), dict(cfg_kw=dict(D2, corpus_dir=dirs["port_a1"]))),
        ("a_alpha", (2, 2), dict(cfg_kw=dict(D2, n_segments=2), alpha_opt=True)),
        ("b_mem", (4, 1), dict(cfg_kw=A4)),
        ("b_no_prefetch", (4, 1), dict(cfg_kw=dict(A4, prefetch=False))),
        ("b_disk", (4, 1), dict(cfg_kw=dict(A4, n_segments=1, corpus_dir=dirs["jax_b"]))),
        ("c_mem", (2, 2), dict(cfg_kw=dict(P2, n_segments=2))),
        ("c_from_jax", (2, 2), dict(cfg_kw=dict(P2, corpus_dir=dirs["jax_c"]))),
        ("e_gold", (2, 2), dict(cfg_kw=E2)),
        ("e_port_resumes_jax", (2, 2), dict(cfg_kw=E2, ckpt=dirs["jax_ck"], resume=True,
                                            ckpt_segments=1)),
        ("e_resumed", (2, 2), dict(cfg_kw=E2, ckpt=dirs["port_ck"], resume=True,
                                   ckpt_segments=1)),
        ("f_fault", (2, 2), dict(cfg_kw=dict(D2, corpus_dir=dirs["jax_a"]), fault_on=fault)),
        ("h0", (2, 2), dict(cfg_kw=dict(SESSION, **REFUSED["2x2 in 3 segments"]))),
    ])
    two = _spawn(2, [(f"h{i}", (kw.get("data_shards", 1), kw["model_shards"] if "model_shards"
                                in kw else 1), dict(cfg_kw=dict(SESSION, **kw)))
                     for i, kw in enumerate(REFUSED.values()) if i > 0])
    return dict(port=port, killed=killed, two=two, jax=jax, dirs=dirs)


def _same(got, jax, label, what, alpha_rtol=None, omega=None):
    """The port's global tree ``got`` against JAX's run ``label``: every
    state leaf, the z store and α (bit for bit, or α at ``alpha_rtol``), and
    the port's Ω statistics ``omega`` bit for bit where given."""
    if omega is not None:
        np.testing.assert_array_equal(omega, jax[f"{label}/omega"], err_msg=f"{what}: Ω")
    for i, x in enumerate(got["state"]):
        want = jax[f"{label}/state{i}"]
        np.testing.assert_array_equal(np.asarray(x), want.astype(np.asarray(x).dtype),
                                      err_msg=f"{what}: state leaf {i}")
    if f"{label}/z" in jax:
        np.testing.assert_array_equal(got["z"], jax[f"{label}/z"], err_msg=f"{what}: z")
    if alpha_rtol is None:
        np.testing.assert_array_equal(got["alpha"], jax[f"{label}/alpha"], err_msg=f"{what}: α")
    else:
        np.testing.assert_allclose(got["alpha"], jax[f"{label}/alpha"], rtol=alpha_rtol,
                                   err_msg=f"{what}: α")


def test_stream_equiv_2x2_matches_jax(runs):
    """Memory (prefetch off and on) and disk (either package's directory)
    equal JAX's streamed session; a single mmap'd segment equals the
    resident rank run."""
    port, jax = runs["port"][0], runs["jax"]
    for label in ("a_mem", "a_prefetch", "a_disk_jax", "a_disk_port"):
        _same(port[label]["tree"], jax, "a_mem", label, omega=port[label]["omega"])
    _same(port["a_disk_jax"]["tree"], jax, "a_disk", "JAX's disk run")
    _same(port["a_gold"]["tree"], jax, "a_gold", "the resident 2x2 run")
    gold, one = port["a_gold"]["tree"], port["a_one"]["tree"]
    np.testing.assert_array_equal(one["state"][0], gold["state"][0])
    np.testing.assert_array_equal(one["state"][1], gold["state"][1])
    wl, uid, z = gold["state"][2], gold["state"][4], gold["state"][5]
    np.testing.assert_array_equal(one["z"], R.z_by_uid(wl, uid, z, one["z"].shape[0]))
    assert all(p["a_mem"]["tree"] is None for p in runs["port"][1:])


def test_stream_alpha_statistics_match_jax(runs):
    """With the ``AlphaOptimizer`` the model stays equal; α is re-estimated
    from the same Ω (rtol 1e-5: the digamma sums)."""
    port, jax = runs["port"][0], runs["jax"]
    _same(port["a_alpha"]["tree"], jax, "a_alpha", "α re-estimated", alpha_rtol=1e-5,
          omega=port["a_alpha"]["omega"])
    assert not np.array_equal(port["a_alpha"]["tree"]["alpha"], jax["a_mem/alpha"])
    assert all(np.array_equal(p["a_alpha"]["omega"], port["a_alpha"]["omega"])
               for p in runs["port"][1:])


def test_stream_alias_4x1_matches_jax(runs):
    port, jax = runs["port"][0], runs["jax"]
    for label in ("b_mem", "b_no_prefetch", "b_disk"):
        _same(port[label]["tree"], jax, "b_mem", f"alias 4x1 {label}", omega=port[label]["omega"])


def test_stream_word_sharded_directories_cross_packages(runs):
    port, jax = runs["port"][0], runs["jax"]
    _same(port["c_mem"]["tree"], jax, "c_mem", "P = 2 from memory", omega=port["c_mem"]["omega"])
    _same(port["c_from_jax"]["tree"], jax, "c_mem", "P = 2 from JAX's directory",
          omega=port["c_from_jax"]["omega"])
    for i in range(2):
        np.testing.assert_array_equal(jax[f"c_from_port/state{i}"], jax[f"c_mem/state{i}"],
                                      err_msg=f"JAX from the port's directory: leaf {i}")
    np.testing.assert_array_equal(jax["c_from_port/z"], jax["c_mem/z"])


def test_stream_checkpoints_cross_packages(runs):
    port, jax = runs["port"][0], runs["jax"]
    assert all(r["e_killed"] == {"killed": 17} for r in runs["killed"])
    _same(port["e_gold"]["tree"], jax, "e_gold", "uninterrupted")
    _same(port["e_resumed"]["tree"], jax, "e_gold", "killed at a segment and resumed")
    _same(port["e_port_resumes_jax"]["tree"], jax, "e_gold", "the port resuming JAX's")
    for i in range(2):
        np.testing.assert_array_equal(jax[f"e_jax_resumes_port/state{i}"], jax[f"e_gold/state{i}"],
                                      err_msg=f"JAX resuming the port's checkpoint: leaf {i}")
    np.testing.assert_array_equal(jax["e_jax_resumes_port/z"], jax["e_gold/z"])


def test_stream_fault_on_one_rank_is_retried_there(runs):
    """Rank 1's plane fails its first read of segment 0: retried on rank 1,
    the same hits and injections as JAX's plane over the same reads, and the
    same model as the run without the fault."""
    port, jax = runs["port"], runs["jax"]
    hits = [p["f_fault"]["hits"] for p in port]
    assert hits[0] is None and hits[2] is None and hits[3] is None
    assert list(hits[1]) == list(jax["f_hits"]) and hits[1][1] == 1
    _same(port[0]["f_fault"]["tree"], jax, "a_disk", "the faulted run")


def test_stream_corrupt_segment_fails_the_world(runs, tmp_path):
    import shutil

    import torch.multiprocessing as mp

    d = str(tmp_path / "segs")
    shutil.copytree(runs["dirs"]["port_a"], d)
    path = os.path.join(d, "segment_00001", "z0.npy")
    with open(path, "r+b") as f:
        f.seek(os.path.getsize(path) - 4)
        f.write(b"\x07\x00\x00\x00")
    with pytest.raises((mp.ProcessRaisedException, mp.ProcessExitedException),
                       match="corrupt"):
        _spawn(4, [("bad", (2, 2), dict(cfg_kw=dict(D2, corpus_dir=d)))])


@pytest.mark.parametrize("case", list(REFUSED))
def test_streamed_sessions_of_several_ranks_match_jax(runs, case):
    i = list(REFUSED).index(case)
    got = runs["port"][0] if i == 0 else runs["two"][0]
    _same(got[f"h{i}"]["tree"], runs["jax"], f"h{i}", case)


def test_launch_train_corpus_dir_across_ranks(runs, tmp_path):
    """JAX's ``CORPUS_DIR_E2E_CODE`` through ``repro_torch.launch.train`` on
    a 2×2 mesh of ranks: the 4-segment synthetic run equals JAX's driver;
    the same corpus from ``--corpus-dir``, and killed at a segment boundary
    then ``--resume``d, equal it bit for bit."""
    import contextlib
    import io

    from repro_torch.core import distributed as dist
    from repro_torch.dist import sharding as shd
    from repro_torch.launch import train as tlaunch

    def argv(ck, extra=()):
        return ["--device", "cpu", "--docs", "200", "--vocab", "120", "--topics", "8",
                "--true-topics", "6", "--epochs", "4", "--data-shards", "2",
                "--model-shards", "2", "--alpha-opt-from", "2", "--ckpt-dir", ck,
                "--ckpt-every", "2", "--bench-out", ""] + list(extra)

    def run(ck, extra):
        with contextlib.redirect_stdout(io.StringIO()):
            return tlaunch.main(argv(str(tmp_path / ck), extra))

    def model(ranks):
        phi = shd.assemble([r["state"][0] for r in ranks], dist.specs(1)["phi"],
                           shd.RankLayout(1, 2, 2))
        return {"state": (phi, ranks[0]["state"][1]), "z": ranks[0]["z"],
                "alpha": ranks[0]["alpha"]}

    d = runs["dirs"]["port_d"]
    mem = run("mem", ["--n-segments", "4"])
    _same(model(mem), runs["jax"], "d_mem", "launch.train in 4 segments", alpha_rtol=1e-5)
    disk = run("disk", ["--corpus-dir", d])
    with pytest.raises(SystemExit) as exc:
        run("ck", ["--corpus-dir", d, "--ckpt-segments", "1", "--kill-at", "3",
                   "--kill-at-segment", "2"])
    assert exc.value.code == 17
    res = run("ck", ["--corpus-dir", d, "--resume"])
    gold = model(mem)
    for label, r in (("--corpus-dir", disk), ("killed and resumed", res)):
        assert all(x["epoch"] == 4 for x in r)
        got = model(r)
        for i in (0, 1):
            np.testing.assert_array_equal(got["state"][i], gold["state"][i],
                                          err_msg=f"{label}: leaf {i}")
        np.testing.assert_array_equal(got["z"], gold["z"], err_msg=label)
        np.testing.assert_array_equal(got["alpha"], gold["alpha"], err_msg=label)
