"""The port's multi-rank ``Trainer`` (2 pods × a 2×2 ring: 8 ranks, gloo
over CPU processes) against the JAX package's ``Trainer`` on 8 XLA host
devices, and ``python -m repro_torch.launch.train`` across ranks.

- Elastic publish: pod 1 dead at the first boundary, both live at the
  second, α re-estimated from epoch 1 (pod 0's Ω): the global state and α
  equal JAX's bit for bit, ``last_n_live`` is 2, two merges are timed and two
  snapshots published.
- Mid-window resume: a checkpoint at epoch 3 lies between the boundaries at
  2 and 4; kill → resume equals the uninterrupted run and JAX's, and the
  checkpoints cross packages both ways (the port resumes JAX's, JAX resumes
  the port's), each equal to the uninterrupted run.
- ``launch.train --pods 2 --data-shards 2``: kill → resume → publish equals
  the uninterrupted run (state, α and the published model); a
  ``--sharded-model`` checkpoint (P = 2) resumes at P = 1 and equals the
  uninterrupted P = 1 run.
"""
import os

import numpy as np
import pytest

import _torch_ranks as R
from _torch_port import one_torch_thread as _one_torch_thread  # noqa: F401  (autouse)
from repro_torch.launch import mesh

pytestmark = pytest.mark.port

ELASTIC = dict(n_docs=300, vocab_size=200, n_topics=12, true_topics=10, n_pods=2,
               data_shards=2, model_shards=2, n_epochs=4, agg_every=2, alpha_opt_from=1)
SCHEDULE = {1: [1, 0], 3: [1, 1]}
MIDWIN = dict(n_docs=240, vocab_size=150, n_topics=10, true_topics=8, n_pods=2,
              data_shards=2, model_shards=2, n_epochs=4, agg_every=2, alpha_opt_from=99)

JAX_CODE = r"""
import numpy as np
from repro.training import (Checkpointing, ElasticLiveness, KillSwitch, Metrics,
                            ModelPublisher, Trainer, TrainerConfig)

def run(cfg_kw, ck=None, kill=None, resume=False, schedule=None, publish=None):
    cfg = TrainerConfig(ckpt_dir=ck, resume=resume, ckpt_every=3, **cfg_kw)
    cbs, live = [], None
    if schedule:
        live = ElasticLiveness(lambda ep: np.array(schedule[ep]))
        cbs.append(live)
    if ck:
        cbs.append(Checkpointing())
    if kill:
        cbs.append(KillSwitch(kill))
    if publish:
        cbs.append(ModelPublisher(publish, every=1))
    cbs.append(Metrics(printer=lambda m: None))
    tr = Trainer(cfg, callbacks=cbs)
    tr.log = lambda m: None
    try:
        tr.fit()
    except SystemExit:
        return None
    return tr

out = {}
def keep(label, tr):
    for i, x in enumerate(tr.state):
        out[f"{label}/state{i}"] = np.asarray(x)
    out[f"{label}/alpha"] = np.asarray(tr.alpha)

keep("elastic", run(%(ELASTIC)r, schedule=%(SCHEDULE)r, publish=%(SNAP)r))
keep("gold", run(%(MIDWIN)r))
assert run(%(MIDWIN)r, ck=%(JCK)r, kill=3) is None
keep("jax_resumes_port", run(%(MIDWIN)r, ck=%(PCK)r, resume=True))
np.savez(OUT, **out)
"""


def _same(tree, jax, label, what):
    for i, x in enumerate(tree["state"]):
        np.testing.assert_array_equal(np.asarray(x), jax[f"{label}/state{i}"],
                                      err_msg=f"{what}: state leaf {i}")
    np.testing.assert_array_equal(np.asarray(tree["alpha"]), jax[f"{label}/alpha"],
                                  err_msg=f"{what}: alpha")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from conftest import run_with_devices

    root = tmp_path_factory.mktemp("multipod")
    pck, jck = str(root / "port_ck"), str(root / "jax_ck")
    port = mesh.spawn(R.trainer_runs, pods=2, data=2, model=2, device="cpu", threads=1, timeout_s=R.TIMEOUT_S, args=([
        ("elastic", dict(cfg_kw=ELASTIC, schedule=SCHEDULE, publish=str(root / "snap"))),
        ("gold", dict(cfg_kw=MIDWIN)),
        ("killed", dict(cfg_kw=MIDWIN, ckpt=pck, kill=3, ckpt_every=3)),
        ("resumed", dict(cfg_kw=MIDWIN, ckpt=pck, resume=True, ckpt_every=3)),
    ],))
    jax = R.jax_run(run_with_devices, JAX_CODE % dict(
        ELASTIC=ELASTIC, SCHEDULE=SCHEDULE, MIDWIN=MIDWIN, SNAP=str(root / "jsnap"), JCK=jck,
        PCK=pck), n_devices=8)
    cross = mesh.spawn(R.trainer_runs, pods=2, data=2, model=2, device="cpu", threads=1, timeout_s=R.TIMEOUT_S, args=([
        ("port_resumes_jax", dict(cfg_kw=MIDWIN, ckpt=jck, resume=True, ckpt_every=3))],))
    return port, cross, jax


def test_multipod_elastic_publish_matches_jax(runs):
    port, _, jax = runs
    r0 = port[0]["elastic"]
    _same(r0["tree"], jax, "elastic", "elastic session")
    phi = r0["tree"]["state"][0]
    assert (phi[0] == phi[1]).all(), "pods disagree after aggregation"
    assert all(p["elastic"]["n_live"] == 2 for p in port)
    assert all(p["elastic"]["n_agg"] == 2 for p in port)
    assert r0["version"] == 1 and all(p["elastic"]["tree"] is None for p in port[1:])


def test_multipod_mid_window_resume_matches_jax(runs):
    port, _, jax = runs
    assert all(p["killed"] == {"killed": 17} for p in port)
    gold, res = port[0]["gold"]["tree"], port[0]["resumed"]["tree"]
    _same(gold, jax, "gold", "uninterrupted")
    _same(res, jax, "gold", "killed and resumed")
    assert (res["state"][0][0] == res["state"][0][1]).all()


def test_multipod_checkpoints_cross_packages(runs):
    port, cross, jax = runs
    _same(cross[0]["port_resumes_jax"]["tree"], jax, "gold", "the port resuming JAX's checkpoint")
    for i in range(6):
        np.testing.assert_array_equal(jax[f"jax_resumes_port/state{i}"], jax[f"gold/state{i}"],
                                      err_msg=f"JAX resuming the port's checkpoint: leaf {i}")


def _launch(ck, *extra, snap=None):
    from repro_torch.launch import train as tlaunch

    argv = ["--device", "cpu", "--docs", "240", "--vocab", "120", "--topics", "8",
            "--true-topics", "6", "--epochs", "6", "--agg-every", "2", "--alpha-opt-from", "3",
            "--ckpt-every", "2", "--bench-out", "", "--ckpt-dir", ck, *extra]
    if snap:
        argv += ["--publish-dir", snap]
    try:
        return tlaunch.main(argv), 0
    except SystemExit as exc:
        return None, exc.code


def test_launch_train_pods_kill_resume_publish(tmp_path):
    from repro_torch.checkpoint import snapshots

    mesh_flags = ("--pods", "2", "--data-shards", "2")
    gold, _ = _launch(str(tmp_path / "gold"), *mesh_flags, snap=str(tmp_path / "s_gold"))
    _, code = _launch(str(tmp_path / "ck"), *mesh_flags, "--kill-at", "3")
    assert code == 17
    res, _ = _launch(str(tmp_path / "ck"), *mesh_flags, "--resume", snap=str(tmp_path / "s_res"))
    assert len(gold) == len(res) == 4
    for g, r in zip(gold, res):
        assert r["epoch"] == 6
        for i, (a, b) in enumerate(zip(g["state"], r["state"])):
            np.testing.assert_array_equal(a, b, err_msg=f"rank {g['rank']} leaf {i}")
        np.testing.assert_array_equal(g["alpha"], r["alpha"])
    m = {k: snapshots.load_snapshot(str(tmp_path / k), device="cpu") for k in ("s_gold", "s_res")}
    assert m["s_gold"][1]["epoch"] == m["s_res"][1]["epoch"] == 6
    np.testing.assert_array_equal(m["s_gold"][0].pvk.numpy(), m["s_res"][0].pvk.numpy())
    assert os.listdir(tmp_path / "ck")


def test_launch_train_sharded_checkpoint_reshards_to_p1(tmp_path):
    import torch

    from repro_torch.core import distributed as tdist
    from repro_torch.data import corpus as tcorpus, synthetic as tsynthetic

    _, code = _launch(str(tmp_path / "ck"), "--data-shards", "2", "--model-shards", "2",
                      "--sharded-model", "--kill-at", "4")
    assert code == 17
    res, _ = _launch(str(tmp_path / "ck"), "--data-shards", "2", "--resume")
    gold, _ = _launch(str(tmp_path / "gold"), "--data-shards", "2")
    corpus, _ = tsynthetic.lda_corpus(seed=0, n_docs=240, n_topics=6, vocab_size=120,
                                      doc_len_mean=8)
    sc = tcorpus.shard_corpus(corpus, 2, 2, 8, seed=1)
    for g, r in zip(gold, res):
        for i, (a, b) in enumerate(zip(g["state"], r["state"])):
            np.testing.assert_array_equal(a, b, err_msg=f"rank {g['rank']} leaf {i}")
        np.testing.assert_array_equal(g["alpha"], r["alpha"])
    phi = np.concatenate([g["state"][0] for g in gold])
    assert tdist.gather_phi(torch.from_numpy(phi), sc).sum() == corpus.n_tokens
