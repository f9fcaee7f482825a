"""The port's ``TrainerConfig``, ``Trainer`` and ``launch.train`` against the
JAX package's, on one device in-process.

The two trainers run the same session (synthetic corpus, shards, seeds) on
the CPU: the alias sampler must give the same state bit for bit, and so must
the dense one (a difference would be allowed only at a near-tie of the
Gumbel-max scores). α re-estimation goes through digamma sums, equal only to
rounding, so these sessions keep it past their last epoch and one
``AlphaOptimizer`` step is held separately at rtol 1e-5. Checkpoints written
by either trainer resume in the other.
"""
import json

import numpy as np
import pytest
import torch

from _torch_port import one_torch_thread as _one_torch_thread  # noqa: F401  (autouse)
from repro import training as jtraining
from repro_torch import training as ttraining
from repro_torch.checkpoint import snapshots
from repro_torch.launch import train as tlaunch
from repro_torch.training.config import TrainerConfig

pytestmark = pytest.mark.port

SESSION = dict(n_docs=300, vocab_size=150, n_topics=16, true_topics=8, n_epochs=5,
               agg_every=2, alpha_opt_from=99, seed=3)


def _quiet(tr):
    tr.log = lambda msg: None
    return tr


def _jax_trainer(callbacks=(), **kw):
    cfg = jtraining.TrainerConfig(**{**SESSION, **kw})
    return _quiet(jtraining.Trainer(cfg, callbacks=list(callbacks)))


def _port_trainer(callbacks=(), **kw):
    cfg = ttraining.TrainerConfig(**{**SESSION, "device": "cpu", **kw})
    return _quiet(ttraining.Trainer(cfg, callbacks=list(callbacks)))


def _metrics(pkg):
    return pkg.Metrics(printer=lambda msg: None)


def _same_state(t_state, j_state, label):
    for i, name in enumerate(("phi", "psi", "word_local", "doc_local", "uid", "z")):
        a, b = np.asarray(t_state[i]), np.asarray(j_state[i])
        diff = int((a != b).sum())
        if diff:
            print(f"[{label}] {name}: {diff} entries differ from JAX")
        np.testing.assert_array_equal(a, b.astype(a.dtype), err_msg=f"{label}: {name}")


# ------------------------------ config ------------------------------------

def test_config_defaults_valid():
    cfg = TrainerConfig()
    assert cfg.ring_size == 1 and cfg.n_devices == 1 and not cfg.multi_pod
    assert cfg.device == "cuda" and cfg.sampler == "dense"


@pytest.mark.parametrize("bad", [
    dict(n_docs=0), dict(n_topics=1), dict(n_pods=0), dict(agg_every=0),
    dict(beta=0.0), dict(alpha0=-1.0), dict(package_len=-1),
    dict(ckpt_every=-2), dict(sampler="gibbs"), dict(device="tpu"),
])
def test_config_rejects_bad_values(bad):
    with pytest.raises(ValueError):
        TrainerConfig(**bad)
    if "device" not in bad:
        with pytest.raises(ValueError):
            jtraining.TrainerConfig(**bad)


def test_config_resume_requires_ckpt_dir():
    with pytest.raises(ValueError):
        TrainerConfig(resume=True)
    TrainerConfig(resume=True, ckpt_dir="/tmp/x")   # fine


def test_config_derived_geometry_and_fields():
    cfg = TrainerConfig(n_pods=2, data_shards=4, model_shards=2)
    assert (cfg.ring_size, cfg.n_devices, cfg.multi_pod) == (8, 16, True)
    assert cfg.replace(n_pods=1).n_devices == 8
    mine = {f.name for f in TrainerConfig.__dataclass_fields__.values()}
    ref = {f.name for f in jtraining.TrainerConfig.__dataclass_fields__.values()}
    assert mine == ref - {"kernel_mode"} | {"device"}


def test_config_from_peacock_lda():
    from repro.configs import peacock_lda as jpl

    cfg = TrainerConfig.from_peacock_lda(n_epochs=3, ckpt_dir="/tmp/ck", device="cpu")
    ref = jtraining.TrainerConfig.from_peacock_lda(n_epochs=3, ckpt_dir="/tmp/ck")
    assert cfg.n_topics == jpl.K_TOPICS and cfg.vocab_size == jpl.VOCAB
    assert cfg.ring_size == 256 and cfg.n_docs == 256 * jpl.DOCS_PER_SHARD
    assert cfg.agg_every == jpl.TRAIN_DEFAULTS["agg_every"] and cfg.n_epochs == 3
    for f in TrainerConfig.__dataclass_fields__:
        if f != "device":
            assert getattr(cfg, f) == getattr(ref, f), f


def test_single_pod_rejects_elastic_liveness():
    tr = _port_trainer([ttraining.ElasticLiveness(lambda ep: np.array([1]))])
    with pytest.raises(ValueError, match="ElasticLiveness"):
        tr.setup()


# ------------------------------ the trainer against JAX's -----------------

@pytest.mark.parametrize("sampler", ["dense", "alias"])
def test_trainer_fit_matches_jax(sampler):
    j = _jax_trainer([jtraining.AlphaOptimizer(), _metrics(jtraining)], sampler=sampler)
    t = _port_trainer([ttraining.AlphaOptimizer(), _metrics(ttraining)], sampler=sampler)
    jr, tr = j.fit(), t.fit()
    _same_state(tr.state, jr.state, sampler)
    np.testing.assert_array_equal(tr.alpha.numpy(), np.asarray(jr.alpha))
    assert (tr.epochs_run, tr.start_epoch, t.epoch) == (jr.epochs_run, jr.start_epoch, j.epoch)
    np.testing.assert_allclose(tr.metrics["ll"], jr.metrics["ll"], rtol=1e-5)
    assert tr.metrics["ll"][-1] > tr.metrics["ll"][0]
    np.testing.assert_array_equal(t.gather_phi().numpy(), j.gather_phi())
    assert t.ring_cfg.doc_topic_cap == j.ring_cfg.doc_topic_cap
    if sampler == "alias":
        # wq is bit for bit; the Walker tables' row sums run in another order
        # than XLA's, so their probabilities agree to rounding
        np.testing.assert_array_equal(t._tables.wq.numpy(), np.asarray(j._tables.wq))
        for a, b in ((t._tables.wp, j._tables.wp), (t._tables.ap, j._tables.ap)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)

    # the export: the same merge, the model to f32 rounding
    tm, tinfo = t.export_model()
    jm, jinfo = j.export_model()
    assert tinfo == jinfo
    np.testing.assert_allclose(tm.pvk.numpy(), np.asarray(jm.pvk), rtol=1e-6)
    np.testing.assert_array_equal(tm.r_topic.numpy(), np.asarray(jm.r_topic))
    rec = t.bench_record()
    assert rec["device"] == "cpu" and rec["epochs_timed"] == SESSION["n_epochs"]
    assert {k for k in rec} - {"device"} == set(j.bench_record())


def test_alpha_optimizer_step_matches_jax():
    j = _jax_trainer().setup()
    t = _port_trainer().setup()
    jomega, jhist = j.alpha_statistics()
    tomega, thist = t.alpha_statistics()
    np.testing.assert_array_equal(tomega.numpy(), np.asarray(jomega))
    np.testing.assert_array_equal(thist.numpy(), np.asarray(jhist))
    jtraining.AlphaOptimizer(from_epoch=0).on_epoch_end(j, 0)
    ttraining.AlphaOptimizer(from_epoch=0).on_epoch_end(t, 0)
    np.testing.assert_allclose(t.alpha.numpy(), np.asarray(j.alpha), rtol=1e-5)
    assert not np.allclose(np.asarray(j.alpha), 50.0 / 16)


# ------------------------------ checkpoints --------------------------------

@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("sampler", ["dense", "alias"])
def test_checkpoint_resumes_across_packages(tmp_path, writer, sampler):
    """A session killed after epoch 3 (checkpoint at epoch 2) by one package
    resumes in the other and lands on JAX's uninterrupted state."""
    ck = str(tmp_path / "ck")
    gold = _jax_trainer(sampler=sampler).fit()
    pkgs = {"jax": (jtraining, _jax_trainer), "port": (ttraining, _port_trainer)}
    (wpkg, wmake), (rpkg, rmake) = pkgs[writer], pkgs["port" if writer == "jax" else "jax"]
    with pytest.raises(SystemExit) as exc:
        wmake([wpkg.Checkpointing(every=2), wpkg.KillSwitch(3)], sampler=sampler,
              ckpt_dir=ck).fit()
    assert exc.value.code == 17
    r = rmake([rpkg.Checkpointing(every=2)], sampler=sampler, ckpt_dir=ck, resume=True)
    res = r.fit()
    assert res.start_epoch == 2 and r.epoch == SESSION["n_epochs"]
    _same_state(res.state, gold.state, f"{writer} → other, {sampler}")
    np.testing.assert_array_equal(np.asarray(res.alpha), np.asarray(gold.alpha))


@pytest.mark.parametrize("sampler", ["dense", "alias"])
def test_launch_train_kill_resume_publish(tmp_path, sampler):
    """``repro_torch.launch.train`` end to end on the CPU: an uninterrupted
    run, then a run killed at epoch 4 (exit 17) and resumed, with α
    re-estimated from epoch 3; the resumed state equals the uninterrupted
    one bit for bit, and the published snapshots load."""
    def argv(ck, extra=()):
        return ["--device", "cpu", "--docs", "240", "--vocab", "120", "--topics", "8",
                "--true-topics", "6", "--epochs", "6", "--alpha-opt-from", "3",
                "--sampler", sampler, "--ckpt-dir", ck, "--ckpt-every", "2",
                "--bench-out", ""] + list(extra)

    bench = str(tmp_path / "BENCH_train.json")
    gold = tlaunch.main(argv(str(tmp_path / "ck0"),
                             ["--publish-dir", str(tmp_path / "snap0"), "--bench-out", bench]))
    assert gold.epoch == 6
    rec = json.load(open(bench))
    assert rec["bench"] == "train" and rec["epochs_timed"] == 6 and rec["n_publishes"] == 6
    ck = str(tmp_path / "ck1")
    with pytest.raises(SystemExit) as exc:
        tlaunch.main(argv(ck, ["--kill-at", "4"]))
    assert exc.value.code == 17
    res = tlaunch.main(argv(ck, ["--resume", "--publish-dir", str(tmp_path / "snap1")]))
    assert res.epoch == 6
    for i, (a, b) in enumerate(zip(gold.state, res.state)):
        assert a.dtype == b.dtype and torch.equal(a, b), f"state leaf {i} diverged"
    assert torch.equal(gold.alpha, res.alpha)
    assert not torch.equal(gold.alpha, torch.full((8,), 50.0 / 8))   # α did move
    for snap in ("snap0", "snap1"):
        model, meta = snapshots.load_snapshot(str(tmp_path / snap), device="cpu")
        assert meta["epoch"] == 6 and model.pvk.shape == (120, 8)
        assert torch.isfinite(model.pvk).all()
    m0, _ = snapshots.load_snapshot(str(tmp_path / "snap0"), device="cpu")
    m1, _ = snapshots.load_snapshot(str(tmp_path / "snap1"), device="cpu")
    assert torch.equal(m0.pvk, m1.pvk) and torch.equal(m0.r_topic, m1.r_topic)


# ------------------------------ refusals ----------------------------------

@pytest.mark.parametrize("flags", [["--pods", "2"], ["--data-shards", "2"],
                                   ["--model-shards", "2"], ["--sharded-model"],
                                   ["--n-segments", "2"], ["--corpus-dir", "somewhere"],
                                   ["--preflight"], ["--prefetch"], ["--no-prefetch"],
                                   ["--ckpt-segments", "2"],
                                   ["--kill-at-segment", "1", "--kill-at", "3"]])
def test_launch_train_refuses_unported_flags(capsys, flags):
    with pytest.raises(SystemExit) as exc:
        tlaunch.main(["--device", "cpu", "--bench-out", ""] + flags)
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert "ROADMAP" in err
    assert flags[0] in err or flags[0].lstrip("-").replace("-", "_") in err


@pytest.mark.parametrize("bad", [dict(n_pods=2), dict(data_shards=2), dict(model_shards=2),
                                 dict(n_model_shards=2, model_shards=2),
                                 dict(n_segments=3), dict(corpus_dir="somewhere")])
def test_trainer_refuses_unported_sessions(bad):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        _port_trainer(**bad).setup()


def test_trainer_refuses_a_resharded_checkpoint():
    t = _port_trainer().setup()
    with pytest.raises(NotImplementedError, match="reshard"):
        t.load_checkpoint(t.checkpoint_like(), {"step": 2, "n_model_shards": 2})


def test_entry_points_refuse_to_run_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        ttraining.Trainer(TrainerConfig(**SESSION)).setup()
    with pytest.raises(RuntimeError, match="CUDA"):
        tlaunch.main(["--docs", "50", "--vocab", "40", "--topics", "4", "--epochs", "1",
                      "--bench-out", "", "--ckpt-dir", str(tmp_path / "ck")])
    t = _port_trainer(n_epochs=1)
    t.fit()
    snapshots.save_snapshot(str(tmp_path / "s"), 0, t.export_model()[0])
    with pytest.raises(RuntimeError, match="CUDA"):
        snapshots.load_snapshot(str(tmp_path / "s"))
