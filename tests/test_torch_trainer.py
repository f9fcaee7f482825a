"""The port's ``TrainerConfig``, ``Trainer`` and ``launch.train`` against the
JAX package's, on one device in-process.

The two trainers run the same session (synthetic corpus, shards, seeds) on
the CPU: the alias sampler must give the same state bit for bit, and so must
the dense one (a difference would be allowed only at a near-tie of the
Gumbel-max scores). α re-estimation goes through digamma sums, equal only to
rounding, so these sessions keep it past their last epoch and one
``AlphaOptimizer`` step is held separately at rtol 1e-5. Checkpoints written
by either trainer resume in the other. Streamed sessions (segments in memory
or on disk, prefetch on or off, a kill at a segment boundary) are held
against JAX's streamed sessions the same way.
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


# ------------------------------ streamed sessions -------------------------

STREAM = dict(n_docs=240, vocab_size=120, n_topics=12, true_topics=6, n_epochs=4,
              agg_every=2, alpha_opt_from=99, seed=3)
_GOLD = {}


def _stream_trainer(pkg, callbacks=(), **kw):
    cfg = {**STREAM, **kw}
    if pkg is ttraining:
        cfg.setdefault("device", "cpu")
    return _quiet(pkg.Trainer(pkg.TrainerConfig(**cfg), callbacks=list(callbacks)))


def _stream_gold(sampler, n_segments):
    """JAX's streamed session (in memory, prefetch on), run once per module."""
    key = (sampler, n_segments)
    if key not in _GOLD:
        j = _stream_trainer(jtraining, sampler=sampler, n_segments=n_segments)
        res = j.fit()
        _GOLD[key] = (j, res)
    return _GOLD[key]


def _same_stream(t, res, j, jres, label):
    for i, name in enumerate(("phi", "psi")):
        np.testing.assert_array_equal(np.asarray(res.state[i]), np.asarray(jres.state[i]),
                                      err_msg=f"{label}: {name}")
    np.testing.assert_array_equal(t._z, j._z, err_msg=f"{label}: global z")
    np.testing.assert_array_equal(np.asarray(res.alpha), np.asarray(jres.alpha),
                                  err_msg=f"{label}: alpha")


@pytest.mark.parametrize("prefetch", [True, False], ids=["prefetch", "no prefetch"])
@pytest.mark.parametrize("where", ["memory", "corpus_dir"])
@pytest.mark.parametrize("n_segments", [2, 3])
@pytest.mark.parametrize("sampler", ["dense", "alias"])
def test_streamed_trainer_matches_jax(tmp_path, sampler, n_segments, where, prefetch):
    """Φ, ψ, the global z store and α of the port's streamed session equal
    JAX's bit for bit, in memory or from a ``save_segments`` directory (the
    port's DiskSource, mmap'd), with prefetch on or off."""
    from repro_torch.data import sources as tsources

    j, jres = _stream_gold(sampler, n_segments)
    kw = dict(sampler=sampler, prefetch=prefetch)
    if where == "memory":
        t = _stream_trainer(ttraining, n_segments=n_segments, **kw)
    else:
        d = str(tmp_path / "segs")
        mem = _stream_trainer(ttraining, n_segments=n_segments, **kw).setup()
        tsources.save_segments(mem.source, d)
        t = _stream_trainer(ttraining, corpus_dir=d, **kw)
    res = t.fit()
    _same_stream(t, res, j, jres, f"{sampler}, {n_segments} segments, {where}")
    assert type(t.source).__name__ == ("DiskSource" if where == "corpus_dir"
                                       else "SyntheticSource")
    assert t.n_segments == n_segments and len(res.state) == 2
    assert (res.epochs_run, res.start_epoch, t.epoch, t.segment) == (
        jres.epochs_run, jres.start_epoch, j.epoch, j.segment)
    assert len(res.metrics["segment_s"]) == STREAM["n_epochs"] * n_segments
    assert len(res.metrics["load_wait_s"]) == STREAM["n_epochs"] * n_segments
    np.testing.assert_array_equal(t.gather_phi().numpy(), j.gather_phi())
    rec, jrec = t.bench_record(), j.bench_record()
    assert {k for k in rec} - {"device"} == set(jrec)
    assert rec["prefetch"] is prefetch and rec["n_segments"] == n_segments
    assert rec["segment_s_mean"] > 0 and rec["epochs_timed"] == STREAM["n_epochs"]
    if sampler == "alias":
        np.testing.assert_array_equal(t._tables.wq.numpy(), np.asarray(j._tables.wq))


def test_streamed_alpha_statistics_match_jax():
    """The Ω histogram folded at each segment's SaveShard equals JAX's fold
    bit for bit, and so does the full-scan fallback after the epoch; the α
    step taken from it agrees to rounding (digamma sums)."""
    def grab(omegas):
        def on_epoch_end(cb, trainer, epoch):
            if epoch == 2:
                omegas.append(np.asarray(trainer.alpha_statistics()[0]))
        return on_epoch_end

    got = {}
    for name, pkg in (("jax", jtraining), ("port", ttraining)):
        omegas = []
        cb = type("Grab", (pkg.TrainerCallback,), {"on_epoch_end": grab(omegas)})()
        tr = _stream_trainer(pkg, [cb, pkg.AlphaOptimizer(from_epoch=2)], n_epochs=3,
                             n_segments=3)
        tr.fit()
        assert len(tr._omega_parts) == 0                 # cleared after the epoch
        omegas.append(np.asarray(tr.alpha_statistics()[0]))   # the fallback scan
        got[name] = (omegas, tr)
    (jo, j), (to, t) = got["jax"], got["port"]
    for a, b in zip(to, jo):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(to[0], to[1])
    np.testing.assert_array_equal(t._z, j._z)
    np.testing.assert_allclose(t.alpha.numpy(), np.asarray(j.alpha), rtol=1e-5)


def test_one_mmapped_segment_equals_the_resident_path(tmp_path):
    """The streamed path at 1 segment (a DiskSource) equals the resident
    path: same Φ, ψ, α and per-token z."""
    from repro_torch.data import sources as tsources

    gold = _stream_trainer(ttraining, [ttraining.AlphaOptimizer()], alpha_opt_from=2)
    gold.fit()
    d = str(tmp_path / "one")
    tsources.save_segments(gold.source, d)
    one = _stream_trainer(ttraining, [ttraining.AlphaOptimizer()], alpha_opt_from=2,
                          corpus_dir=d)
    one.fit()
    assert one.n_segments == 1 and len(one.state) == 2 and len(gold.state) == 6
    assert torch.equal(gold.gather_phi(), one.gather_phi())
    assert torch.equal(gold.state[1], one.state[1]) and torch.equal(gold.alpha, one.alpha)
    sc = gold.sc0
    valid = np.asarray(sc.word_local) >= 0
    z_resident = np.zeros(gold.source.n_tokens, np.int32)
    z_resident[np.asarray(sc.uid)[valid]] = gold.state[5].numpy()[valid]
    np.testing.assert_array_equal(z_resident, one._z)


def test_resident_session_leaves_its_source_alone():
    """On the CPU the session's z stack is a copy of the source's z0: the
    epochs' in-place updates never reach the source, so a source saved after
    a fit still holds the initial assignment."""
    t = _stream_trainer(ttraining, n_epochs=2).setup()
    z0 = np.array(t.source.segment(0).z0)
    t.fit()
    np.testing.assert_array_equal(t.source.segment(0).z0, z0)
    assert not np.array_equal(t.state[5].numpy(), z0)


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("sampler", ["dense", "alias"])
def test_segment_kill_resume_crosses_packages(tmp_path, writer, sampler):
    """Killed after the first segment of the third epoch (a checkpoint at
    every segment boundary) by one package, resumed by the other: the resumed
    run lands on JAX's uninterrupted state bit for bit."""
    ck = str(tmp_path / "ck")
    j, gold = _stream_gold(sampler, 3)
    pkgs = {"jax": jtraining, "port": ttraining}
    wpkg, rpkg = pkgs[writer], pkgs["port" if writer == "jax" else "jax"]
    with pytest.raises(SystemExit) as exc:
        _stream_trainer(wpkg, [wpkg.Checkpointing(every_segments=1),
                               wpkg.KillSwitch(3, at_segment=1)],
                        sampler=sampler, n_segments=3, ckpt_dir=ck).fit()
    assert exc.value.code == 17
    logs = []
    r = _stream_trainer(rpkg, [rpkg.Checkpointing(every_segments=1)], sampler=sampler,
                        n_segments=3, ckpt_dir=ck, resume=True)
    r.log = logs.append
    res = r.fit()
    assert "[recovery] resumed from epoch 2 (+1 segments) (deterministic replay covers " \
           "the gap)" in logs
    assert res.start_epoch == 2 and r.epoch == STREAM["n_epochs"]
    _same_stream(r, res, j, gold, f"{writer} → other, {sampler}")


@pytest.mark.parametrize("n_segments,every_segments,ckpt_every",
                         [(2, 1, 99), (3, 2, 1), (3, 3, 99)])
def test_segment_checkpoint_steps_match_jax(tmp_path, n_segments, every_segments,
                                            ckpt_every):
    """``Checkpointing(every_segments=)`` saves at the global steps
    ``epoch * n_segments + segments_done`` the JAX package's does; a save
    due at the last segment lands at the epoch's end."""
    steps = {}
    for name, pkg in (("jax", jtraining), ("port", ttraining)):
        from importlib import import_module

        mgr = import_module(f"{pkg.__name__.split('.')[0]}.checkpoint.manager")
        ck = str(tmp_path / name)
        tr = _stream_trainer(pkg, [pkg.Checkpointing(every_segments=every_segments)],
                             n_epochs=2, n_segments=n_segments, ckpt_dir=ck,
                             ckpt_every=ckpt_every, ckpt_keep=99)
        tr.fit()
        steps[name] = mgr.CheckpointManager(ck, keep=99).steps()
    assert steps["port"] == steps["jax"]
    if (n_segments, every_segments, ckpt_every) == (2, 1, 99):
        assert steps["port"] == [1, 2, 3, 4]     # every boundary, none skipped


@pytest.mark.parametrize("case", ["boundaries on one pod", "segments, resident",
                                  "segments past the epoch", "kill segment, resident",
                                  "kill segment past the epoch"])
def test_segment_cadence_and_kill_refusals_match_jax(tmp_path, case):
    """A segment cadence or a segment kill that can never fire is refused at
    train start, in both packages, with the same message."""
    base = dict(n_docs=60, vocab_size=40, n_topics=4, true_topics=3, n_epochs=1,
                ckpt_dir=str(tmp_path))
    msgs = []
    for pkg in (jtraining, ttraining):
        cb, kw, match = {
            "boundaries on one pod": (pkg.Checkpointing(every_boundaries=1), {},
                                      "can never fire"),
            "segments, resident": (pkg.Checkpointing(every_segments=1), {},
                                   "can never fire"),
            "segments past the epoch": (pkg.Checkpointing(every_segments=3),
                                        dict(n_segments=2), "can never fire"),
            "kill segment, resident": (pkg.KillSwitch(1, at_segment=1), {},
                                       "streamed session"),
            "kill segment past the epoch": (pkg.KillSwitch(1, at_segment=5),
                                            dict(n_segments=2), "never fire"),
        }[case]
        cfg = {**base, **kw, **({"device": "cpu"} if pkg is ttraining else {})}
        tr = _quiet(pkg.Trainer(pkg.TrainerConfig(**cfg), callbacks=[cb]))
        with pytest.raises(ValueError, match=match) as exc:
            tr.fit()
        msgs.append(str(exc.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("sampler", ["dense", "alias"])
def test_launch_train_streams_kills_and_resumes(tmp_path, sampler):
    """``repro_torch.launch.train`` with the streamed flags on the CPU: a
    3-segment run equals JAX's driver with the same flags; the same corpus
    through ``--corpus-dir``, with ``--no-prefetch``, and killed at a segment
    boundary (``--ckpt-segments 1 --kill-at 3 --kill-at-segment 2``) then
    ``--resume``d, with α re-estimated from epoch 2, all land on one state
    bit for bit."""
    import contextlib
    import io

    from repro.launch import train as jlaunch
    from repro_torch.data import sources as tsources

    def argv(ck, extra=(), alpha_from="2", device=True):
        return (["--device", "cpu"] if device else []) + [
            "--docs", "200", "--vocab", "120", "--topics", "8", "--true-topics", "6",
            "--epochs", "4", "--alpha-opt-from", alpha_from, "--sampler", sampler,
            "--ckpt-dir", ck, "--ckpt-every", "2", "--bench-out", ""] + list(extra)

    def run(main, *a, **kw):
        with contextlib.redirect_stdout(io.StringIO()) as out:
            tr = main(argv(*a, **kw))
        return tr, out.getvalue()

    j, _ = run(jlaunch.main, str(tmp_path / "j"), ["--n-segments", "3"], alpha_from="99",
               device=False)
    t, _ = run(tlaunch.main, str(tmp_path / "t"), ["--n-segments", "3"], alpha_from="99")
    assert type(t.source).__name__ == "SyntheticSource" and t.source.n_segments == 3
    _same_stream(t, TrainResultView(t), j, TrainResultView(j), f"launch, {sampler}")

    gold, _ = run(tlaunch.main, str(tmp_path / "ck0"), ["--n-segments", "3"])
    assert not torch.equal(gold.alpha, torch.full((8,), 50.0 / 8))    # α did move
    d = str(tmp_path / "segs")
    tsources.save_segments(gold.source, d)
    runs = {"corpus_dir": run(tlaunch.main, str(tmp_path / "ck1"), ["--corpus-dir", d])[0],
            "no prefetch": run(tlaunch.main, str(tmp_path / "ck2"),
                               ["--corpus-dir", d, "--no-prefetch"])[0]}
    assert type(runs["corpus_dir"].source).__name__ == "DiskSource"
    assert runs["corpus_dir"].config.prefetch and not runs["no prefetch"].config.prefetch
    ck = str(tmp_path / "ck3")
    with pytest.raises(SystemExit) as exc:
        run(tlaunch.main, ck, ["--corpus-dir", d, "--ckpt-segments", "1", "--kill-at", "3",
                               "--kill-at-segment", "2"])
    assert exc.value.code == 17
    runs["resumed"], out = run(tlaunch.main, ck, ["--corpus-dir", d, "--resume"])
    assert "[recovery] resumed from epoch 2 (+2 segments)" in out
    for name, r in runs.items():
        for i in (0, 1):
            assert torch.equal(gold.state[i], r.state[i]), f"{name}: state leaf {i}"
        np.testing.assert_array_equal(gold._z, r._z, err_msg=name)
        assert torch.equal(gold.alpha, r.alpha), name


class TrainResultView:
    """The (state, alpha) of a trainer, shaped like a ``TrainResult``."""

    def __init__(self, trainer):
        self.state, self.alpha = trainer.state, trainer.alpha


# ------------------------------ refusals ----------------------------------

# the mesh flags train across ranks, streamed or not; what stays refused is a
# streamed corpus on several pods (as the JAX driver refuses it). --preflight
# is the launch gate: it exits 0 on the default session before any Trainer
# is built
@pytest.mark.parametrize("flags", [["--pods", "2", "--n-segments", "2"],
                                   ["--pods", "2", "--data-shards", "2", "--n-segments", "3"],
                                   ["--pods", "2", "--corpus-dir", "segments"],
                                   ["--pods", "2", "--sharded-model", "--model-shards", "2",
                                    "--n-segments", "2"],
                                   ["--preflight"]])
def test_launch_train_refuses_unported_flags(capsys, monkeypatch, flags):
    if flags[0] == "--preflight":
        def no_trainer(*a, **kw):
            raise AssertionError("the gate built a Trainer")
        monkeypatch.setattr("repro_torch.training.Trainer", no_trainer)
    with pytest.raises(SystemExit) as exc:
        tlaunch.main(["--device", "cpu", "--bench-out", ""] + flags)
    out, err = capsys.readouterr()
    if flags[0] == "--preflight":
        assert exc.value.code == 0, out
        assert "[preflight] OK" in out and "[export]" not in out
    else:
        assert exc.value.code == 2
        assert "segment streaming is single-configuration" in err


def test_launch_train_refuses_a_segment_kill_without_an_epoch(capsys):
    with pytest.raises(SystemExit) as exc:
        tlaunch.main(["--device", "cpu", "--bench-out", "", "--n-segments", "2",
                      "--kill-at-segment", "1"])
    assert exc.value.code == 2
    assert "--kill-at-segment requires --kill-at" in capsys.readouterr().err


# a streamed corpus on several pods is refused in both packages: by the
# config, and by setup when the streaming source is passed in
@pytest.mark.parametrize("bad", [dict(n_pods=2, n_segments=2),
                                 dict(n_pods=2, data_shards=2, n_segments=3),
                                 dict(n_pods=2, corpus_dir="segments"),
                                 dict(n_pods=2, source_segments=2)])
def test_trainer_refuses_unported_sessions(bad):
    from repro.data import sources as jsources
    from repro_torch.data import sources as tsources

    kw = dict(bad)
    n = kw.pop("source_segments", None)
    for pkg, src in ((jtraining, jsources), (ttraining, tsources)):
        extra = {} if pkg is jtraining else {"device": "cpu"}
        with pytest.raises(ValueError, match="segment streaming is single-configuration"):
            cfg = pkg.TrainerConfig(**{**SESSION, **extra, **kw})
            source = None
            if n:
                corpus = src.SyntheticSource(200, 100, 4, 6, gen_seed=0, n_segments=1,
                                             n_data_shards=1, n_vocab_shards=1,
                                             n_topics=16).corpus
                source = src.InMemorySource(corpus, n, 1, 1, 16, seed=1)
            _quiet(pkg.Trainer(cfg, source=source)).setup()


def test_trainer_refuses_a_resharded_checkpoint():
    """A checkpoint of another word-shard layout is resharded on load; one
    whose Φ rows do not split into the slices its meta records is refused."""
    t = _port_trainer().setup()
    tree = t.checkpoint_tree()
    phi = np.asarray(tree["state"][0])
    odd = {**tree, "state": (np.zeros((1, 7, phi.shape[2]), phi.dtype),) + tree["state"][1:]}
    with pytest.raises(ValueError, match="slice count"):
        t.load_checkpoint(odd, {"step": 2, "n_model_shards": 2})


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
