"""Launch-gate preflight of the port: every contract check before the ranks
(the counterpart of ``repro.analysis.preflight``).

``python -m repro_torch.analysis.preflight`` (or ``launch/train.py
--preflight``, ``launch/serve.py --preflight``, ``launch/dryrun.py
--verify``) builds no ``Trainer``, allocates no training state on the card
and starts no session. Five passes:

  ``sharding``     §10 layout contract (analysis.shardcheck), read from the
                   collectives one ring epoch of the session issues
  ``smem``         sm_90 launch budgets (analysis.smem): the wrappers' launch
                   plans at the session's geometry, and on the card the
                   built kernels' registers, shared memory and spills
  ``determinism``  the bitwise kill→resume audit (analysis.determinism) over
                   one dense and one alias epoch
  ``concurrency``  §12 thread contracts (analysis.concurrency) over
                   ``src/repro_torch``: AST only, zero threads started
  ``lint``         the port's repo invariants (analysis.repolint)

JAX traces the epoch abstractly, at any K. The port has to execute it, so
the session's epochs run on D·P gloo ranks on the CPU with the kernels'
plain versions (``launch/mesh.py``), at the session's own M, P and sampler
on a corpus shrunk to at most :data:`SHRUNK` (JAX's ``SessionSpec``
defaults: 12 topics, 96 words, 120 docs); the rotation counts depend on M
and P alone. A ring of more than :data:`MAX_RANKS` ranks runs with fewer
data shards (the count is checked at the M that runs). What depends on the
full geometry is evaluated there without allocating: the §10 per-rank
bytes against the H100's 80 GB (``sharding.hbm``) and the launch plans
(``smem``). The report's
``session`` records the shrink. ``concurrency`` and ``lint`` need no
session, so ``--passes concurrency`` gates the serving layer in well under
a second.

Exit code 0 iff no pass produced an ``error`` finding; ``--json`` emits the
machine-readable report.
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import sys
import time
from typing import Any, Dict, List, Optional, Sequence

from repro_torch.analysis import repolint
from repro_torch.analysis.report import PassResult, PreflightReport, error, info

PASSES = ("sharding", "smem", "determinism", "concurrency", "lint")
# the most a session's epochs run at (JAX's SessionSpec defaults), and the
# most gloo CPU ranks they spawn (a larger ring runs with fewer data shards)
SHRUNK = dict(n_topics=12, vocab_size=96, n_docs=120)
MAX_RANKS = 16
HBM_BYTES = 80e9            # one H100
SAMPLERS = ("dense", "alias")
EPOCH_SEED = 3


@dataclasses.dataclass(frozen=True)
class SessionSpec:
    """The geometry preflight verifies (a TrainerConfig's static shadow;
    ``package_len`` 0: one package a sub-block, as the ``Trainer``)."""

    n_topics: int = 12
    vocab_size: int = 96
    data_shards: int = 2
    model_shards: int = 2      # P: word-sharded slices (1 = replicated ring)
    sampler: str = "alias"
    n_mh: int = 4
    n_docs: int = 120
    doc_len_mean: float = 7.0
    seed: int = 0
    package_len: int = 0

    @property
    def n_devices(self) -> int:
        return self.data_shards * max(1, self.model_shards)


def spec_from_trainer_config(cfg: Any) -> SessionSpec:
    """The preflight geometry of a :class:`TrainerConfig`: same corpus
    knobs, same mesh (one pod), same sampler family the session would run."""
    P = int(getattr(cfg, "n_model_shards", 1))
    return SessionSpec(
        n_topics=cfg.n_topics, vocab_size=cfg.vocab_size,
        data_shards=cfg.ring_size if P == 1 else cfg.data_shards,
        model_shards=P, sampler=cfg.sampler, n_mh=cfg.n_mh,
        n_docs=cfg.n_docs, doc_len_mean=float(cfg.doc_len_mean),
        seed=cfg.seed, package_len=int(getattr(cfg, "package_len", 0)))


def shrink(spec: SessionSpec) -> SessionSpec:
    """The geometry the session's epochs run at: K, V and the docs cut to at
    most :data:`SHRUNK`, the data shards to at most ``MAX_RANKS // P`` (the
    §10 count is linear in M, and checked at the M that runs), P, the
    sampler and the seed kept."""
    P = max(1, spec.model_shards)
    if P > MAX_RANKS:
        raise ValueError(f"model_shards={P}: more than the {MAX_RANKS} gloo ranks the gate "
                         "spawns on this host")
    return dataclasses.replace(spec, package_len=0,
                               data_shards=min(spec.data_shards, max(1, MAX_RANKS // P)),
                               **{k: min(getattr(spec, k), v) for k, v in SHRUNK.items()})


# ------------------------------------------------------------- the session --


@dataclasses.dataclass
class Session:
    """What the passes read: the verified spec, each sampler's ring, each
    rank's audited epochs by sampler, and the session's record (``meta``:
    the geometry the epochs ran at under ``run_at``)."""

    spec: SessionSpec
    ring_cfgs: Dict[str, Any]
    padded_tokens: int
    ranks: List[Dict[str, Any]]
    meta: Dict[str, Any]


def session_rank(layout, sc, cfgs: Dict[str, Any], seed: int) -> Dict[str, Any]:
    """One rank's epoch of each sampler in ``cfgs`` on the CPU, from its
    views of ``sc``, under ``determinism.audit``: the collective log, the
    determinism findings and the host reads, by sampler."""
    import torch

    from repro_torch.analysis import determinism
    from repro_torch.core import distributed as dist, sparse

    out = {}
    for sampler, cfg in cfgs.items():
        K = cfg.n_topics
        st = dist.rank_arrays([sc], K, layout, device="cpu")
        epoch = dist.build_epoch_body(cfg, layout)
        alpha, beta = torch.full((K,), 50.0 / K), torch.tensor(0.01)
        tabs = ()
        if sampler == "alias":
            tabs = (*sparse.make_word_tables(st[0], st[1], beta, cfg.vocab_size),
                    *sparse.make_alpha_table(alpha))
        findings, reads, cost, _ = determinism.audit(epoch, *st, alpha, beta, seed, *tabs)
        out[sampler] = {"log": cost.collective_log, "findings": findings, "host_reads": reads}
    return out


def build_session(spec: SessionSpec) -> Session:
    """Synthetic corpus → shard_corpus → one audited ring epoch of each
    sampler on D·P gloo ranks on the CPU, at ``shrink(spec)``."""
    from repro_torch.analysis import shardcheck
    from repro_torch.core import distributed as dist, sparse
    from repro_torch.data import corpus as corpus_mod, synthetic
    from repro_torch.launch import mesh

    run = shrink(spec)
    K, V = run.n_topics, run.vocab_size
    D, P = run.data_shards, max(1, run.model_shards)
    if spec.sampler not in SAMPLERS:
        raise ValueError(f"sampler must be one of {SAMPLERS}, got {spec.sampler!r}")
    corpus, _ = synthetic.lda_corpus(seed=run.seed, n_docs=run.n_docs,
                                     n_topics=max(2, min(K, 20)), vocab_size=V,
                                     doc_len_mean=run.doc_len_mean)
    sc = corpus_mod.shard_corpus(corpus, D, D, K, seed=run.seed + 1, n_model_shards=P)
    S, M, cap = sc.word_local.shape
    doc_cap = sparse.suggest_cap(corpus.doc_lengths(), K)
    cfgs = {s: dist.RingConfig(n_topics=K, vocab_size=corpus.vocab_size,
                               rows_per_shard=sc.rows_per_shard,
                               docs_per_shard=sc.docs_per_shard, cap=cap, package_len=cap,
                               n_rounds=M, sampler=s, n_mh=run.n_mh,
                               doc_topic_cap=doc_cap if s == "alias" else 0,
                               model_shards=P)
            for s in SAMPLERS}
    args = (sc, cfgs, EPOCH_SEED)
    if D * P == 1:
        ranks = [session_rank(mesh.init_ranks(device="cpu", rank=0, world_size=1), *args)]
    else:
        ranks = mesh.spawn(session_rank, data=D, model=P, device="cpu", backend="gloo",
                           args=args, threads=1, timeout_s=300)
    meta = {
        "n_topics": spec.n_topics, "vocab_size": spec.vocab_size, "n_docs": spec.n_docs,
        "data_shards": spec.data_shards, "model_shards": P, "sampler": spec.sampler,
        "n_mh": spec.n_mh, "ring_size": spec.data_shards, "ranks": D * P,
        "run_at": {"n_topics": K, "vocab_size": V, "n_docs": run.n_docs, "data_shards": D,
                   "rows_per_shard": sc.rows_per_shard, "docs_per_shard": sc.docs_per_shard,
                   "cap": cap, "doc_topic_cap": doc_cap, "padded_tokens": S * M * cap,
                   "n_tokens": int(corpus.n_tokens)},
        "shrunk": run != dataclasses.replace(spec, package_len=0),
        # each sampler's epoch, a rank: ppermutes and the stacked (doc, z)
        # all_gathers (the §10 rotation in the port's form, both families)
        "ppermutes": {s: [sum(1 for e in r[s]["log"] if e[0] == "ppermute") for r in ranks]
                      for s in SAMPLERS},
        "model_gathers": {s: [sum(1 for e in r[s]["log"] if shardcheck.is_model_gather(e, M))
                              for r in ranks] for s in SAMPLERS},
    }
    return Session(spec=spec, ring_cfgs=cfgs, padded_tokens=S * M * cap,
                   ranks=ranks, meta=meta)


def full_geometry(session: Session) -> Dict[str, Any]:
    """The verified spec's per-rank geometry: the session's own where its
    epochs ran unshrunk, else bounds from the spec (no corpus is made):
    tokens at the mean doc length, Θ's pair rows at their most (K slots),
    a package of a sub-block's expected tokens unless ``package_len`` is set."""
    spec, M, P = session.spec, session.meta["ring_size"], session.meta["model_shards"]
    if not session.meta["shrunk"]:
        r = session.meta["run_at"]
        return {"n_tokens": r["n_tokens"], "rows_per_device": r["rows_per_shard"] // P,
                "docs_per_shard": r["docs_per_shard"], "doc_topic_cap": r["doc_topic_cap"],
                "package_len": spec.package_len or r["cap"] // P, "from": "session"}
    n_tokens = spec.n_docs * spec.doc_len_mean
    return {"n_tokens": n_tokens, "rows_per_device": math.ceil(spec.vocab_size / (M * P)),
            "docs_per_shard": math.ceil(spec.n_docs / spec.data_shards),
            "doc_topic_cap": spec.n_topics,
            "package_len": spec.package_len or math.ceil(n_tokens / (M * spec.data_shards * P)),
            "from": "bounds from the spec"}


# ----------------------------------------------------------------- passes ---


def _hbm_finding(session: Session):
    """The §10 per-rank bytes at the full geometry against one H100."""
    from repro_torch.dist.analysis import model_shard_report

    spec, g = session.spec, full_geometry(session)
    M, P, K = session.meta["ring_size"], session.meta["model_shards"], spec.n_topics
    alias = spec.sampler == "alias"
    rep = model_shard_report(K, spec.vocab_size, M, P, g["n_tokens"], g["docs_per_shard"],
                             g["doc_topic_cap"] if alias else 0)
    # the alias family holds the word tables; the dense one a package's f32
    # φ, ψ and θ rows instead
    planes = 0.0 if alias else 3.0 * g["package_len"] * K * 4.0
    total = (rep["phi_bytes_per_device"] + rep["theta_bytes_per_device"]
             + rep["stack_bytes_per_device"]
             + (rep["tables_bytes_per_device"] if alias else planes))
    gb = lambda x: f"{x / 1e9:.3g}"                                   # noqa: E731
    msg = (f"per-rank device bytes at K={K}, V={spec.vocab_size}, {spec.n_docs} docs on "
           f"{M}x{P}: {gb(total)} GB (Φ {gb(rep['phi_bytes_per_device'])}, Θ "
           f"{gb(rep['theta_bytes_per_device'])}, stack {gb(rep['stack_bytes_per_device'])}, "
           + (f"alias tables {gb(rep['tables_bytes_per_device'])}" if alias
              else f"a package's f32 planes {gb(planes)}")
           + f" GB; {g['from']}) against the H100's {HBM_BYTES / 1e9:.0f} GB")
    data = dict(hbm_bytes_per_device=total, report=rep, geometry=g)
    if total > HBM_BYTES:
        return error("sharding.hbm", msg + ": the session runs out of device memory — "
                     "raise --model-shards (word-sharded, §10) or --data-shards",
                     location="model_shard_report", **data)
    return info("sharding.hbm", msg, location="model_shard_report", **data)


def run_sharding_pass(session: Session) -> PassResult:
    from repro_torch.analysis import shardcheck

    t0 = time.monotonic()
    cfg = session.ring_cfgs[session.spec.sampler]
    audit = shardcheck.check_epoch(
        [r[session.spec.sampler]["log"] for r in session.ranks],
        n_topics=cfg.n_topics, rows_per_shard=cfg.rows_per_shard, n_rounds=cfg.n_rounds,
        model_shards=cfg.model_shards, padded_tokens=session.padded_tokens)
    session.meta["sharding"] = audit.to_dict()
    return PassResult("sharding", audit.findings + [_hbm_finding(session)],
                      time.monotonic() - t0)


def run_smem_pass(session: Session) -> PassResult:
    from repro_torch.analysis import smem

    t0 = time.monotonic()
    spec, g = session.spec, full_geometry(session)
    plans = smem.repo_kernel_plans(
        n_topics=spec.n_topics, rows_per_device=g["rows_per_device"],
        docs_per_shard=g["docs_per_shard"], doc_topic_cap=g["doc_topic_cap"],
        package_len=g["package_len"], n_mh=spec.n_mh, sampler=spec.sampler)
    findings = smem.check_plans(plans)
    try:
        findings += smem.check_attributes(smem.card_attributes(), plans)
    except (RuntimeError, OSError) as e:          # no nvcc, a failed build or load
        findings.append(error("smem.attributes", f"the built kernels could not be read: {e}",
                              location="csrc"))
    return PassResult("smem", findings, time.monotonic() - t0)


def run_determinism_pass(session: Session) -> PassResult:
    from repro_torch.analysis import determinism

    t0 = time.monotonic()
    findings = []
    for sampler in SAMPLERS:
        seen, errs = set(), []
        for r in session.ranks:
            for f in r[sampler]["findings"]:
                if (f.check, f.location) not in seen:       # one a site, not one a rank
                    seen.add((f.check, f.location))
                    errs.append(f)
        reads = sum(r[sampler]["host_reads"] for r in session.ranks)
        findings += determinism.verdict(errs, reads, f"{sampler} epoch")
    return PassResult("determinism", findings, time.monotonic() - t0)


def run_lint_pass(root: Optional[str] = None) -> PassResult:
    t0 = time.monotonic()
    return PassResult("lint", repolint.lint_repo(root), time.monotonic() - t0)


def run_concurrency_pass(root: Optional[str] = None) -> PassResult:
    from repro_torch.analysis import concurrency

    t0 = time.monotonic()
    findings = concurrency.run(root, repolint.PORT)
    return PassResult("concurrency", findings, time.monotonic() - t0)


def run_preflight(spec: SessionSpec, passes: Sequence[str] = PASSES,
                  root: Optional[str] = None) -> PreflightReport:
    """Build the session (if a selected pass needs it) and run the passes."""
    report = PreflightReport()
    session: Optional[Session] = None
    if any(p in passes for p in ("sharding", "smem", "determinism")):
        t0 = time.monotonic()
        try:
            session = build_session(spec)
        except Exception as e:                 # noqa: BLE001 — the gate's verdict
            report.add(PassResult("session", [error(
                "session.build",
                f"the session failed to build: {e!r} — the geometry itself is invalid "
                "(this is the failure preflight exists to move to launch time)",
                location="build_session")], time.monotonic() - t0))
            report.session = dataclasses.asdict(spec)
            return report
        report.session = dict(session.meta, build_s=round(time.monotonic() - t0, 2))
    for name in passes:
        if name == "sharding" and session is not None:
            report.add(run_sharding_pass(session))
        elif name == "smem" and session is not None:
            report.add(run_smem_pass(session))
        elif name == "determinism" and session is not None:
            report.add(run_determinism_pass(session))
        elif name == "concurrency":
            report.add(run_concurrency_pass(root))
        elif name == "lint":
            report.add(run_lint_pass(root))
    if session is not None:
        report.session["sharding"] = session.meta.get("sharding", {})
    return report


def verify_trainer_config(cfg: Any, passes: Sequence[str] = PASSES) -> PreflightReport:
    """The ``launch/train.py --preflight`` entry: verify the session a
    TrainerConfig describes, without constructing a Trainer."""
    return run_preflight(spec_from_trainer_config(cfg), passes=passes)


# -------------------------------------------------------------------- CLI ---


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.preflight",
        description="static sharding/launch-budget/determinism/concurrency/lint contract "
                    "checks of the port (JAX's flags; its --no-compile is not taken: "
                    "nothing is compiled here, so there is no HLO to skip)")
    ap.add_argument("--topics", type=int, default=12)
    ap.add_argument("--vocab", type=int, default=96)
    ap.add_argument("--docs", type=int, default=120)
    ap.add_argument("--data-shards", type=int, default=2)
    ap.add_argument("--model-shards", type=int, default=2,
                    help="P: word-sharded model slices (1 = replicated)")
    ap.add_argument("--sampler", choices=SAMPLERS, default="alias")
    ap.add_argument("--n-mh", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--passes", default=",".join(PASSES),
                    help=f"comma-separated subset of {','.join(PASSES)}; `--passes "
                         "concurrency` runs only the §12 thread contracts (lock discipline "
                         "/ lock order / lifecycle / wait-notify): pure AST, no session, no "
                         "threads started, sub-second")
    ap.add_argument("--json", action="store_true", help="machine-readable report on stdout")
    return ap


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    passes = tuple(p.strip() for p in args.passes.split(",") if p.strip())
    unknown = [p for p in passes if p not in PASSES]
    if unknown:
        print(f"unknown pass(es): {', '.join(unknown)} (valid: {', '.join(PASSES)})",
              file=sys.stderr)
        return 2
    spec = SessionSpec(n_topics=args.topics, vocab_size=args.vocab, n_docs=args.docs,
                       data_shards=args.data_shards, model_shards=args.model_shards,
                       sampler=args.sampler, n_mh=args.n_mh, seed=args.seed)
    report = run_preflight(spec, passes=passes)
    print(report.to_json(indent=2) if args.json else report.render())
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())
