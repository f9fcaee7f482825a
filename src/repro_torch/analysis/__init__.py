"""``repro_torch.analysis``: the port's launch gate (port of
``repro.analysis``, DESIGN.md §11–12).

Five passes over a session, run before any rank of it starts; no
``Trainer`` is built and no training state is allocated on the card:

* :mod:`repro_torch.analysis.shardcheck`: the §10 sharding contract
  (rotation ppermute counts, Φ-replication all_gathers, collective byte
  budgets), read from the collectives one epoch of the session issues on
  gloo ranks on the CPU;
* :mod:`repro_torch.analysis.smem`: sm_90 launch budgets: the wrappers'
  launch plans at the session's geometry, and on the card the built
  kernels' registers, shared memory, spills and blocks an SM (the
  counterpart of ``vmem``);
* :mod:`repro_torch.analysis.determinism`: the bitwise kill→resume audit
  (float accumulating scatters, torch RNG ops, device → host reads) over
  one dense and one alias epoch;
* :mod:`repro_torch.analysis.concurrency`: the §12 thread contracts over
  ``src/repro_torch`` (AST only);
* :mod:`repro_torch.analysis.repolint`: the port's AST invariants (kernel
  oracles and sources, frozen configs, one device probe, thread opt-in, no
  import of jax or repro).

Entry points: ``python -m repro_torch.analysis.preflight``,
``launch/train.py --preflight``, ``launch/serve.py --preflight``,
``launch/dryrun.py --verify``.

Only :mod:`.report` is imported eagerly.
"""
from repro_torch.analysis.report import (ERROR, INFO, WARNING, Finding, PassResult,
                                         PreflightReport, error, info, merge_findings,
                                         warning)

__all__ = [
    "ERROR", "INFO", "WARNING", "Finding", "PassResult", "PreflightReport",
    "error", "info", "merge_findings", "warning",
]
