"""Sharding contract checker: the declared §10 layout, verified against the
collectives the port really issues (the counterpart of
``repro.analysis.shardcheck``).

Word-sharded model parallelism (DESIGN.md §10) is a *contract*: Φ and the
alias tables live as resident V/(M·P) row slices, pre-bucketed token
sub-blocks rotate the data ring, and the only collectives an epoch may
issue are the rotation hops, the ψ resyncs and the epoch-end sums. JAX
traces the epoch abstractly and reads its jaxpr and compiled HLO; the port
has neither, so it runs one ring epoch of the session on D·P gloo ranks on
the CPU (the kernels' plain versions, ``launch/mesh.py``), each rank under
``dist.analysis.count_cost``, whose log holds every collective's JAX
primitive name, payload shape, dtype and bytes (``dist/collectives.py``).
Three checks, on every rank, against the analytics the repo already trusts
(``dist.analysis.model_shard_report``):

1. **Rotation count.** JAX's §10 formula is ``M·4 + M·(P−1)·2``
   ppermutes: M rounds × (3 stack planes + the z re-ship) data hops, plus
   M rounds × (P−1) model hops × 2 gathered planes (doc, z). The port
   ships the same planes in its own form (:func:`port_collectives`,
   ROADMAP §3): a round's model hops are one ``all_gather`` of the stacked
   (doc, z) planes, and a ring of one rank ships nothing. Both counts are
   held to that form on every rank; too few means the ring is not rotating
   (stale sub-blocks), too many duplicated traffic. A mismatch names the
   planes (shape, dtype) shipped.

2. **No Φ-shaped all_gather under P > 1.** An ``all_gather`` whose payload
   is a Φ/table row slice ([…, ≥ rows/P, K]) reassembles the model-sharded
   state: the accidental replication the layout exists to prevent.

3. **Collective bytes within budget.** Each rank's payload bytes by kind
   (ppermute and the stacked (doc, z) gathers → collective-permute,
   psum/pmax → all-reduce, other all_gathers → all-gather) stay within
   ``slack ×`` the rotation analytics at the *padded* token count (S·M·cap,
   the shapes actually shipped). The port ships uid as int64 (JAX:
   uint32), 20 B a token a hop against the analytics' 16, inside the 1.5
   slack.

The epoch runs at the session's own M, P and sampler; the corpus and K may
be shrunk (``analysis.preflight``), since the counts depend on M and P only.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Any, Dict, List, Sequence, Tuple

from repro_torch.analysis.report import Finding, error, info
from repro_torch.dist.analysis import model_shard_report

DEFAULT_SLACK = 1.5
# the port's collective kinds (JAX primitive names) → JAX's HLO budget keys
HLO_KIND = {"ppermute": "collective-permute", "psum": "all-reduce", "pmax": "all-reduce",
            "all_gather": "all-gather"}

LogEntry = Tuple[str, Tuple[int, ...], str, float]      # (kind, shape, dtype, bytes)


def expected_ppermutes(n_rounds: int, model_shards: int) -> int:
    """§10: M rounds × 4 data-hop planes + M × (P−1) model hops × 2 planes.
    P = 1 degenerates to the plain ring's M·4."""
    M, P = int(n_rounds), int(max(1, model_shards))
    return M * 4 + M * (P - 1) * 2


def port_collectives(n_rounds: int, model_shards: int) -> Dict[str, int]:
    """The §10 rotation as ``core/distributed.build_epoch_body`` issues it:
    ``ppermute`` M rounds × 4 planes where the ring has more than one rank
    (JAX's hops over an axis of one rank move nothing), and under P > 1
    ``model_gather`` one all_gather a round of the stacked [2, M, cap/P]
    (doc, z) planes, which carries JAX's (P−1) × 2 model ppermutes."""
    M, P = int(n_rounds), int(max(1, model_shards))
    return {"ppermute": M * 4 if M > 1 else 0, "model_gather": M if P > 1 else 0}


def is_model_gather(entry: LogEntry, n_rounds: int) -> bool:
    """An ``all_gather`` of the stacked (doc, z) bucket planes [2, M, capb]."""
    kind, shape, _, _ = entry
    return kind == "all_gather" and len(shape) == 3 and shape[:2] == (2, int(n_rounds))


def find_phi_allgathers(log: Sequence[LogEntry], n_topics: int, min_rows: int,
                        location: str = "epoch") -> List[Finding]:
    """Findings for every ``all_gather`` whose payload is Φ/table-shaped:
    trailing dim K and ≥ ``min_rows`` rows, i.e. a resident model slice
    being reassembled. Small gathers (scalars, [K] rows, token planes) are
    left alone."""
    findings: List[Finding] = []
    for kind, shape, dtype, _ in log:
        if kind == "all_gather" and len(shape) >= 2 and shape[-1] == n_topics \
                and shape[-2] >= min_rows:
            findings.append(error(
                "sharding.phi-all-gather",
                f"all_gather of a Φ/table-shaped payload {dtype}{list(shape)} under "
                "n_model_shards>1: this reassembles the resident model slice and brings "
                "back the replicated-Φ HBM ceiling (§10); index the local slice and "
                "rotate metadata instead (core/distributed.build_epoch_body)",
                location=location, shape=list(shape), dtype=dtype))
    return findings


def collective_budget(n_topics: int, vocab_rows: int, n_rounds: int, model_shards: int,
                      padded_tokens: int, slack: float = DEFAULT_SLACK) -> Dict[str, float]:
    """Per-epoch, per-rank collective byte ceilings from the §10 analytics,
    by JAX's HLO kind. all-gather's ceiling is one Φ slice: anything that
    big IS the replication the layout forbids (a threshold, not an
    allowance)."""
    rep = model_shard_report(n_topics, vocab_rows, n_rounds, model_shards, float(padded_tokens))
    permute = rep["rotation_data_bytes_per_epoch"] + rep["rotation_model_bytes_per_epoch"]
    return {"collective-permute": slack * permute,
            "all-reduce": slack * rep["rotation_psi_bytes_per_epoch"],
            "all-gather": rep["phi_bytes_per_device"],
            "all-to-all": rep["phi_bytes_per_device"]}


def _by_kind(log: Sequence[LogEntry], n_rounds: int) -> Dict[str, float]:
    """Bytes by HLO kind; the stacked (doc, z) gathers carry the rotation's
    model hops, so they are charged to collective-permute as JAX's are."""
    out: Dict[str, float] = collections.defaultdict(float)
    for entry in log:
        kind, _, _, nbytes = entry
        out["collective-permute" if is_model_gather(entry, n_rounds)
            else HLO_KIND.get(kind, kind)] += nbytes
    return dict(out)


def _planes(log: Sequence[LogEntry]) -> Dict[str, int]:
    """ppermutes by payload (``int32[2, 60]``) → count."""
    return dict(collections.Counter(f"{dtype}{list(shape)}" for kind, shape, dtype, _ in log
                                    if kind == "ppermute"))


@dataclasses.dataclass
class ShardingAudit:
    """Everything the pass measured (the --json payload)."""

    n_rounds: int
    model_shards: int
    ppermute_formula: int                        # JAX's §10 count
    ppermute_expected: int                       # the port's form of it
    ppermute_counted: List[int]                  # a rank
    model_gathers_expected: int
    model_gathers_counted: List[int]             # a rank
    collectives_counted: Dict[str, float]        # rank 0's, by JAX primitive
    planes: Dict[str, int]                       # rank 0's ppermutes by payload
    budget_bytes: Dict[str, float]
    bytes_by_kind: List[Dict[str, float]]        # a rank, by HLO kind
    findings: List[Finding]

    def to_dict(self) -> Dict[str, Any]:
        return {"n_rounds": self.n_rounds, "model_shards": self.model_shards,
                "ppermute_formula": self.ppermute_formula,
                "ppermute_expected": self.ppermute_expected,
                "ppermute_counted": list(self.ppermute_counted),
                "model_gathers_expected": self.model_gathers_expected,
                "model_gathers_counted": list(self.model_gathers_counted),
                "collectives_counted": dict(self.collectives_counted),
                "planes": dict(self.planes),
                "budget_bytes": {k: float(v) for k, v in self.budget_bytes.items()},
                "bytes_by_kind": [dict(b) for b in self.bytes_by_kind]}


def check_epoch(logs: Sequence[Sequence[LogEntry]], *, n_topics: int, rows_per_shard: int,
                n_rounds: int, model_shards: int, padded_tokens: int,
                slack: float = DEFAULT_SLACK) -> ShardingAudit:
    """Audit one epoch's collectives, ``logs`` holding each rank's
    ``Cost.collective_log``, against the §10 contract."""
    M, P = int(n_rounds), int(max(1, model_shards))
    findings: List[Finding] = []

    # 1. rotation count -----------------------------------------------------
    formula, port = expected_ppermutes(M, P), port_collectives(M, P)
    expect, expect_g = port["ppermute"], port["model_gather"]
    counted = [sum(1 for e in log if e[0] == "ppermute") for log in logs]
    gathers = [sum(1 for e in log if is_model_gather(e, M)) for log in logs]
    form = (f"JAX's §10 M·4 + M·(P−1)·2 = {formula} ppermutes (M={M}, P={P}) in the port's "
            f"form: {expect} ppermutes and {expect_g} all_gathers of the stacked (doc, z) "
            "planes (ROADMAP §3)")
    bad = [(r, n, g) for r, (n, g) in enumerate(zip(counted, gathers))
           if (n, g) != (expect, expect_g)]
    if bad:
        r, got, got_g = bad[0]
        findings.append(error(
            "sharding.ppermute-count",
            f"rank {r}'s epoch issues {got} ppermutes and {got_g} model all_gathers, the "
            f"contract requires {form}; planes shipped {_planes(logs[r])} — "
            + ("the ring is under-rotating; stale sub-blocks break the per-diagonal "
               "serialization" if (got, got_g) < (expect, expect_g) else
               "duplicated rotation traffic; a stack plane is shipped more than once a hop"),
            location="epoch", expected=expect, counted=counted, formula=formula,
            model_gathers_expected=expect_g, model_gathers=gathers))
    else:
        findings.append(info(
            "sharding.ppermute-count",
            f"rotation schedule verified on {len(logs)} rank(s): {form}",
            location="epoch", expected=expect, counted=counted, formula=formula,
            model_gathers_expected=expect_g, model_gathers=gathers))

    # 2. Φ replication ------------------------------------------------------
    if P > 1:
        min_rows = max(1, rows_per_shard // P)
        phi_ag = [f for r, log in enumerate(logs)
                  for f in find_phi_allgathers(log, n_topics, min_rows, f"rank {r}")]
        findings.extend(phi_ag)
        if not phi_ag:
            findings.append(info("sharding.phi-all-gather",
                                 "no Φ/table-shaped all_gather in the epoch: resident slices "
                                 "stay resident", location="epoch"))

    # 3. byte budget --------------------------------------------------------
    budget = collective_budget(n_topics, M * rows_per_shard, M, P, padded_tokens, slack=slack)
    by_kind = [_by_kind(log, M) for log in logs]
    over = [(r, op, got, budget[op]) for r, b in enumerate(by_kind)
            for op, got in sorted(b.items()) if op in budget and got > budget[op]]
    for r, op, got, limit in over:
        findings.append(error(
            "sharding.collective-bytes",
            f"rank {r} moves {got:,.0f} B/epoch of {op}, over the declared budget "
            f"{limit:,.0f} B (analytics × slack {slack}): the layout leaks traffic the §10 "
            "accounting does not predict; compare the collective log with "
            "launch/dryrun.py --json", location=op, op=op, bytes=got, budget=float(limit)))
    if not over:
        findings.append(info(
            "sharding.collective-bytes",
            "collective traffic within the §10 budget on every rank: "
            + ", ".join(f"{op}={by_kind[0].get(op, 0):,.0f}B/{budget[op]:,.0f}B"
                        for op in sorted(budget) if by_kind and by_kind[0].get(op)),
            location="epoch"))

    log0 = logs[0] if logs else []
    coll0: Dict[str, float] = collections.defaultdict(float)
    for kind, *_ in log0:
        coll0[kind] += 1
    return ShardingAudit(n_rounds=M, model_shards=P, ppermute_formula=formula,
                         ppermute_expected=expect, ppermute_counted=counted,
                         model_gathers_expected=expect_g, model_gathers_counted=gathers,
                         collectives_counted=dict(coll0),
                         planes=_planes(log0), budget_bytes=budget, bytes_by_kind=by_kind,
                         findings=findings)
