"""Typed findings + report aggregation for the ``repro_torch.analysis`` passes
(the port's own copy of ``repro.analysis.report``).

Every static check emits :class:`Finding` records instead of printing or
raising: a finding names the check that produced it (``"vmem.budget"``,
``"sharding.ppermute-count"`` ...), carries a severity, a human-actionable
message, and a machine-readable ``data`` dict (the JSON the CI ``--json``
mode serializes). A :class:`PassResult` groups one pass's findings;
:class:`PreflightReport` aggregates the passes and renders either the human
table or JSON. Only ``error`` findings fail a run — ``warning`` and ``info``
are advisory (the CLI exit code is the contract CI keys on).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional, Sequence

ERROR = "error"
WARNING = "warning"
INFO = "info"
_SEVERITIES = (ERROR, WARNING, INFO)


@dataclasses.dataclass(frozen=True)
class Finding:
    """One verdict from one static check."""

    check: str                     # dotted id, e.g. "vmem.budget"
    severity: str                  # error | warning | info
    message: str                   # one actionable sentence (+ optional table)
    location: str = ""             # file:line / kernel name / op path
    data: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self) -> None:
        if self.severity not in _SEVERITIES:
            raise ValueError(
                f"severity must be one of {_SEVERITIES}, got "
                f"{self.severity!r}")

    def to_dict(self) -> Dict[str, Any]:
        return {"check": self.check, "severity": self.severity,
                "message": self.message, "location": self.location,
                "data": self.data}


def error(check: str, message: str, location: str = "",
          **data: Any) -> Finding:
    return Finding(check, ERROR, message, location, data)


def warning(check: str, message: str, location: str = "",
            **data: Any) -> Finding:
    return Finding(check, WARNING, message, location, data)


def info(check: str, message: str, location: str = "",
         **data: Any) -> Finding:
    return Finding(check, INFO, message, location, data)


@dataclasses.dataclass
class PassResult:
    """One pass's findings (+ wall time, for the launch-gate budget)."""

    name: str
    findings: List[Finding] = dataclasses.field(default_factory=list)
    wall_s: float = 0.0

    @property
    def ok(self) -> bool:
        return not any(f.severity == ERROR for f in self.findings)

    @property
    def n_errors(self) -> int:
        return sum(1 for f in self.findings if f.severity == ERROR)

    def to_dict(self) -> Dict[str, Any]:
        return {"pass": self.name, "ok": self.ok,
                "n_errors": self.n_errors, "wall_s": round(self.wall_s, 2),
                "findings": [f.to_dict() for f in self.findings]}


@dataclasses.dataclass
class PreflightReport:
    """The aggregate verdict ``python -m repro_torch.analysis.preflight`` prints."""

    results: List[PassResult] = dataclasses.field(default_factory=list)
    session: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def ok(self) -> bool:
        return all(r.ok for r in self.results)

    def add(self, result: PassResult) -> None:
        self.results.append(result)

    def to_json(self, indent: Optional[int] = None) -> str:
        return json.dumps({
            "ok": self.ok,
            "session": self.session,
            "passes": [r.to_dict() for r in self.results],
        }, indent=indent)

    def render(self) -> str:
        """The human launch-gate summary: one line per pass, then findings."""
        lines: List[str] = []
        for r in self.results:
            mark = "PASS" if r.ok else "FAIL"
            extra = "" if r.ok else f"  ({r.n_errors} error(s))"
            lines.append(f"[preflight] {mark}  {r.name:<14}"
                         f" {r.wall_s:6.1f}s{extra}")
            for f in r.findings:
                loc = f" [{f.location}]" if f.location else ""
                lines.append(f"  {f.severity.upper():<7} {f.check}{loc}: "
                             f"{f.message}")
        verdict = "OK" if self.ok else "FAILED"
        lines.append(f"[preflight] {verdict}")
        return "\n".join(lines)


def merge_findings(*groups: Sequence[Finding]) -> List[Finding]:
    out: List[Finding] = []
    for g in groups:
        out.extend(g)
    return out
