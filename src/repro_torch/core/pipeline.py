"""Communication pipeline (paper §3.1.2, Table 1), copied from
``repro.core.pipeline`` (pure Python).

In Peacock, data servers ship token *packages* of L bytes with T in flight
(L×T = c, the fixed communication buffer). In the port the same structure
appears twice:

  1. **Between rounds**: the next hop's ring shift is posted before the
     current round's sampling (``distributed.build_epoch_body``), the T≥2
     "keep the wire busy" half of the paper's pipeline.
  2. **Within a round**: the sub-block is sampled in packages of L tokens
     (``RingConfig.package_len``): small L keeps the live [L, K] planes
     small, large L amortizes the per-package launches. This is the L half.

``PipelineModel`` reproduces Table 1 analytically; its constants are
calibrated on the paper's own numbers, and the wall-clock package-length
sweep of ``repro_torch.benchmarks.bench_pipeline`` checks the curve's shape
on the card.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple


@dataclasses.dataclass(frozen=True)
class PipelineModel:
    """Throughput model for a fixed-buffer (L×T = c) RPC pipeline.

    time(L) = total / eff_bw(T) + n_packages · o,   T = c / L
      eff_bw(T) = bw · T / (T + knee)  — with few packages in flight the wire
                  idles between request/response turnarounds (large-L penalty);
      o          — fixed per-package dispatch+ack cost (small-L penalty).

    Constants are calibrated on the paper's own Table 1 (two-point fit:
    L=1KB → 48.1 min fixes o; L=200MB/T=1 → 49.8 min fixes knee; the 43.3 min
    floor fixes bw). The fit then *predicts* the five interior rows to within
    ≈0.5 min — see ``validate_against_paper`` / bench_pipeline.py.
    """

    total_bytes: float = 17.2e9          # SOSO corpus size (paper §4.1)
    buffer_bytes: float = 200e6          # c = 200 MB (paper §3.1.2)
    bandwidth: float = 6.62e6            # effective per-stream B/s (calibrated floor)
    overhead_s: float = 1.67e-5          # per-package fixed cost (calibrated @ L=1KB)
    knee: float = 0.15                   # in-flight count knee (calibrated @ T=1)

    def time_seconds(self, package_bytes: float) -> float:
        L = package_bytes
        T = max(self.buffer_bytes / L, 1.0)
        n = self.total_bytes / L
        eff_bw = self.bandwidth * T / (T + self.knee)
        return self.total_bytes / eff_bw + n * self.overhead_s

    def table(self, package_kb: List[float]) -> List[Tuple[float, float, float]]:
        """Rows of (T, L_kb, minutes) mirroring the paper's Table 1."""
        rows = []
        for lkb in package_kb:
            L = lkb * 1e3
            T = self.buffer_bytes / L
            rows.append((T, lkb, self.time_seconds(L) / 60.0))
        return rows


PAPER_TABLE_1 = {
    # L (KB) -> minutes, paper Table 1 (c = 200MB)
    1: 48.1, 10: 45.3, 100: 43.5, 1000: 43.3,
    5000: 43.4, 10000: 43.5, 20000: 44.1, 200000: 49.8,
}


def validate_against_paper(model: PipelineModel | None = None) -> Dict[float, Tuple[float, float]]:
    """Return {L_kb: (model_minutes, paper_minutes)} for the paper's grid."""
    model = model or PipelineModel()
    return {lkb: (model.time_seconds(lkb * 1e3) / 60.0, mins)
            for lkb, mins in PAPER_TABLE_1.items()}


def optimal_package(model: PipelineModel | None = None,
                    grid_kb: List[float] | None = None) -> float:
    model = model or PipelineModel()
    grid_kb = grid_kb or [1, 2, 5, 10, 20, 50, 100, 200, 500, 1000, 2000,
                          5000, 10000, 20000, 50000, 100000, 200000]
    return min(grid_kb, key=lambda lkb: model.time_seconds(lkb * 1e3))
