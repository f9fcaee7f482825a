"""``BatchingServer`` — the legacy sync facade over :class:`TopicEngine` (port
of ``repro.serving.server``).

Kept for backward compatibility: existing call sites construct it with
``(model, batch, query_len, ...)`` and call ``infer(list) -> list of dicts``.
Internally every request now routes through the engine's shape buckets, so
the old failure mode — requests longer than ``query_len`` silently losing
their tail — is gone: long queries go to a wider bucket, and only queries
exceeding the *largest* bucket are truncated, flagged via ``truncated`` in
the result dict (and on the underlying :class:`Response`).

New code should use :class:`repro_torch.serving.TopicEngine` directly (async
futures, deadlines, hot-swap, stats).
"""
from __future__ import annotations

from typing import List, Sequence

from repro_torch.core.rtlda import RTLDAModel
from repro_torch.serving.engine import TopicEngine

# how far the compatibility bucket ladder extends past query_len before
# truncation kicks in (query_len, 2q, 4q, 8q)
_LADDER = (1, 2, 4, 8)


class BatchingServer:
    def __init__(self, model: RTLDAModel, batch: int = 256,
                 query_len: int = 12, n_trials: int = 2, n_iters: int = 5,
                 top_n: int = 30):
        self.batch = batch
        self.query_len = query_len
        # engine in manual-pump mode: the sync path is deterministic (no
        # background timer can split a batch between two infer() calls)
        self.engine = TopicEngine(
            model,
            buckets=tuple(query_len * m for m in _LADDER),
            max_batch=batch, n_trials=n_trials, n_iters=n_iters, top_n=top_n,
            start=False)

    @property
    def model(self) -> RTLDAModel:
        return self.engine._model_ref[0]

    def infer(self, requests: Sequence) -> List[dict]:
        """Process all requests synchronously; returns result dicts in order
        (``pkd``, ``feature_ids``, ``feature_weights``, ``truncated``)."""
        return [r.as_dict() for r in self.engine.infer(requests)]
