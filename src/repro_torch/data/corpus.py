"""Corpus containers (host-side numpy), copied from ``repro.data.corpus``.

Only what the single-device slice needs: ``Corpus``, ``corpus_from_docs`` and
``pad_corpus``. The port keeps its own copy so that it never imports ``repro``
(whose ``data`` package loads jax).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np


@dataclasses.dataclass
class Corpus:
    """Token-level corpus. Tokens of one document are contiguous."""

    word_ids: np.ndarray   # [N] int32
    doc_ids: np.ndarray    # [N] int32, sorted ascending
    n_docs: int
    vocab_size: int

    @property
    def n_tokens(self) -> int:
        return int(self.word_ids.shape[0])

    def doc_lengths(self) -> np.ndarray:
        return np.bincount(self.doc_ids, minlength=self.n_docs)


def corpus_from_docs(docs: Sequence[np.ndarray], vocab_size: int) -> Corpus:
    word_ids = np.concatenate([np.asarray(d, np.int32) for d in docs]) if docs else np.zeros(0, np.int32)
    doc_ids = np.concatenate(
        [np.full(len(d), i, np.int32) for i, d in enumerate(docs)]
    ) if docs else np.zeros(0, np.int32)
    return Corpus(word_ids, doc_ids, len(docs), vocab_size)


def pad_corpus(word_ids: np.ndarray, doc_ids: np.ndarray, multiple: int):
    """Pad flat token arrays with word_id=-1 sentinels to a block multiple."""
    pad = (-len(word_ids)) % multiple
    return (
        np.pad(word_ids, (0, pad), constant_values=-1).astype(np.int32),
        np.pad(doc_ids, (0, pad), constant_values=0).astype(np.int32),
    )
