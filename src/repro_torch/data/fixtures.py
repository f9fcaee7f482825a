"""Quick synthetic train on the port's own modules (twin of ``repro.data.fixtures``).

Sits atop both ``repro_torch.data`` and ``repro_torch.core``: fixture plumbing
for examples and smoke runs, not part of either layer's API.
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.core import gibbs, lda
from repro_torch.data import corpus as corpus_mod, synthetic


def quick_train(topics: int, vocab: int, train_iters: int = 25,
                n_docs: int = 1500, gen_topics: int = 20,
                doc_len_mean: int = 9, *, seed: int = 0, device="cuda"):
    """Quick synthetic LDA train on ``device``. Returns ``(corpus, state)``;
    ``state.z`` covers the padded corpus (sentinels at the end, in topic 0).
    Feed ``state`` to ``rtlda.build_model`` for the serving model.

    The initial z comes from a ``torch.Generator`` seeded with ``seed``, so it
    differs from the JAX fixture's threefry draw.
    """
    dev = resolve_device(device)
    corpus, _ = synthetic.lda_corpus(seed=0, n_docs=n_docs, n_topics=gen_topics,
                                     vocab_size=vocab, doc_len_mean=doc_len_mean)
    wi, di = corpus_mod.pad_corpus(corpus.word_ids, corpus.doc_ids, 512)
    wi, di = torch.from_numpy(wi).to(dev), torch.from_numpy(di).to(dev)
    valid = wi >= 0
    state = lda.init_state(wi[valid], topics, vocab, device=dev,
                           generator=torch.Generator().manual_seed(seed))
    z = torch.zeros(wi.shape[0], dtype=torch.int32, device=dev)
    z[valid] = state.z
    state = lda.LDAState(state.phi, state.psi, z, state.alpha, state.beta)
    for it in range(train_iters):
        state = gibbs.gibbs_epoch(state, wi, di, corpus.n_docs, vocab,
                                  seed=it * 13 + 1, block_size=512)
    return corpus, state
