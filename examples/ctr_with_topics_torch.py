"""pCTR example on the PyTorch/CUDA port (paper §5.2, Fig. 8): the L1
log-linear CTR model with and without topic features.

    PYTHONPATH=src python examples/ctr_with_topics_torch.py            # on the card
    PYTHONPATH=src python examples/ctr_with_topics_torch.py --device cpu

Twin of ``examples/ctr_with_topics.py``: a synthetic ad click log whose true
CTR depends on (query topic × ad affinity). The baseline model sees only
sparse ad features; the Peacock variant appends P(k|d) inferred by the
trained LDA model (Gibbs sweeps and fold-in through the CUDA
``gibbs_argmax`` kernel on the card). The initial z is a ``torch.Generator``
draw, so the numbers differ from the JAX example's.
"""
import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import gibbs, lda
from repro_torch.data import corpus as corpus_mod, synthetic
from repro_torch.optim import l1_loglinear


def main(device="cuda"):
    dev = resolve_device(device)
    corpus, truth = synthetic.lda_corpus(seed=0, n_docs=1200, n_topics=16,
                                         vocab_size=400, doc_len_mean=8)
    log = synthetic.click_log(7, corpus, truth, n_impressions=8000)
    sparse = torch.from_numpy(log["ad_feat"][log["ad_idx"]].astype(np.int64)).to(dev)
    labels = log["label"].astype(np.float32)
    lb = torch.from_numpy(labels).to(dev)
    n = len(labels)
    tr, te = slice(0, n * 4 // 5), slice(n * 4 // 5, n)
    print(f"impressions: {n}, positive rate {labels.mean():.3f}; device {dev}")

    def train_ctr(dense, tag):
        st = l1_loglinear.init_state(log["n_ad_features"], dense.shape[1], device=dev)
        for i in range(200):
            st, loss = l1_loglinear.train_step(st, sparse[tr], dense[tr], lb[tr], 0.3, 1e-4)
        scores = l1_loglinear.predict(st, sparse[te], dense[te])
        auc = l1_loglinear.auc(scores, labels[te])
        nz = float((st.w_sparse.abs() > 1e-8).float().mean())
        print(f"  {tag:<28} AUC {auc:.4f}  (nonzero sparse weights {nz:.0%})")
        return auc

    print("baseline (ad features only):")
    base = train_ctr(torch.zeros((n, 1), device=dev), "baseline")

    wi, di = corpus_mod.pad_corpus(corpus.word_ids, corpus.doc_ids, 512)
    wi, di = torch.from_numpy(wi).to(dev), torch.from_numpy(di).to(dev)
    valid = wi >= 0
    for K in (4, 16, 32):
        state = lda.init_state(wi[valid], K, corpus.vocab_size, device=dev,
                               generator=torch.Generator().manual_seed(0))
        z = torch.zeros(wi.shape[0], dtype=torch.int32, device=dev)
        z[valid] = state.z
        state = lda.LDAState(state.phi, state.psi, z, state.alpha, state.beta)
        for it in range(25):
            state = gibbs.gibbs_epoch(state, wi, di, corpus.n_docs, corpus.vocab_size,
                                      seed=it * 17 + 3, block_size=512)
        z0 = torch.zeros((corpus.n_tokens,), dtype=torch.int32, device=dev)
        _, theta = gibbs.fold_in(state.phi, state.psi, state.alpha, state.beta,
                                 torch.from_numpy(corpus.word_ids).to(dev),
                                 torch.from_numpy(corpus.doc_ids).to(dev), z0, corpus.n_docs,
                                 corpus.vocab_size, seed=5, n_sweeps=8)
        pkd = lda.theta_hat(theta, state.alpha)
        dense = pkd[torch.from_numpy(log["doc_idx"].astype(np.int64)).to(dev)]
        auc = train_ctr(dense, f"+ topic features (K={K})")
        print(f"    → relative AUC lift vs baseline: "
              f"{100*(auc-base)/base:+.2f}% (paper Fig. 8 mechanism)")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    main(ap.parse_args().device)
