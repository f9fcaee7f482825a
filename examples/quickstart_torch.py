"""Quickstart on the PyTorch/CUDA port: train a small Peacock LDA model end to
end on one card, then serve topic features from it.

    PYTHONPATH=src python examples/quickstart_torch.py            # on the card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu

Twin of ``examples/quickstart.py``: a synthetic query corpus with known
topics, blocked collapsed Gibbs sampling (through the CUDA ``gibbs_argmax``
kernel on the card) with asymmetric-prior optimization, topic
de-duplication, the learned topics next to the generator's ground truth, and
RT-LDA features for a few queries. The initial z is a ``torch.Generator``
draw, so the numbers differ from the JAX quickstart's.
"""
import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import dedup, gibbs, lda, rtlda
from repro_torch.core.features import make_serving_fn
from repro_torch.data import corpus as corpus_mod, synthetic


def main(device="cuda"):
    dev = resolve_device(device)
    # --- data ---------------------------------------------------------------
    corpus, truth = synthetic.lda_corpus(
        seed=0, n_docs=1500, n_topics=12, vocab_size=400, doc_len_mean=9)
    print(f"corpus: {corpus.n_docs} docs, {corpus.n_tokens} tokens, "
          f"V={corpus.vocab_size}; device {dev}")

    K = 16
    wi, di = corpus_mod.pad_corpus(corpus.word_ids, corpus.doc_ids, 512)
    wi, di = torch.from_numpy(wi).to(dev), torch.from_numpy(di).to(dev)
    valid = wi >= 0

    # --- init + train -------------------------------------------------------
    state = lda.init_state(wi[valid], K, corpus.vocab_size, device=dev,
                           generator=torch.Generator().manual_seed(0))
    z = torch.zeros(wi.shape[0], dtype=torch.int32, device=dev)
    z[valid] = state.z
    state = lda.LDAState(state.phi, state.psi, z, state.alpha, state.beta)
    dl = dedup.doc_length_histogram(torch.from_numpy(corpus.doc_lengths()).to(dev))

    for it in range(40):
        state = gibbs.gibbs_epoch(state, wi, di, corpus.n_docs, corpus.vocab_size,
                                  seed=it * 31 + 7, block_size=512)
        if it >= 20:  # asymmetric prior optimization (paper §3.3)
            omega = dedup.topic_count_histogram(di, state.z, valid, corpus.n_docs, K)
            alpha = dedup.optimize_alpha(state.alpha, omega, dl, n_iters=5)
            state = lda.LDAState(state.phi, state.psi, state.z, alpha, state.beta)
        if (it + 1) % 10 == 0:
            ll = float(lda.word_log_likelihood(state.phi, state.psi, state.beta))
            print(f"iter {it+1:3d}  log-likelihood {ll:,.0f}")

    # --- de-duplicate -------------------------------------------------------
    frac = dedup.duplicate_fraction(state.phi, state.beta, 0.5)
    cl, ncl = dedup.cluster_topics(state.phi, state.beta, l1_threshold=0.3)
    print(f"duplicate fraction: {frac:.2f};  {K} topics → {ncl} after L1 merge")

    # --- show topics vs ground truth ----------------------------------------
    pvk = lda.phi_hat(state.phi, state.beta).cpu().numpy()    # [V, K]
    learned_top = np.argsort(-pvk, axis=0)[:6].T              # [K, 6]
    true_top = np.argsort(-truth.topic_word, axis=1)[:, :6]   # [K*, 6]
    print("\nlearned topics (top words)   | closest true topic")
    for k in np.argsort(-state.psi.cpu().numpy())[:8]:
        lw = set(int(x) for x in learned_top[k])
        overlaps = [(len(lw & set(int(x) for x in tt)), i)
                    for i, tt in enumerate(true_top)]
        ov, best = max(overlaps)
        print(f"  topic {k:2d}: {sorted(lw)} | true {best:2d} ({ov}/6 shared)")

    # --- serve: RT-LDA features for the first queries ------------------------
    model = rtlda.build_model(state.phi, state.beta, state.alpha, device=dev)
    q = np.full((4, 8), -1, np.int32)
    starts = np.concatenate([[0], np.cumsum(corpus.doc_lengths())])
    for i in range(4):
        toks = corpus.word_ids[starts[i]:starts[i + 1]][:8]
        q[i, :len(toks)] = toks
    pkd, ids, w = make_serving_fn(top_n=5, device=dev)(model, q, 0)
    print("\nserved features (query → top topic, top-5 words)")
    for i in range(4):
        print(f"  {q[i][q[i] >= 0].tolist()} → topic {int(pkd[i].argmax())}, "
              f"words {ids[i].tolist()}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    main(ap.parse_args().device)
