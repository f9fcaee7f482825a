"""Fig. 1 / Fig. 7 / Fig. 8 and the sampler guardrail: topic quality and
application utility against K (twin of ``benchmarks/bench_quality.py``).

    python -m repro_torch.benchmarks.bench_quality [--device cpu] [--quick]

Synthetic corpora with known generative topics stand in for SOSO:
  * Fig. 1: mean topic PMI against K;
  * Fig. 7: retrieval MAP of topic-feature cosine ranking against K, and the
    dedup effect (merging duplicate topics at a fixed K);
  * Fig. 8: pCTR AUC of the L1 log-linear model with and without topic
    features against K;
  * the guardrail: held-out log-likelihood of the alias-MH sampler against
    the dense one, with a hard tolerance.

The models train with the port's ``gibbs.gibbs_epoch`` (and
``sparse.sample_block_mh`` for the alias twin) on the card unless
``device="cpu"``. The initial z comes from ``z0=`` when it is given (the
tests pass the JAX package's threefry draw), else from a seeded CPU
``torch.Generator``, so a model on the card and on the CPU start from one z0.
``_infer_pkd`` returns P(k|d) as a tensor on the model's device.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import dedup, gibbs, lda, sparse
from repro_torch.data import corpus as corpus_mod, synthetic
from repro_torch.optim import l1_loglinear

TRUE_K = 48     # long-tail generator: many true topics ⇒ K must grow to cover
VOCAB = 800
CTR_LR, CTR_L1 = 0.3, 1e-5    # Fig. 8's proximal SGD step and L1 weight


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _initial_z(n: int, K: int, seed: int, z0, device) -> torch.Tensor:
    """z0 for the n real tokens: the given one, else a draw from a CPU
    generator seeded ``seed`` (the same on every device)."""
    if z0 is None:
        z0 = torch.randint(0, K, (n,), generator=torch.Generator().manual_seed(seed),
                           dtype=torch.int32)
    if not isinstance(z0, torch.Tensor):
        z0 = torch.from_numpy(np.array(z0, np.int32))
    if z0.shape != (n,):
        raise ValueError(f"z0 has shape {tuple(z0.shape)}, expected ({n},)")
    return z0.to(device)


def _train_model(K, corpus, iters=50, seed=0, alpha_opt_from=25, block_size=512, z0=None,
                 device="cuda"):
    """Dense blocked Gibbs for ``iters`` sweeps (seed it·11 + seed), with α
    re-estimated (3 Minka steps) after each sweep from ``alpha_opt_from`` on.
    Returns (state, wi, di, valid): the padded corpus as numpy."""
    dev = resolve_device(device)
    V = corpus.vocab_size
    wi, di = corpus_mod.pad_corpus(corpus.word_ids, corpus.doc_ids, block_size)
    valid = wi >= 0
    wi_t, di_t = torch.from_numpy(wi).to(dev), torch.from_numpy(di).to(dev)
    valid_t = wi_t >= 0
    state = lda.init_state(wi_t[valid_t], K, V, device=dev,
                           z0=_initial_z(int(valid.sum()), K, seed, z0, dev))
    z = torch.zeros(len(wi), dtype=torch.int32, device=dev)
    z[valid_t] = state.z
    state = lda.LDAState(state.phi, state.psi, z, state.alpha, state.beta)
    dl = dedup.doc_length_histogram(torch.from_numpy(corpus.doc_lengths()).to(dev))
    for it in range(iters):
        state = gibbs.gibbs_epoch(state, wi_t, di_t, corpus.n_docs, V, seed=it * 11 + seed,
                                  block_size=block_size)
        if it >= alpha_opt_from:   # asymmetric prior (paper §3.3)
            omega = dedup.topic_count_histogram(di_t, state.z, valid_t, corpus.n_docs, K)
            alpha = dedup.optimize_alpha(state.alpha, omega, dl, n_iters=3)
            state = lda.LDAState(state.phi, state.psi, state.z, alpha, state.beta)
    return state, wi, di, valid


def _infer_pkd(state, corpus):
    """Fold-in inferred P(k|d) [n_docs, K] f32 for all docs of a corpus, on
    the model's device. Its [T, K] planes cover the whole corpus at once."""
    dev = state.phi.device
    z0 = torch.zeros((corpus.n_tokens,), dtype=torch.int32, device=dev)
    z, theta = gibbs.fold_in(state.phi, state.psi, state.alpha, state.beta,
                             torch.from_numpy(corpus.word_ids).to(dev),
                             torch.from_numpy(corpus.doc_ids).to(dev), z0, corpus.n_docs,
                             state.vocab_size, seed=5, n_sweeps=15)
    return lda.theta_hat(theta, state.alpha)


def mean_average_precision(pkd, queries, urls, labels):
    """MAP of cosine ranking of each query's candidate URLs (host numpy).
    Only the rows of the queries and candidates leave ``pkd`` (a tensor or an
    array); each row is normalized on its own, as over the whole plane."""
    queries, urls = np.asarray(queries), np.asarray(urls)
    rows = np.unique(np.concatenate([queries.ravel(), urls.ravel()]))
    if isinstance(pkd, torch.Tensor):
        sub = pkd[torch.from_numpy(rows).to(pkd.device)].cpu().numpy()
    else:
        sub = np.asarray(pkd)[rows]
    dtn = sub / np.maximum(np.linalg.norm(sub, axis=1, keepdims=True), 1e-12)
    at = lambda ix: np.searchsorted(rows, ix)
    aps = []
    for qi, q in enumerate(queries):
        scores = dtn[at(urls[qi])] @ dtn[at(q)]
        order = np.argsort(-scores)
        rel = labels[qi][order]
        if rel.sum() == 0:
            continue
        prec = np.cumsum(rel) / np.arange(1, len(rel) + 1)
        aps.append((prec * rel).sum() / rel.sum())
    return float(np.mean(aps))


def _z0_for(z0_of, K):
    return None if z0_of is None else z0_of(K)


def fig1_pmi(corpus, ks=(4, 8, 16, 32, 64), device="cuda", z0_of=None):
    """``z0_of(K)``, when given, supplies each model's z0."""
    out = []
    for K in ks:
        state, *_ = _train_model(K, corpus, iters=20, z0=_z0_for(z0_of, K), device=device)
        pmi = lda.topic_pmi(state.phi, corpus.word_ids, corpus.doc_ids, corpus.n_docs,
                            top_n=5)
        out.append((K, float(pmi.mean())))
    return out


def fig7_map(corpus, truth, ks=(2, 4, 8, 16, 32, 64), device="cuda", z0_of=None):
    queries, urls, labels = synthetic.relevance_judgments(3, corpus, truth)
    out = []
    for K in ks:
        state, *_ = _train_model(K, corpus, iters=20, z0=_z0_for(z0_of, K), device=device)
        pkd = _infer_pkd(state, corpus)
        out.append((K, mean_average_precision(pkd, queries, urls, labels)))
    return out


def fig7b_dedup(corpus, truth, K=48, l1=(1.6, 1.2, 0.8), device="cuda", z0=None):
    """Start with too many topics (duplicates appear), prune by L1 clustering.

    Uses a stopword-heavy corpus (common words dominate topics [23]) trained
    with K ≫ true topics, which is where duplicates arise in practice. The
    O(K²V) distance is host numpy: this runs at small K only."""
    queries, urls, labels = synthetic.relevance_judgments(3, corpus, truth)
    state, *_ = _train_model(K, corpus, iters=20, z0=z0, device=device)
    rows = []
    rows.append(("dup_fraction", dedup.duplicate_fraction(state.phi, state.beta, 1.2)))
    pkd = _infer_pkd(state, corpus)
    rows.append(("map_no_dedup", mean_average_precision(pkd, queries, urls, labels)))
    for thr in l1:
        cl, ncl = dedup.cluster_topics(state.phi, state.beta, thr)
        phi_m, psi_m, alpha_m = dedup.merge_topics(state.phi, state.psi, state.alpha, cl, ncl)
        # remap z to merged clusters for fold-in consistency
        z_m = torch.from_numpy(cl).to(state.z.device)[state.z.long()]
        st = lda.LDAState(phi_m, psi_m, z_m, alpha_m, state.beta)
        pkd = _infer_pkd(st, corpus)
        rows.append((f"map_l1_{thr}_K{ncl}", mean_average_precision(pkd, queries, urls, labels)))
    return rows


def ctr_log(corpus, truth, n_impr=8000):
    """Fig. 8's click log: seed 7, topic signal 3.0."""
    return synthetic.click_log(7, corpus, truth, n_impressions=n_impr, topic_signal=3.0)


def _fit_ctr(log, dense, steps=400):
    """Train the pCTR model on the log's first 4/5 with the topic features
    ``dense`` [n_impr, F] (a tensor; the fit runs on its device), score the
    last 1/5. Returns (test AUC, state)."""
    dev = dense.device
    n = len(log["label"])
    tr, te = slice(0, n * 4 // 5), slice(n * 4 // 5, n)
    sp = torch.from_numpy(np.asarray(log["ad_feat"][log["ad_idx"]], np.int64)).to(dev)
    labels = log["label"].astype(np.float32)
    lb = torch.from_numpy(labels[tr]).to(dev)
    st = l1_loglinear.init_state(log["n_ad_features"], dense.shape[1], device=dev)
    sp_tr, dx_tr = sp[tr], dense[tr]
    # the step's f32 scalars made once, so no step waits on a host copy
    lr, l1 = (torch.tensor(x, dtype=torch.float32, device=dev) for x in (CTR_LR, CTR_L1))
    for _ in range(steps):
        st, _ = l1_loglinear.train_step(st, sp_tr, dx_tr, lb, lr, l1)
    scores = l1_loglinear.predict(st, sp[te], dense[te])
    return l1_loglinear.auc(scores, labels[te]), st


def topic_features(pkd, log):
    """P(k|d) of each impression's query, scaled ×K so feature magnitudes are
    O(1): the prox-SGD step is scale-sensitive (L1 thresholding)."""
    idx = torch.from_numpy(np.asarray(log["doc_idx"], np.int64)).to(pkd.device)
    return pkd[idx] * pkd.shape[1]


def oracle_features(log, truth, device):
    return torch.from_numpy((truth.doc_topic[log["doc_idx"]]
                             * truth.doc_topic.shape[1]).astype(np.float32)).to(device)


def fig8_auc(corpus, truth, ks=(2, 4, 8, 16, 32, 64), n_impr=8000, device="cuda",
             z0_of=None):
    dev = resolve_device(device)
    log = ctr_log(corpus, truth, n_impr)
    rows = [("baseline", _fit_ctr(log, torch.zeros((n_impr, 1), device=dev))[0])]
    rows.append(("oracle_true_topics", _fit_ctr(log, oracle_features(log, truth, dev))[0]))
    for K in ks:
        state, *_ = _train_model(K, corpus, iters=25, z0=_z0_for(z0_of, K), device=dev)
        pkd = _infer_pkd(state, corpus)                        # [D, K]
        rows.append((f"K{K}", _fit_ctr(log, topic_features(pkd, log))[0]))
    return rows


def _train_model_alias(K, corpus, iters=40, seed=0, n_mh=4, rebuild_every=3, block_size=512,
                       z0=None, device="cuda"):
    """Alias-MH twin of ``_train_model``: the same block schedule (counts
    refresh at block boundaries; full blocks and one remainder block, no
    padding) with ``sparse.sample_block_mh`` as the inner draw and the
    tables rebuilt every ``rebuild_every`` sweeps."""
    dev = resolve_device(device)
    V = corpus.vocab_size
    wi = torch.from_numpy(np.asarray(corpus.word_ids, np.int32)).to(dev)
    di = torch.from_numpy(np.asarray(corpus.doc_ids, np.int32)).to(dev)
    n = wi.shape[0]
    state = lda.init_state(wi, K, V, device=dev, z0=_initial_z(n, K, seed, z0, dev))
    phi, psi, z = state.phi, state.psi, state.z
    alpha, beta = state.alpha, state.beta
    cap = sparse.suggest_cap(corpus.doc_lengths(), K)
    tp, ct = sparse.pairs_from_assignments(di, z, torch.ones(n, dtype=torch.bool, device=dev),
                                           corpus.n_docs, cap)
    uid = torch.arange(n, dtype=torch.int64, device=dev)
    bounds = list(range(0, n, block_size))
    if bounds[-1] != n:
        bounds.append(n)
    tables = None
    for it in range(iters):
        if it % rebuild_every == 0:     # the aggregation-boundary cadence
            tables = None               # free the old tables first: at K = 10⁵
                                        # each set is 3 [V, K] planes
            tables = sparse.make_tables(phi, psi, alpha, beta, V)
        for lo, hi in zip(bounds[:-1], bounds[1:]):
            sl = slice(lo, hi)
            zb, phi, psi, tp, ct = sparse.sample_block_mh(
                phi, psi, tp, ct, z[sl], wi[sl], di[sl], uid[sl], alpha, beta,
                it * 11 + seed, V, tables, n_mh=n_mh)
            z[sl] = zb
    return lda.LDAState(phi, psi, z, alpha, beta)


def _heldout_ll(state, corpus_te):
    """Predictive held-out log-likelihood per token: fold-in θ̂ under frozen
    (Φ, Ψ) (the same ``_infer_pkd`` pass the figure benches use), then mean
    log Σ_k θ̂_dk φ̂_wk over the held-out tokens. φ̂ is gathered for the
    held-out tokens' rows only (never a [V, K] plane)."""
    V, dev = state.vocab_size, state.phi.device
    that = _infer_pkd(state, corpus_te)                          # [D, K]
    w = torch.from_numpy(np.asarray(corpus_te.word_ids)).to(dev).long()
    d = torch.from_numpy(np.asarray(corpus_te.doc_ids)).to(dev).long()
    phat = ((state.phi[w].to(torch.float32) + state.beta)
            / (state.psi.to(torch.float32)[None, :] + V * state.beta))      # [T, K]
    p_tok = (that[d] * phat).sum(dim=1)
    return float(torch.log(torch.clamp(p_tok, min=1e-30)).double().mean())


def heldout_split(corpus):
    """The guardrail's split: the first 4/5 of the docs train, the rest are
    held out (doc ids rebased to 0)."""
    split = (4 * corpus.n_docs) // 5
    wi, di = np.asarray(corpus.word_ids), np.asarray(corpus.doc_ids)
    tr = di < split
    corpus_tr = corpus_mod.Corpus(wi[tr], di[tr], split, corpus.vocab_size)
    corpus_te = corpus_mod.Corpus(wi[~tr], (di[~tr] - split).astype(np.int32),
                                  corpus.n_docs - split, corpus.vocab_size)
    return corpus_tr, corpus_te


def _quick(quick):
    return bool(os.environ.get("BENCH_QUICK")) if quick is None else bool(quick)


def sampler_guardrail(K=24, tol=0.02, quick=None, device="cuda", n_docs=None, iters=None):
    """Dense vs alias held-out log-likelihood at small scale: the quality
    gate that keeps sampler speedups honest. The alias path must stay within
    ``tol`` relative held-out LL of the exact dense sampler. ``quick`` (or
    ``BENCH_QUICK`` when it is None) trims the corpus and sweeps; ``n_docs``
    and ``iters`` trim them further; the tolerance stays hard. Both chains
    start from one z0."""
    quick = _quick(quick)
    iters = iters or (25 if quick else 40)
    corpus, _ = synthetic.lda_corpus(seed=2, n_docs=n_docs or (700 if quick else 1500),
                                     n_topics=16, vocab_size=400, doc_len_mean=12)
    corpus_tr, corpus_te = heldout_split(corpus)
    dense_state, *_ = _train_model(K, corpus_tr, iters=iters, alpha_opt_from=99,
                                   device=device)
    ll_dense = _heldout_ll(dense_state, corpus_te)
    del dense_state
    alias_state = _train_model_alias(K, corpus_tr, iters=iters, device=device)
    ll_alias = _heldout_ll(alias_state, corpus_te)
    # LLs are negative; alias may not be worse than dense by > tol relative
    if ll_alias < ll_dense - tol * abs(ll_dense):
        raise AssertionError(
            f"alias sampler regressed held-out quality: dense {ll_dense:.4f}"
            f" vs alias {ll_alias:.4f} (tol {tol:.0%})")
    return [("heldout_ll_dense", ll_dense), ("heldout_ll_alias", ll_alias),
            ("heldout_ll_gap", ll_alias - ll_dense)]


def card_name(dev: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them, or "cpu"."""
    if dev.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()


def run(quick=None, device="cuda", out="BENCH_quality_torch.json"):
    """Every figure at the JAX bench's sizes; returns the rows (name, µs,
    value) and writes them with the device to ``out`` (unless empty)."""
    dev = resolve_device(device)
    lines = []
    t0 = time.perf_counter()
    # clean long-tail corpus for the K-sweep figures
    corpus, truth = synthetic.lda_corpus(seed=0, n_docs=3000, n_topics=TRUE_K,
                                         vocab_size=VOCAB, doc_len_mean=10)
    for K, pmi in fig1_pmi(corpus, device=dev):
        lines.append((f"quality.fig1_pmi.K{K}", 0.0, round(pmi, 4)))
    for K, m in fig7_map(corpus, truth, device=dev):
        lines.append((f"quality.fig7_map.K{K}", 0.0, round(m, 4)))
    for name, v in fig8_auc(corpus, truth, device=dev):
        lines.append((f"quality.fig8_auc.{name}", 0.0, round(v, 4)))
    # stopword-heavy over-parameterized corpus for the duplicate-topic figure
    corpus_b, truth_b = synthetic.lda_corpus(seed=4, n_docs=2000, n_topics=16,
                                             vocab_size=500, doc_len_mean=10,
                                             stopword_frac=0.35)
    for name, v in fig7b_dedup(corpus_b, truth_b, device=dev):
        lines.append((f"quality.fig7b.{name}", 0.0, round(v, 4)))
    # LAST: the hard quality gate; a regression raises (the AssertionError
    # carries both LL numbers)
    for name, v in sampler_guardrail(quick=quick, device=dev):
        lines.append((f"quality.sampler.{name}", 0.0, round(v, 4)))
    _sync(dev)
    lines.append(("quality.total_wall_s", (time.perf_counter() - t0) * 1e6, ""))
    if out:
        with open(out, "w") as f:
            json.dump({"device": card_name(dev), "torch": torch.__version__,
                       "quick": _quick(quick),
                       "rows": [dict(name=n, us=us, value=v) for n, us, v in lines]}, f,
                      indent=1)
    return lines


def main(argv=None):
    ap = argparse.ArgumentParser(description="Fig. 1/7/8 and the sampler guardrail "
                                             "on the PyTorch/CUDA port")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--quick", action="store_true",
                    help="trim the guardrail's corpus and sweeps (as BENCH_QUICK)")
    ap.add_argument("--out", default="BENCH_quality_torch.json",
                    help="JSON file for the rows ('' for none)")
    args = ap.parse_args(argv)
    for name, us, derived in run(quick=args.quick or None, device=args.device, out=args.out):
        print(f"{name},{us:.1f},{derived}")


if __name__ == "__main__":
    main()
