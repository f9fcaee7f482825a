"""Port conformance of the application layer: ``repro_torch.data.synthetic``'s
click log and relevance set, and ``repro_torch.benchmarks.bench_quality``
against the JAX bench ``benchmarks/bench_quality.py`` (Fig. 1, 7, 7b, 8 and
the sampler guardrail), at a small size.

The JAX bench draws z0 with threefry; the port takes it as ``z0=``, so from
the same z0 the dense and alias chains give JAX's z bit for bit. Once α
moves (the Minka step goes through digamma, rtol 1e-5 between the two
packages) z is held bit for bit up to the first update and by its topic
histogram after it. Fold-in P(k|d) and MAP agree to 1e-6, AUC rows to 1e-4,
the held-out LL to rtol 1e-5. Fig. 7b runs on a stopword corpus where the
reference's sentinel rollback fault shows (ROADMAP §3), so its rows are held
from one trained model.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_port import one_torch_thread as _one_torch_thread  # noqa: F401  (autouse)
from repro_torch.benchmarks import bench_quality as tbq
from repro_torch.data import synthetic as tsyn

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))     # the repo's benchmarks/
try:
    import jax
    import jax.numpy as jnp

    from benchmarks import bench_quality as jbq
    from repro.data import synthetic as jsyn
except ImportError:     # a CUDA machine without jax runs only the card case (`-m kernels`)
    jax = jnp = jbq = jsyn = None

pytestmark = pytest.mark.port

N_DOCS, TRUE_K, V = 300, 12, 200


def jax_z0(K, n, seed=0):
    """The z0 of the JAX bench's ``lda.init_state(jax.random.key(seed), ...)``."""
    return np.asarray(jax.random.randint(jax.random.key(seed), (n,), 0, K, dtype=jnp.int32))


@pytest.fixture(scope="module")
def corpora():
    args = dict(seed=0, n_docs=N_DOCS, n_topics=TRUE_K, vocab_size=V, doc_len_mean=8)
    return jsyn.lda_corpus(**args), tsyn.lda_corpus(**args)


@pytest.fixture(scope="module")
def trained(corpora):
    """Dense models at K = 4 and 8, α fixed, 6 sweeps, in both packages."""
    (jc, _), (tc, _) = corpora
    out = {}
    for K in (4, 8):
        js, *_ = jbq._train_model(K, jc, iters=6, alpha_opt_from=99)
        ts, *_ = tbq._train_model(K, tc, iters=6, alpha_opt_from=99,
                                  z0=jax_z0(K, jc.n_tokens), device="cpu")
        out[K] = js, ts
    return out


@pytest.mark.parametrize("seed,n_impr,signal", [(7, 2000, 3.0), (1, 500, 2.0)])
def test_click_log_bitwise(corpora, seed, n_impr, signal):
    (jc, jt), (tc, tt) = corpora
    j = jsyn.click_log(seed, jc, jt, n_impressions=n_impr, topic_signal=signal)
    t = tsyn.click_log(seed, tc, tt, n_impressions=n_impr, topic_signal=signal)
    assert sorted(t) == sorted(j)
    for key in j:
        np.testing.assert_array_equal(t[key], j[key], err_msg=key)
        assert np.asarray(t[key]).dtype == np.asarray(j[key]).dtype, key


@pytest.mark.parametrize("n_queries,n_urls", [(50, 40), (10, 12)])
def test_relevance_judgments_bitwise(corpora, n_queries, n_urls):
    (jc, jt), (tc, tt) = corpora
    j = jsyn.relevance_judgments(3, jc, jt, n_queries, n_urls)
    t = tsyn.relevance_judgments(3, tc, tt, n_queries, n_urls)
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


@pytest.mark.parametrize("K", [4, 8])
def test_train_model_bitwise(trained, K):
    js, ts = trained[K]
    for name in ("z", "phi", "psi", "alpha"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(), np.asarray(getattr(js, name)),
                                      err_msg=name)


def test_train_model_with_alpha_updates(corpora):
    """α re-estimated from sweep 2 on: z bit for bit through the last sweep
    before the first update, then α to rtol 1e-5 and z by its topic histogram."""
    (jc, _), (tc, _) = corpora
    K, z0 = 8, jax_z0(8, jc.n_tokens)
    js, *_ = jbq._train_model(K, jc, iters=3, alpha_opt_from=2)
    ts, *_ = tbq._train_model(K, tc, iters=3, alpha_opt_from=2, z0=z0, device="cpu")
    np.testing.assert_array_equal(ts.z.numpy(), np.asarray(js.z))
    np.testing.assert_allclose(ts.alpha.numpy(), np.asarray(js.alpha), rtol=1e-5)
    js, _, _, valid = jbq._train_model(K, jc, iters=6, alpha_opt_from=2)
    ts, *_ = tbq._train_model(K, tc, iters=6, alpha_opt_from=2, z0=z0, device="cpu")
    np.testing.assert_allclose(ts.alpha.numpy(), np.asarray(js.alpha), rtol=1e-5)
    assert not np.allclose(np.asarray(js.alpha), 50.0 / K)          # α did move
    hist = lambda z: np.bincount(np.asarray(z)[valid], minlength=K)
    np.testing.assert_allclose(hist(ts.z.numpy()), hist(js.z), atol=0.01 * valid.sum())


@pytest.mark.parametrize("K", [4, 8])
def test_infer_pkd_and_map(corpora, trained, K):
    (jc, jt), (tc, _) = corpora
    js, ts = trained[K]
    jp = jbq._infer_pkd(js, jc)
    tp = tbq._infer_pkd(ts, tc)
    assert tp.shape == (N_DOCS, K) and tp.dtype == torch.float32
    np.testing.assert_allclose(tp.numpy(), jp, atol=1e-6)
    q, u, lab = jsyn.relevance_judgments(3, jc, jt)
    m = tbq.mean_average_precision(tp, q, u, lab)
    assert abs(m - jbq.mean_average_precision(jp, q, u, lab)) < 1e-6
    assert tbq.mean_average_precision(tp.numpy(), q, u, lab) == m      # tensor or array
    assert jbq.mean_average_precision(tp.numpy(), q, u, lab) == m      # the same function


def test_fig7_map_and_fig1_pmi_rows(corpora):
    (jc, jt), (tc, tt) = corpora
    z0_of = lambda K: jax_z0(K, jc.n_tokens)
    j = jbq.fig7_map(jc, jt, ks=(4,))
    t = tbq.fig7_map(tc, tt, ks=(4,), device="cpu", z0_of=z0_of)
    assert [k for k, _ in t] == [k for k, _ in j]
    np.testing.assert_allclose([m for _, m in t], [m for _, m in j], atol=1e-6)
    j = jbq.fig1_pmi(jc, ks=(4,))
    t = tbq.fig1_pmi(tc, ks=(4,), device="cpu", z0_of=z0_of)
    assert t == j


def test_fig8_auc_rows(corpora):
    (jc, jt), (tc, tt) = corpora
    j = jbq.fig8_auc(jc, jt, ks=(4,), n_impr=2000)
    t = tbq.fig8_auc(tc, tt, ks=(4,), n_impr=2000, device="cpu",
                     z0_of=lambda K: jax_z0(K, jc.n_tokens))
    assert [n for n, _ in t] == [n for n, _ in j] == ["baseline", "oracle_true_topics", "K4"]
    np.testing.assert_allclose([v for _, v in t], [v for _, v in j], atol=1e-4)
    assert all(0.0 <= v <= 1.0 for _, v in t)


def test_fit_ctr_matches_jax_loop(corpora, trained):
    """Fig. 8's fit (50 steps here) on topic features, against the same loop
    written with JAX's ``l1_loglinear``: the weights to rtol 1e-5, atol 1e-6."""
    from repro.optim import l1_loglinear as jl1
    (jc, jt), _ = corpora
    js, ts = trained[8]
    log = tbq.ctr_log(jc, jt, n_impr=2000)
    dense = tbq.topic_features(tbq._infer_pkd(ts, jc), log)
    auc, st = tbq._fit_ctr(log, dense, steps=50)
    n_tr = 1600
    sp = jnp.array(log["ad_feat"][log["ad_idx"]][:n_tr])
    dx = jnp.array(dense.numpy()[:n_tr])
    lb = jnp.array(log["label"][:n_tr].astype(np.float32))
    jst = jl1.init_state(log["n_ad_features"], 8)
    for _ in range(50):
        jst, _ = jl1.train_step(jst, sp, dx, lb, 0.3, 1e-5)
    for a, b in zip(st, jst):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-6)
    assert 0.5 < auc <= 1.0


STOPWORDS = dict(seed=4, n_docs=250, n_topics=6, vocab_size=150, doc_len_mean=10,
                 stopword_frac=0.35)


def test_stopword_corpus_meets_the_reference_sentinel_fault():
    """On Fig. 7b's stopword corpus word 0 is the top stopword, so it and doc
    0 hold the padding's topic and JAX's ``gibbs_epoch`` rollback undoes
    nothing (ROADMAP §3): its Φ drifts from its z within one sweep. The
    port's Φ stays the counts of its z, so the two chains part here."""
    from repro.core import lda as jlda
    from repro_torch.core import lda as tlda
    jc, _ = jsyn.lda_corpus(**STOPWORDS)
    K = 12
    js, wi, _, valid = jbq._train_model(K, jc, iters=1)
    ts, *_ = tbq._train_model(K, jc, iters=1, z0=jax_z0(K, jc.n_tokens), device="cpu")
    phi, _ = jlda.build_counts(jnp.array(wi[valid]), js.z[jnp.array(valid)], K, jc.vocab_size)
    assert (np.asarray(phi) != np.asarray(js.phi)).any()
    tlda.check_invariants(tlda.LDAState(ts.phi, ts.psi, ts.z[torch.from_numpy(valid)],
                                        ts.alpha, ts.beta), torch.from_numpy(wi[valid]))


def test_fig7b_dedup_rows(monkeypatch):
    """Fig. 7b's dedup, merge and fold-in from one trained model: the port's
    model (20 sweeps on the stopword corpus), handed to both benches, since
    the reference's own training drifts there (the test above). The fold-in
    z are equal and P(k|d) within 3e-8, but here many URLs tie exactly
    with another (docs with equal topic rows), and numpy's unstable argsort
    orders a tie by the rest of the array: MAP rows agree to 1e-4, and the
    port's MAP equals JAX's function on the port's own P(k|d) exactly."""
    from repro.core import lda as jlda
    (jc, jt), (tc, tt) = jsyn.lda_corpus(**STOPWORDS), tsyn.lda_corpus(**STOPWORDS)
    K = 12
    ts, *rest = tbq._train_model(K, tc, iters=20, z0=jax_z0(K, tc.n_tokens), device="cpu")
    js = jlda.LDAState(*(jnp.array(getattr(ts, f).numpy())
                         for f in ("phi", "psi", "z", "alpha", "beta")))
    monkeypatch.setattr(jbq, "_train_model", lambda *a, **k: (js, *rest))
    monkeypatch.setattr(tbq, "_train_model", lambda *a, **k: (ts, *rest))
    j = jbq.fig7b_dedup(jc, jt, K=K, l1=(1.6, 1.2, 0.8))
    t = tbq.fig7b_dedup(tc, tt, K=K, l1=(1.6, 1.2, 0.8), device="cpu")
    assert [n for n, _ in t] == [n for n, _ in j]
    assert len({n.rsplit("_K", 1)[1] for n, _ in t[2:]}) > 1     # the merges differ
    assert t[0] == j[0]                                     # dup_fraction
    np.testing.assert_allclose([v for _, v in t[1:]], [v for _, v in j[1:]], atol=1e-4)
    q, u, lab = jsyn.relevance_judgments(3, jc, jt)
    pkd = tbq._infer_pkd(ts, tc).numpy()
    assert tbq.mean_average_precision(pkd, q, u, lab) == jbq.mean_average_precision(
        pkd, q, u, lab) == t[1][1]


@pytest.mark.parametrize("K,block_size", [(4, 512), (8, 256)])
def test_train_model_alias_bitwise(corpora, K, block_size):
    (jc, _), (tc, _) = corpora
    j = jbq._train_model_alias(K, jc, iters=4, block_size=block_size)
    t = tbq._train_model_alias(K, tc, iters=4, block_size=block_size,
                               z0=jax_z0(K, jc.n_tokens), device="cpu")
    for name in ("z", "phi", "psi"):
        np.testing.assert_array_equal(getattr(t, name).numpy(), np.asarray(getattr(j, name)),
                                      err_msg=name)


def test_heldout_ll_and_split(corpora, trained):
    (jc, _), (tc, _) = corpora
    js, ts = trained[8]
    tr, te = tbq.heldout_split(tc)
    assert (tr.n_docs, te.n_docs) == (240, 60)
    assert tr.n_tokens + te.n_tokens == tc.n_tokens and te.doc_ids.min() == 0
    np.testing.assert_allclose(tbq._heldout_ll(ts, te), jbq._heldout_ll(js, te), rtol=1e-5)


def test_default_z0_is_shared_and_device_free(corpora):
    """Without ``z0`` both chains draw one z0 from a seeded CPU generator."""
    _, (tc, _) = corpora
    d, *_ = tbq._train_model(6, tc, iters=0, seed=3, device="cpu")
    a = tbq._train_model_alias(6, tc, iters=0, seed=3, device="cpu")
    np.testing.assert_array_equal(d.z.numpy()[d.z.numpy() >= 0][:tc.n_tokens], a.z.numpy())
    with pytest.raises(ValueError, match="z0 has shape"):
        tbq._train_model(6, tc, iters=0, z0=np.zeros(3, np.int32), device="cpu")


def test_sampler_guardrail_passes_at_reduced_size():
    rows = dict(tbq.sampler_guardrail(K=8, n_docs=250, iters=8, device="cpu"))
    assert set(rows) == {"heldout_ll_dense", "heldout_ll_alias", "heldout_ll_gap"}
    assert rows["heldout_ll_dense"] < 0 and rows["heldout_ll_alias"] < 0
    assert rows["heldout_ll_gap"] == rows["heldout_ll_alias"] - rows["heldout_ll_dense"]


@pytest.mark.kernels
def test_sampler_guardrail_on_the_card():
    """JAX's own gate (K = 24, tol 2%, quick mode) with the port's chains
    through the CUDA kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rows = dict(tbq.sampler_guardrail(K=24, tol=0.02, quick=True, device="cuda"))
    assert rows["heldout_ll_alias"] >= rows["heldout_ll_dense"] * 1.02
