"""The port's alias-MH slice against the JAX package on one device:
sharded corpus → ring epochs with the table-rebuild cadence → α
re-estimation → RT-LDA model → served features, on the same inputs.

The JAX side is ``distributed.make_ring_epoch`` on a 1×1 mesh with the plain
alias ops (``force``-free on the CPU, so ``ref``); the port runs
``repro_torch.core.distributed.build_epoch_body``. The alias tables are
built by JAX and carried across, so both sample against the same proposals:
z, Φ and Ψ must then be equal bit for bit after every epoch.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import one_torch_thread as _one_torch_thread  # noqa: F401  (autouse)
from repro.core import dedup as jdedup, distributed as jdist, features as jfeatures
from repro.core import lda as jlda, rtlda as jrtlda, sparse as jsparse
from repro.data import corpus as jcorpus, synthetic as jsynthetic
from repro_torch import convert
from repro_torch.core import dedup as tdedup, distributed as tdist, features as tfeatures
from repro_torch.core import lda as tlda, rtlda as trtlda, sparse as tsparse
from repro_torch.data import corpus as tcorpus

pytestmark = pytest.mark.port

V, K = 300, 32           # Σα = 32 · (50/32) is exact in any order
EPOCHS, AGG_EVERY = 6, 3


@pytest.fixture(scope="module")
def corpus():
    c, _ = jsynthetic.lda_corpus(seed=0, n_docs=400, n_topics=12, vocab_size=V,
                                 doc_len_mean=6)
    return c


@pytest.mark.parametrize("S,M", [(1, 1), (4, 2)])
def test_shard_corpus_is_the_same(corpus, S, M):
    tc = tcorpus.corpus_from_docs(
        np.split(corpus.word_ids, np.cumsum(corpus.doc_lengths())[:-1]), V)
    a = jcorpus.shard_corpus(corpus, S, M, K, seed=1)
    b = tcorpus.shard_corpus(tc, S, M, K, seed=1)
    for f in ("word_local", "doc_local", "uid", "z0", "shard_of_word", "local_of_word"):
        np.testing.assert_array_equal(getattr(b, f), getattr(a, f), err_msg=f)
        assert getattr(b, f).dtype == getattr(a, f).dtype
    for f in ("rows_per_shard", "docs_per_shard", "n_real_tokens"):
        assert getattr(b, f) == getattr(a, f)
    jphi, jpsi = jdist.host_counts(a, K)
    tphi, tpsi = tdist.host_counts(b, K)
    np.testing.assert_array_equal(tphi, jphi)
    np.testing.assert_array_equal(tpsi, jpsi)


def _ring(corpus, package_div):
    sc = jcorpus.shard_corpus(corpus, 1, 1, K, seed=1)
    cap = sc.word_local.shape[2]
    kw = dict(n_topics=K, vocab_size=V, rows_per_shard=sc.rows_per_shard,
              docs_per_shard=sc.docs_per_shard, cap=cap, package_len=cap // package_div,
              n_rounds=1, sampler="alias", n_mh=4,
              doc_topic_cap=jsparse.suggest_cap(corpus.doc_lengths(), K))
    return sc, kw


def _run_both(corpus, package_div, epochs=EPOCHS):
    """The same epochs on both sides; yields after each (j_state, t_state)."""
    sc, kw = _ring(corpus, package_div)
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    jepoch = jdist.make_ring_epoch(mesh, jdist.RingConfig(**kw))
    tepoch = tdist.build_epoch_body(tdist.RingConfig(**kw))
    js = jdist.device_arrays(sc, K)
    ts = convert.ring_state_from_numpy(*(np.asarray(x) for x in js), "cpu")
    alpha = np.full(K, 50.0 / K, np.float32)
    ja, ta = jnp.asarray(alpha), torch.from_numpy(alpha)
    for ep in range(epochs):
        if ep % AGG_EVERY == 0:          # the aggregation-boundary rebuild
            jtabs = jsparse.make_tables(js[0], js[1], ja, jnp.float32(0.01), V)
            ttabs = convert.alias_tables_from_numpy(*(np.asarray(x) for x in jtabs), "cpu")
        js = jepoch(*js, ja, jnp.float32(0.01), jnp.uint32(ep * 977 + 3), *jtabs)
        ts = tepoch(*ts, ta, torch.tensor(0.01), ep * 977 + 3, *ttabs)
        yield sc, js, ts


@pytest.mark.parametrize("package_div", [1, 2], ids=["L=cap", "L=cap/2"])
def test_alias_ring_epochs_match_jax(corpus, package_div):
    for sc, js, ts in _run_both(corpus, package_div):
        for name, i in (("phi", 0), ("psi", 1), ("z", 5)):
            np.testing.assert_array_equal(ts[i].numpy(), np.asarray(js[i]), err_msg=name)
    phi, psi, wl, dl, uid, z = ts
    valid = wl >= 0
    assert int(psi.sum()) == corpus.n_tokens
    rebuilt, _ = tlda.build_counts(wl[valid], z[valid], K, sc.rows_per_shard)
    assert torch.equal(rebuilt, phi[0])
    assert torch.equal(phi.sum(dim=(0, 1)), psi)
    full = tdist.gather_phi(phi, sc)
    np.testing.assert_array_equal(full.numpy(), jdist.gather_phi(np.asarray(phi), sc, K))


def test_device_arrays_match_jax(corpus):
    sc, _ = _ring(corpus, 1)
    for a, b in zip(tdist.device_arrays(sc, K, device="cpu"), jdist.device_arrays(sc, K)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b).astype(a.numpy().dtype))


def test_epoch_builder_refuses_what_is_not_ported(corpus):
    _, kw = _ring(corpus, 1)
    # a ring of several ranks, or model slices, need the rank's RankLayout
    for bad in (dict(n_rounds=2), dict(model_shards=2)):
        with pytest.raises(ValueError, match="RankLayout"):
            tdist.build_epoch_body(tdist.RingConfig(**{**kw, **bad}))


def test_alias_train_export_serve_matches_jax(corpus):
    *_, (sc, js, ts) = _run_both(corpus, 1)
    jphi, jpsi, jwl, jdl, _, jz = js
    phi, psi, wl, dl, _, z = ts
    valid = wl.reshape(-1) >= 0
    D = sc.docs_per_shard
    ll = tlda.word_log_likelihood(tdist.gather_phi(phi, sc), psi, torch.tensor(0.01))
    jll = jlda.word_log_likelihood(jnp.asarray(jdist.gather_phi(jphi, sc, K)), jpsi,
                                   jnp.float32(0.01))
    np.testing.assert_allclose(float(ll), float(jll), rtol=1e-5)

    # --- α re-estimation: Ω from the pairs, equal to JAX's dense histogram ---
    cap_p = tsparse.suggest_cap(corpus.doc_lengths(), K)
    tp, ct = tsparse.pairs_from_assignments(dl.reshape(-1), z.reshape(-1), valid, D, cap_p)
    tomega = tsparse.pairs_topic_histogram(tp, ct, K)
    jomega = jdedup.topic_count_histogram(jdl.reshape(-1), jz.reshape(-1),
                                          (jwl >= 0).reshape(-1), D, K)
    np.testing.assert_array_equal(tomega.numpy(), np.asarray(jomega))
    lengths = corpus.doc_lengths().astype(np.int32)
    alpha0 = np.full(K, 50.0 / K, np.float32)
    ja = jdedup.optimize_alpha(jnp.asarray(alpha0), jomega,
                               jdedup.doc_length_histogram(jnp.asarray(lengths)), n_iters=5)
    ta = tdedup.optimize_alpha(torch.from_numpy(alpha0), tomega,
                               tdedup.doc_length_histogram(torch.from_numpy(lengths)),
                               n_iters=5)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-5)
    ap, aa = tsparse.make_alpha_table(ta)          # the refreshed α table
    assert ap.shape == (K,) and ((aa >= 0) & (aa < K)).all()

    # --- export ---
    jm = jrtlda.build_model(jnp.asarray(jdist.gather_phi(jphi, sc, K)), jnp.float32(0.01), ja)
    tm = trtlda.build_model(tdist.gather_phi(phi, sc), torch.tensor(0.01), ta, device="cpu")
    np.testing.assert_allclose(tm.pvk.numpy(), np.asarray(jm.pvk), rtol=1e-5)
    np.testing.assert_array_equal(tm.r_topic.numpy(), np.asarray(jm.r_topic))

    # --- serve JAX's exported model: P̂'s column sums differ from XLA's by an
    # ulp, and on these queries one RT-LDA hill climb (query 25) is near-tied
    # enough for that ulp to pick another topic ---
    tm = convert.rtlda_model_from_numpy(jm.pvk, jm.alpha, jm.r_topic, jm.r_value, "cpu")
    q = np.full((128, 8), -1, np.int32)
    starts = np.concatenate([[0], np.cumsum(corpus.doc_lengths())])
    for i in range(128):
        toks = corpus.word_ids[starts[i]:starts[i + 1]][:8]
        q[i, :len(toks)] = toks
    jp, ji, jw = jfeatures.query_topic_features(jm, jnp.asarray(q), seed=11, n_trials=2)
    tp_, ti, tw = tfeatures.make_serving_fn(5, 2, 30, device="cpu")(tm, q, 11)
    np.testing.assert_allclose(tp_.numpy(), np.asarray(jp), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-4)
    diff = ti.numpy() != np.asarray(ji)
    assert np.allclose(tw.numpy()[diff], np.asarray(jw)[diff], rtol=1e-4)
    np.testing.assert_allclose(tp_.sum(dim=1).numpy(), 1.0, atol=1e-5)


def test_entry_points_refuse_to_run_without_cuda(corpus):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    sc, _ = _ring(corpus, 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        tdist.device_arrays(sc, K)
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.alias_tables_from_numpy(*[np.zeros(2)] * 5, "cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.ring_state_from_numpy(*[np.zeros(2)] * 6, "cuda")
