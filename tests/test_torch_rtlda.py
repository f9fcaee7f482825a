"""Port conformance of ``repro_torch.core.rtlda`` and ``core.features`` against
``repro.core.rtlda`` / ``repro.core.features``.

The hill climb only multiplies, adds and compares, so its z is exact and
``pkd`` differs only by the order of the final row sum (1e-6). ``pvk`` is a
column sum in another order (allclose), its argmax R cache must be equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import one_torch_thread as _one_torch_thread  # noqa: F401  (autouse)
from repro.core import features as jfeatures, rtlda as jrtlda
from repro.data import fixtures as jfixtures
from repro_torch import convert
from repro_torch.core import features as tfeatures, rtlda as trtlda

pytestmark = pytest.mark.port

V, K, LD = 200, 16, 8


@pytest.fixture(scope="module")
def trained():
    corpus, state = jfixtures.quick_train(K, V, train_iters=6, n_docs=300)
    jm = jrtlda.build_model(state.phi, state.beta, state.alpha)
    tm = convert.rtlda_model_from_numpy(*(np.asarray(x) for x in (
        jm.pvk, jm.alpha, jm.r_topic, jm.r_value)), device="cpu")
    # queries: corpus docs cut or padded to LD, plus an empty one
    starts = np.concatenate([[0], np.cumsum(corpus.doc_lengths())])
    q = np.full((65, LD), -1, np.int32)
    for i in range(64):
        toks = corpus.word_ids[starts[i]:starts[i + 1]][:LD]
        q[i, :len(toks)] = toks
    return state, jm, tm, q


def test_build_model_matches(trained):
    state, jm, _, _ = trained
    tm = trtlda.build_model(np.array(state.phi), np.array(state.beta),
                            np.array(state.alpha), device="cpu")
    np.testing.assert_allclose(tm.pvk.numpy(), np.asarray(jm.pvk), rtol=1e-6)
    np.testing.assert_array_equal(tm.r_topic.numpy(), np.asarray(jm.r_topic))
    np.testing.assert_allclose(tm.r_value.numpy(), np.asarray(jm.r_value), rtol=1e-6)
    assert tm.r_topic.dtype == torch.int32


@pytest.mark.parametrize("n_trials", [1, 2, 3])
def test_infer_batch_matches(trained, n_trials):
    _, jm, tm, q = trained
    j = jrtlda.rtlda_infer_batch(jm, jnp.array(q), jnp.uint32(17), 5, n_trials)
    t = trtlda.rtlda_infer_batch(tm, torch.from_numpy(q), 17, 5, n_trials)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(t.sum(dim=1).numpy(), 1.0, rtol=1e-5)


def test_infer_dense_matches(trained):
    _, jm, tm, q = trained
    np.testing.assert_allclose(
        trtlda.rtlda_infer_dense(tm, torch.from_numpy(q), 5).numpy(),
        np.asarray(jrtlda.rtlda_infer_dense(jm, jnp.array(q), 5)), rtol=1e-6, atol=1e-7)


def test_word_likelihood_topk_ties_go_low():
    """Dyadic inputs make the product exact, so the ids must match lax.top_k's
    order even across the many exact ties."""
    rng = np.random.default_rng(0)
    pvk = (rng.integers(0, 4, (300, 6)) / 8).astype(np.float32)
    pkd = (rng.integers(0, 3, (5, 6)) / 4).astype(np.float32)
    ji, jw = jfeatures.word_likelihood_topk(jnp.array(pvk), jnp.array(pkd), 30)
    ti, tw = tfeatures.word_likelihood_topk(torch.from_numpy(pvk), torch.from_numpy(pkd), 30)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    assert ti.dtype == torch.int32


def test_query_features_and_serving_fn_match(trained):
    _, jm, tm, q = trained
    jp, ji, jw = jfeatures.query_topic_features(jm, jnp.array(q), seed=5, n_trials=2)
    tp, ti, tw = tfeatures.make_serving_fn(5, 2, 30, device="cpu")(tm, q, 5)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-5, atol=1e-8)
    # ids agree except where two words' weights are a near-tie
    diff = ti.numpy() != np.asarray(ji)
    assert np.allclose(tw.numpy()[diff], np.asarray(jw)[diff], rtol=1e-5)


def test_cosine_and_buckets_match(trained):
    _, jm, tm, q = trained
    jp = np.array(jrtlda.rtlda_infer_batch(jm, jnp.array(q), jnp.uint32(1), 5, 1))
    np.testing.assert_allclose(
        tfeatures.cosine_topic_similarity(torch.from_numpy(jp[:10]),
                                          torch.from_numpy(jp[10:30])).numpy(),
        np.asarray(jfeatures.cosine_topic_similarity(jnp.array(jp[:10]),
                                                     jnp.array(jp[10:30]))), rtol=1e-5)
    for n in (0, 3, 8, 9, 64, 65):
        assert trtlda.select_bucket(n, trtlda.DEFAULT_BUCKETS) == \
            jrtlda.select_bucket(n, jrtlda.DEFAULT_BUCKETS)
