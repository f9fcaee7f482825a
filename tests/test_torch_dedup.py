"""Port conformance of ``repro_torch.core.dedup`` against ``repro.core.dedup``.

Histograms are integer counts (bitwise); ``optimize_alpha`` goes through
digamma, whose torch and XLA implementations differ in the last bits
(rtol 1e-5); the L1 clustering is the same host numpy on both sides.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from _torch_port import one_torch_thread as _one_torch_thread  # noqa: F401  (autouse)
from repro.core import dedup as jdedup
from repro_torch.core import dedup as tdedup

pytestmark = pytest.mark.port


def _docs(seed, D=80, K=6, hi=9):
    rng = np.random.default_rng(seed)
    theta = rng.integers(0, hi, (D, K))
    lengths = theta.sum(axis=1)
    doc_ids = np.repeat(np.arange(D), lengths).astype(np.int32)
    z = np.concatenate([np.repeat(np.arange(K), theta[d]) for d in range(D)]).astype(np.int32)
    valid = rng.uniform(size=len(z)) < 0.9
    return doc_ids, z, valid, lengths.astype(np.int32), D, K


@pytest.mark.parametrize("max_count", [4, 8, 64])
def test_histograms_bitwise(max_count):
    doc_ids, z, valid, lengths, D, K = _docs(0)
    j = jdedup.topic_count_histogram(jnp.array(doc_ids), jnp.array(z), jnp.array(valid),
                                     D, K, max_count=max_count)
    t = tdedup.topic_count_histogram(torch.from_numpy(doc_ids), torch.from_numpy(z),
                                     torch.from_numpy(valid), D, K, max_count=max_count)
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    for max_len in (16, 512):
        np.testing.assert_array_equal(
            tdedup.doc_length_histogram(torch.from_numpy(lengths), max_len).numpy(),
            np.asarray(jdedup.doc_length_histogram(jnp.array(lengths), max_len)))


@pytest.mark.parametrize("n_iters", [1, 20])
def test_optimize_alpha_allclose(n_iters):
    doc_ids, z, valid, lengths, D, K = _docs(1)
    omega = np.array(jdedup.topic_count_histogram(
        jnp.array(doc_ids), jnp.array(z), jnp.array(valid), D, K, max_count=16))
    dl = np.array(jdedup.doc_length_histogram(jnp.array(lengths)))
    alpha0 = np.linspace(0.05, 1.5, K).astype(np.float32)
    j = jdedup.optimize_alpha(jnp.array(alpha0), jnp.array(omega), jnp.array(dl), n_iters)
    t = tdedup.optimize_alpha(torch.from_numpy(alpha0), torch.from_numpy(omega),
                              torch.from_numpy(dl), n_iters)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5)


def test_pairwise_l1_allclose():
    phi = np.random.default_rng(2).integers(0, 30, (40, 9)).astype(np.int32)
    np.testing.assert_allclose(tdedup.pairwise_l1(torch.from_numpy(phi), torch.tensor(0.01)),
                               jdedup.pairwise_l1(phi, 0.01, block=4), rtol=1e-6)


@given(k=st.integers(2, 10), dup=st.integers(1, 3), seed=st.integers(0, 50))
@settings(max_examples=10, deadline=None)
def test_cluster_and_merge_match(k, dup, seed):
    """The tests/test_dedup.py L1-merge fixture: identical clusters and merges."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 60, (40, k)).astype(np.int32)
    phi = np.concatenate([base] + [base[:, :1]] * dup, axis=1)
    psi = phi.sum(axis=0)
    alpha = np.full(phi.shape[1], 0.5, np.float32)
    jcl, jn = jdedup.cluster_topics(jnp.array(phi), jnp.float32(0.01), l1_threshold=1e-6)
    tcl, tn = tdedup.cluster_topics(torch.from_numpy(phi), torch.tensor(0.01),
                                    l1_threshold=1e-6)
    np.testing.assert_array_equal(tcl, jcl)
    assert tn == jn
    jm = jdedup.merge_topics(phi, psi, alpha, jcl, jn)
    tm = tdedup.merge_topics(torch.from_numpy(phi), torch.from_numpy(psi),
                             torch.from_numpy(alpha), tcl, tn)
    for a, b in zip(tm, jm):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_duplicate_fraction_and_precomputed_distance_match():
    rng = np.random.default_rng(3)
    phi = rng.integers(0, 30, (40, 9)).astype(np.int32)
    phi[:, 5] = phi[:, 2]
    phi[:, 7] = phi[:, 0]
    d = tdedup.pairwise_l1(phi, 0.01)
    for thr in (1e-6, 0.05, 0.5):
        assert tdedup.duplicate_fraction(torch.from_numpy(phi), 0.01, thr) == \
            jdedup.duplicate_fraction(phi, 0.01, thr)
        assert tdedup.duplicate_fraction(phi, 0.01, thr, dist=d) == \
            jdedup.duplicate_fraction(phi, 0.01, thr)
    np.testing.assert_array_equal(tdedup.cluster_topics(phi, 0.01, 1e-6, dist=d)[0],
                                  jdedup.cluster_topics(phi, 0.01, 1e-6)[0])
    assert np.isfinite(np.diagonal(d)).all()
