"""Port conformance of the sparse doc-topic pairs and the alias-MH block
sweep (``repro_torch.core.sparse``) against ``repro.core.sparse``.

Pairs, lookups and the two-pass ``apply_deltas`` are integer code and must be
equal bit for bit; so must the word proposal weights wq (one f32 add and one
divide per entry) and ``sample_block_mh`` given the JAX package's tables.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import one_torch_thread as _one_torch_thread  # noqa: F401  (autouse)
from repro.core import dedup as jdedup, sparse as jsparse
from repro_torch import convert
from repro_torch.core import sparse as tsparse

pytestmark = pytest.mark.port


def _t(x):
    return torch.from_numpy(np.array(x))


def _eq(a, b, msg=""):
    np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=msg)


@pytest.mark.parametrize("D,K,T,cap", [(13, 24, 400, 24), (20, 64, 160, 8), (5, 9, 50, 3)])
def test_pairs_lookup_and_dense_match_jax(D, K, T, cap):
    rng = np.random.default_rng(D + K)
    d = rng.integers(0, D, T).astype(np.int32)
    if cap < K:      # round-robin docs; (5, 9, 50, 3) still overflows its rows
        d = (np.arange(T) % D).astype(np.int32)
    z = rng.integers(0, K, T).astype(np.int32)
    valid = rng.random(T) > 0.1
    jtp, jct = jsparse.pairs_from_assignments(jnp.asarray(d), jnp.asarray(z),
                                              jnp.asarray(valid), D, cap)
    ttp, tct = tsparse.pairs_from_assignments(_t(d), _t(z), _t(valid), D, cap)
    _eq(ttp, jtp, "topic")
    _eq(tct, jct, "count")
    _eq(tsparse.pairs_to_dense(ttp, tct, K), jsparse.pairs_to_dense(jtp, jct, K))
    _eq(tsparse.pairs_lookup(ttp, tct, _t(d), _t(z)),
        jsparse.pairs_lookup(jtp, jct, jnp.asarray(d), jnp.asarray(z)))


def test_pairs_past_cap_are_dropped_as_in_jax():
    """A doc with more distinct topics than cap: JAX's mode="drop" loses the
    overflow, and so does the port."""
    d = np.zeros(6, np.int32)
    z = np.array([5, 1, 4, 1, 2, 0], np.int32)
    jtp, jct = jsparse.pairs_from_assignments(jnp.asarray(d), jnp.asarray(z),
                                              jnp.ones(6, bool), 1, 3)
    ttp, tct = tsparse.pairs_from_assignments(_t(d), _t(z), torch.ones(6, dtype=torch.bool),
                                              1, 3)
    _eq(ttp, jtp)
    _eq(tct, jct)


def test_pairs_topic_histogram_equals_dense_histogram():
    rng = np.random.default_rng(4)
    D, K, T = 40, 30, 600
    d = rng.integers(0, D, T).astype(np.int32)
    z = rng.integers(0, 6, T).astype(np.int32)     # repeats, so counts > 1
    valid = rng.random(T) > 0.2
    tp, ct = tsparse.pairs_from_assignments(_t(d), _t(z), _t(valid), D, 40)
    jomega = jdedup.topic_count_histogram(jnp.asarray(d), jnp.asarray(z),
                                          jnp.asarray(valid), D, K, max_count=8)
    _eq(tsparse.pairs_topic_histogram(tp, ct, K, max_count=8), jomega)


def test_apply_deltas_full_row_free_then_alloc():
    """cap < K, a row at full capacity: a flip from a count-1 topic to a
    fresh topic must free the old slot and land the new one in one block."""
    d = np.zeros(3, np.int32)
    z = np.array([1, 4, 7], np.int32)
    z_new = np.array([1, 4, 9], np.int32)
    ones = np.ones(3, bool)
    jtp, jct = jsparse.pairs_from_assignments(jnp.asarray(d), jnp.asarray(z),
                                              jnp.asarray(ones), 1, 3)
    jtp, jct = jsparse.apply_deltas(jtp, jct, jnp.asarray(d), jnp.asarray(z),
                                    jnp.asarray(z_new), jnp.asarray(ones))
    ttp, tct = tsparse.pairs_from_assignments(_t(d), _t(z), _t(ones), 1, 3)
    ttp, tct = tsparse.apply_deltas(ttp, tct, _t(d), _t(z), _t(z_new), _t(ones))
    _eq(ttp, jtp)
    _eq(tct, jct)
    dense = tsparse.pairs_to_dense(ttp, tct, 10)[0]
    assert dense[7] == 0 and dense[9] == 1 and int(tct.sum()) == 3


@pytest.mark.parametrize("cap_mode", ["cap_eq_K", "cap_lt_K"])
def test_apply_deltas_matches_jax_over_blocks(cap_mode):
    """Five blocks of random flips, including frees and fresh allocations in
    rows at full capacity: bitwise equal to JAX after every block, and equal
    to a dense scatter."""
    rng = np.random.default_rng(2)
    if cap_mode == "cap_lt_K":
        D, K, T, cap = 20, 64, 160, 8
        d = (np.arange(T) % D).astype(np.int32)
        valid = np.ones(T, bool)
    else:
        D, K, T = 9, 20, 300
        cap = K
        d = rng.integers(0, D, T).astype(np.int32)
        valid = rng.random(T) > 0.15
    z = rng.integers(0, K, T).astype(np.int32)
    jtp, jct = jsparse.pairs_from_assignments(jnp.asarray(d), jnp.asarray(z),
                                              jnp.asarray(valid), D, cap)
    ttp, tct = _t(jtp), _t(jct)
    dense = tsparse.pairs_to_dense(ttp, tct, K).numpy().copy()
    for _ in range(5):
        nxt = np.where(rng.random(T) > 0.4, rng.integers(0, K, T), z).astype(np.int32)
        jtp, jct = jsparse.apply_deltas(jtp, jct, jnp.asarray(d), jnp.asarray(z),
                                        jnp.asarray(nxt), jnp.asarray(valid))
        ttp, tct = tsparse.apply_deltas(ttp, tct, _t(d), _t(z), _t(nxt), _t(valid))
        _eq(ttp, jtp, "topic")
        _eq(tct, jct, "count")
        np.add.at(dense, (d[valid], z[valid]), -1)
        np.add.at(dense, (d[valid], nxt[valid]), 1)
        np.testing.assert_array_equal(tsparse.pairs_to_dense(ttp, tct, K).numpy(), dense)
        z = nxt
    assert ((tct > 0) | (ttp == -1)).all()


def _counts(V, K, D, T, seed=3):
    rng = np.random.default_rng(seed)
    w = rng.integers(0, V, T).astype(np.int32)
    d = (np.arange(T) % D).astype(np.int32)
    z = rng.integers(0, K, T).astype(np.int32)
    phi = np.zeros((V, K), np.int32)
    np.add.at(phi, (w, z), 1)
    return w, d, z, phi, np.bincount(z, minlength=K).astype(np.int32)


@pytest.mark.parametrize("lead", [(), (2,)])
def test_word_weights_are_bitwise(lead):
    """wq = (φ+β)/(ψ+Vβ) is equal bit for bit; the Walker tables built from
    it meet the table identity (their sums differ from XLA's in order)."""
    V, K = 30, 40
    rng = np.random.default_rng(7)
    phi = rng.integers(0, 9, lead + (V, K)).astype(np.int32)
    psi = (phi.reshape(-1, V, K).sum(axis=(0, 1)) + 3).astype(np.int32)
    jwq, _, _ = jsparse.make_word_tables(jnp.asarray(phi), jnp.asarray(psi), 0.01, 500,
                                         force="ref")
    old = tsparse.TABLE_ROWS
    tsparse.TABLE_ROWS = 7          # several row chunks, one ragged
    try:
        wq, wp, wa = tsparse.make_word_tables(_t(phi), _t(psi), 0.01, 500)
    finally:
        tsparse.TABLE_ROWS = old
    _eq(wq, jwq)
    assert wp.shape == phi.shape and wa.dtype == torch.int32
    p, a, q = wp.reshape(-1, K).numpy(), wa.reshape(-1, K).numpy(), wq.reshape(-1, K).numpy()
    rec = p.copy()
    for r in range(p.shape[0]):
        np.add.at(rec[r], a[r], 1.0 - p[r])
    np.testing.assert_allclose(rec, q * (K / q.sum(1, keepdims=True)), atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("K,cap", [(16, 16), (128, 12)])
def test_sample_block_mh_matches_jax(K, cap):
    """One block with the JAX package's tables carried across: z, Φ, Ψ and
    the pairs are equal bit for bit, and consistent with z."""
    V, D, T = 20, 32, 300
    w, d, z, phi, psi = _counts(V, K, D, T)
    alpha = np.full(K, 1.0 / 16, np.float32)          # Σα exact in any order
    jtabs = jsparse.make_tables(jnp.asarray(phi), jnp.asarray(psi), jnp.asarray(alpha),
                                jnp.float32(0.01), V, force="ref")
    jtp, jct = jsparse.pairs_from_assignments(jnp.asarray(d), jnp.asarray(z),
                                              jnp.ones(T, bool), D, cap)
    uid = np.arange(T, dtype=np.uint32) + np.uint32(7)
    jout = jsparse.sample_block_mh(
        jnp.asarray(phi), jnp.asarray(psi), jtp, jct, jnp.asarray(z), jnp.asarray(w),
        jnp.asarray(d), jnp.asarray(uid), jnp.asarray(alpha), jnp.float32(0.01), 11, V,
        jtabs, n_mh=4, force="ref")
    tabs = convert.alias_tables_from_numpy(*(np.asarray(x) for x in jtabs), "cpu")
    tout = tsparse.sample_block_mh(
        _t(phi), _t(psi), _t(jtp), _t(jct), _t(z), _t(w), _t(d), _t(uid.astype(np.int64)),
        _t(alpha), torch.tensor(0.01), 11, V, tabs, n_mh=4)
    for name, a, b in zip(("z", "phi", "psi", "topic", "count"), tout, jout):
        _eq(a, b, name)
    z2 = tout[0].numpy()
    dn = np.zeros((D, K), np.int32)
    np.add.at(dn, (d, z2), 1)
    np.testing.assert_array_equal(tsparse.pairs_to_dense(tout[3], tout[4], K).numpy(), dn)


def test_suggest_cap_bounds():
    for args in (([3, 9, 4], 100), ([3, 9, 4], 5), ([], 5)):
        assert tsparse.suggest_cap(*args) == jsparse.suggest_cap(*args)
