"""Port conformance of ``repro_torch.core.gibbs`` against ``repro.core.gibbs``.

Both packages draw with the same counter-based Gumbel noise, so from the same
z0 they must give the same z, Φ and Ψ, sweep after sweep.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import one_torch_thread as _one_torch_thread  # noqa: F401  (autouse)
from repro.core import gibbs as jgibbs, lda as jlda
from repro.data import corpus as jcorpus, synthetic as jsynthetic
from repro_torch import convert
from repro_torch.core import gibbs as tgibbs, lda as tlda

pytestmark = pytest.mark.port

V, K, BLOCK = 200, 16, 512


@pytest.fixture(scope="module")
def setup():
    corpus, _ = jsynthetic.lda_corpus(seed=0, n_docs=300, n_topics=10, vocab_size=V,
                                      doc_len_mean=8)
    wi, di = jcorpus.pad_corpus(corpus.word_ids, corpus.doc_ids, BLOCK)
    valid = wi >= 0
    js = jlda.init_state(jax.random.key(0), jnp.array(wi[valid]), K, V)
    z = np.zeros(len(wi), np.int32)
    z[valid] = np.asarray(js.z)
    js = jlda.LDAState(js.phi, js.psi, jnp.array(z), js.alpha, js.beta)
    return corpus, wi, di, valid, js


def _port(js):
    return convert.lda_state_from_numpy(*(np.asarray(x) for x in (
        js.phi, js.psi, js.z, js.alpha, js.beta)), device="cpu")


def _assert_same(ts, js):
    for name in ("z", "phi", "psi"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                      np.asarray(getattr(js, name)), err_msg=name)


@pytest.mark.parametrize("jax_use_kernel", [False, True])
def test_sample_block_matches(setup, jax_use_kernel):
    """The port's block sweep against JAX's, with JAX drawing through its
    plain version or through its Pallas kernel (interpret mode on the CPU)."""
    corpus, wi, di, valid, js = setup
    T = BLOCK
    theta = jlda.doc_topic_counts(jnp.array(di), js.z, corpus.n_docs, K)
    uid = np.arange(T, dtype=np.uint32) + np.uint32(100)
    jz, jphi, jpsi, jth = jgibbs.sample_block(
        js.phi, js.psi, theta, js.z[:T], jnp.array(wi[:T]), jnp.array(di[:T]),
        jnp.array(uid), js.alpha, js.beta, jnp.uint32(11), V, 1.0, jax_use_kernel)
    ts = _port(js)
    tth = torch.from_numpy(np.array(theta))
    tz, tphi, tpsi, tth = tgibbs.sample_block(
        ts.phi, ts.psi, tth, ts.z[:T], torch.from_numpy(wi[:T]), torch.from_numpy(di[:T]),
        torch.from_numpy(uid.astype(np.int64)), ts.alpha, ts.beta, 11, V, 1.0)
    for a, b in [(tz, jz), (tphi, jphi), (tpsi, jpsi), (tth, jth)]:
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("seed,n_sweeps,epochs", [(7, 1, 5), (2**32 - 1, 2, 1)],
                         ids=["5_epochs", "seed_wraps"])
def test_gibbs_epochs_match(setup, seed, n_sweeps, epochs):
    corpus, wi, di, valid, js = setup
    ts = _port(js)
    twi, tdi = torch.from_numpy(wi), torch.from_numpy(di)
    for e in range(epochs):
        js = jgibbs.gibbs_epoch(js, jnp.array(wi), jnp.array(di), corpus.n_docs, V,
                                seed=jnp.uint32(seed + e), n_sweeps=n_sweeps,
                                block_size=BLOCK)
        ts = tgibbs.gibbs_epoch(ts, twi, tdi, corpus.n_docs, V, seed=seed + e,
                                n_sweeps=n_sweeps, block_size=BLOCK)
        _assert_same(ts, js)
    real = tlda.LDAState(ts.phi, ts.psi, ts.z[torch.from_numpy(valid)], ts.alpha, ts.beta)
    tlda.check_invariants(real, twi[torch.from_numpy(valid)])


def test_sentinels_leave_counts_untouched():
    """Padding tokens point at word 0 / doc 0 and must roll back their updates.

    Here word 0 and doc 0 both hold the padding's topic, so a padding row has
    no NaN score and draws a real topic; the JAX reference's rollback then
    undoes nothing (``repro/core/gibbs.py:151-156`` uses z_new after it was
    reset to z) and its counts drift from z. The port rolls back the raw draw.
    """
    Vs, Ks = 30, 4
    w = np.array([0] * 6 + list(range(1, 21)) + [-1] * 6, np.int32)
    d = np.array([0] * 6 + [1 + i // 4 for i in range(20)] + [0] * 6, np.int32)
    valid = w >= 0
    z = np.zeros(len(w), np.int32)
    tw, tz = torch.from_numpy(w[valid]), torch.from_numpy(z[valid])
    phi, psi = tlda.build_counts(tw, tz, Ks, Vs)
    ts = tlda.LDAState(phi, psi, torch.from_numpy(z), torch.full((Ks,), 0.5),
                       torch.tensor(0.01))
    for e in range(4):
        ts = tgibbs.gibbs_epoch(ts, torch.from_numpy(w), torch.from_numpy(d), 6, Vs,
                                seed=e, block_size=8)
        tlda.check_invariants(
            tlda.LDAState(ts.phi, ts.psi, ts.z[torch.from_numpy(valid)], ts.alpha,
                          ts.beta), tw)
        assert (ts.z[torch.from_numpy(~valid)] == 0).all()


def test_epoch_needs_padded_corpus(setup):
    corpus, wi, di, valid, js = setup
    with pytest.raises(ValueError, match="block_size"):
        tgibbs.gibbs_epoch(_port(js), torch.from_numpy(wi[:-1]),
                           torch.from_numpy(di[:-1]), corpus.n_docs, V, seed=0,
                           block_size=BLOCK)


def test_fold_in_matches(setup):
    corpus, wi, di, valid, js = setup
    js = jgibbs.gibbs_epoch(js, jnp.array(wi), jnp.array(di), corpus.n_docs, V,
                            seed=3, block_size=BLOCK)
    w, d = wi[valid][:400], di[valid][:400]
    n_docs = int(d.max()) + 1
    z0 = np.random.default_rng(5).integers(0, K, len(w)).astype(np.int32)
    jz, jth = jgibbs.fold_in(js.phi, js.psi, js.alpha, js.beta, jnp.array(w),
                             jnp.array(d), jnp.array(z0), n_docs, V, seed=9, n_sweeps=4)
    ts = _port(js)
    tz, tth = tgibbs.fold_in(ts.phi, ts.psi, ts.alpha, ts.beta, torch.from_numpy(w),
                             torch.from_numpy(d), torch.from_numpy(z0), n_docs, V,
                             seed=9, n_sweeps=4)
    np.testing.assert_array_equal(tz.numpy(), np.asarray(jz))
    np.testing.assert_array_equal(tth.numpy(), np.asarray(jth))


def test_token_logits_matches(setup):
    rng = np.random.default_rng(0)
    phi = rng.integers(0, 9, (5, K)).astype(np.float32)
    th = rng.integers(0, 4, (5, K)).astype(np.float32)
    psi = rng.integers(50, 90, K).astype(np.float32)
    alpha = rng.uniform(0.1, 1, K).astype(np.float32)
    j = jgibbs.token_logits(jnp.array(phi), jnp.array(psi), jnp.array(th),
                            jnp.array(alpha), jnp.float32(0.01), V)
    t = tgibbs.token_logits(*(torch.from_numpy(x) for x in (phi, psi, th, alpha)),
                            torch.tensor(0.01), V)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6)
