"""Port conformance of ``repro_torch.core.lda`` against ``repro.core.lda``.

Counts are compared bit for bit; the likelihoods and the predictive log
probability are float sums taken in another order, so rtol 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import one_torch_thread as _one_torch_thread  # noqa: F401  (autouse)
from repro.core import lda as jlda
from repro_torch import convert
from repro_torch.core import lda as tlda

pytestmark = pytest.mark.port

V, K, D, N = 60, 8, 40, 600


def _corpus(seed=0):
    rng = np.random.default_rng(seed)
    w = rng.integers(0, V, N).astype(np.int32)
    d = np.sort(rng.integers(0, D, N)).astype(np.int32)
    z = rng.integers(0, K, N).astype(np.int32)
    alpha = rng.uniform(0.05, 1.0, K).astype(np.float32)
    return w, d, z, alpha


def _jax_state(w, z, alpha):
    phi, psi = jlda.build_counts(jnp.array(w), jnp.array(z), K, V)
    return jlda.LDAState(phi, psi, jnp.array(z), jnp.array(alpha), jnp.float32(0.01))


def _port_state(js):
    return convert.lda_state_from_numpy(*(np.asarray(x) for x in (
        js.phi, js.psi, js.z, js.alpha, js.beta)), device="cpu")


def test_counts_bitwise():
    w, d, z, alpha = _corpus()
    js = _jax_state(w, z, alpha)
    phi, psi = tlda.build_counts(torch.from_numpy(w), torch.from_numpy(z), K, V)
    np.testing.assert_array_equal(phi.numpy(), np.asarray(js.phi))
    np.testing.assert_array_equal(psi.numpy(), np.asarray(js.psi))
    theta = tlda.doc_topic_counts(torch.from_numpy(d), torch.from_numpy(z), D, K)
    np.testing.assert_array_equal(
        theta.numpy(), np.asarray(jlda.doc_topic_counts(jnp.array(d), jnp.array(z), D, K)))
    assert phi.dtype == psi.dtype == theta.dtype == torch.int32


def test_init_state_from_jax_z0_and_generator():
    w, _, _, _ = _corpus()
    js = jlda.init_state(jax.random.key(3), jnp.array(w), K, V)
    ts = tlda.init_state(w, K, V, z0=np.array(js.z), device="cpu")
    for a, b in [(ts.phi, js.phi), (ts.psi, js.psi), (ts.z, js.z)]:
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(ts.alpha.numpy(), np.asarray(js.alpha))
    assert float(ts.beta) == float(js.beta)
    g = tlda.init_state(w, K, V, generator=torch.Generator().manual_seed(0), device="cpu")
    tlda.check_invariants(g, torch.from_numpy(w))
    assert g.z.min() >= 0 and g.z.max() < K
    with pytest.raises(ValueError):
        tlda.init_state(w, K, V, device="cpu")


def test_phi_theta_hat():
    w, d, z, alpha = _corpus(1)
    js = _jax_state(w, z, alpha)
    ts = _port_state(js)
    np.testing.assert_allclose(tlda.phi_hat(ts.phi, ts.beta).numpy(),
                               np.asarray(jlda.phi_hat(js.phi, js.beta)), rtol=1e-6)
    assert ts.phi.dtype == torch.int32          # phi_hat works on its own copy
    th = jlda.doc_topic_counts(jnp.array(d), jnp.array(z), D, K)
    np.testing.assert_allclose(
        tlda.theta_hat(torch.from_numpy(np.array(th)), ts.alpha).numpy(),
        np.asarray(jlda.theta_hat(th, js.alpha)), rtol=1e-6)


def test_likelihoods_and_perplexity():
    w, d, z, alpha = _corpus(2)
    js = _jax_state(w, z, alpha)
    ts = _port_state(js)
    tw, td, tz = (torch.from_numpy(x) for x in (w, d, z))
    np.testing.assert_allclose(float(tlda.word_log_likelihood(ts.phi, ts.psi, ts.beta)),
                               float(jlda.word_log_likelihood(js.phi, js.psi, js.beta)),
                               rtol=1e-4)
    np.testing.assert_allclose(float(tlda.doc_log_likelihood(td, tz, ts.alpha, D)),
                               float(jlda.doc_log_likelihood(jnp.array(d), jnp.array(z),
                                                             js.alpha, D)), rtol=1e-4)
    jargs = (js.phi, js.psi, js.beta, js.alpha, jnp.array(w), jnp.array(d), jnp.array(z), D)
    targs = (ts.phi, ts.psi, ts.beta, ts.alpha, tw, td, tz, D)
    np.testing.assert_allclose(float(tlda.predictive_log_prob(*targs)),
                               float(jlda.predictive_log_prob(*jargs)), rtol=1e-4)
    np.testing.assert_allclose(tlda.perplexity(*targs), jlda.perplexity(*jargs), rtol=1e-4)


def test_topic_pmi_matches():
    w, d, z, alpha = _corpus(3)
    js = _jax_state(w, z, alpha)
    np.testing.assert_allclose(
        tlda.topic_pmi(torch.from_numpy(np.array(js.phi)), torch.from_numpy(w),
                       torch.from_numpy(d), D, top_n=5),
        jlda.topic_pmi(np.asarray(js.phi), w, d, D, top_n=5), rtol=1e-12)


def test_check_invariants_catches_drift():
    w, _, z, alpha = _corpus(4)
    ts = _port_state(_jax_state(w, z, alpha))
    tlda.check_invariants(ts, torch.from_numpy(w))
    ts.phi[3, 2] += 1
    with pytest.raises(AssertionError, match="phi"):
        tlda.check_invariants(ts, torch.from_numpy(w))


def test_word_log_likelihood_resolves_a_move_at_large_k():
    """At many topics the f32 form with the two large constants (the JAX
    package's) rounds a few tokens' moves away; the port's term-by-term sum
    stays within 1e-6 of an f64 sum of the same formula and sees the move.
    Rows are summed in chunks of ``LL_ROWS``; cut it to cover the chunking."""
    from scipy.special import gammaln

    Vb, Kb, n = 600, 20_000, 3_000
    rng = np.random.default_rng(4)
    w, z = rng.integers(0, Vb, n), rng.integers(0, Kb, n)

    def exact(w, z):
        phi = np.zeros((Vb, Kb))
        np.add.at(phi, (w, z), 1)
        b = np.float64(np.float32(0.01))
        vb = Vb * b
        return (Kb * (gammaln(vb) - Vb * gammaln(b)) + gammaln(phi + b).sum()
                - gammaln(phi.sum(0) + vb).sum())

    def port(w, z):
        phi, psi = tlda.build_counts(torch.from_numpy(w), torch.from_numpy(z), Kb, Vb)
        return float(tlda.word_log_likelihood(phi, psi, torch.tensor(0.01)))

    z2 = z.copy()
    z2[:20] = z[20:40]                      # move 20 tokens into topics of others
    old = tlda.LL_ROWS
    tlda.LL_ROWS = 256
    try:
        got = [port(w, z), port(w, z2)]
    finally:
        tlda.LL_ROWS = old
    want = [exact(w, z), exact(w, z2)]
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert abs((got[1] - got[0]) - (want[1] - want[0])) < 0.05 * abs(want[1] - want[0])
