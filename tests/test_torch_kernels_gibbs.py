"""Port conformance of the fused Gibbs/RT-LDA argmax.

On the CPU: the plain PyTorch version against the JAX package's
``gibbs_argmax`` (``force="ref"``) on the same numpy inputs. Both use the same
counter-based Gumbel noise, so z must be equal; a differing row is allowed
only where the two picks are a near-tie (≤ 4 ulp apart), since torch's and
XLA's ``log`` may differ by 1 ulp.

On a CUDA card (tests marked ``kernels``; they skip without one): the
hand-written kernel against the plain version on the card.
"""
import numpy as np
import pytest
import torch

from _torch_port import one_torch_thread as _one_torch_thread  # noqa: F401  (autouse)
from repro_torch.kernels.gibbs import ops
from repro_torch.kernels.gibbs.kernel import gibbs_argmax_cuda
from repro_torch.kernels.gibbs.ref import gibbs_argmax_ref, gibbs_scores

pytestmark = pytest.mark.port

SHAPES = [(8, 64), (16, 100), (256, 512), (100, 700), (257, 513), (64, 1024),
          (31, 1000)]


def _inputs(T, K, seed=7, psi_row=False):
    rng = np.random.default_rng(seed + T * 1000 + K)
    phi = rng.integers(0, 50, (T, K)).astype(np.float32)
    psi = rng.integers(1, 500, (K,) if psi_row else (T, K)).astype(np.float32)
    theta = rng.integers(0, 10, (T, K)).astype(np.float32)
    alpha = rng.uniform(0.01, 1.0, K).astype(np.float32)
    uid = np.arange(T, dtype=np.uint32) + np.uint32(31)
    return phi, psi, theta, alpha, uid


def near_tie_rows(scores: np.ndarray, a: np.ndarray, b: np.ndarray,
                  max_ulp: int = 4) -> np.ndarray:
    """Rows where picks ``a`` and ``b`` differ by more than a near-tie:
    their scores (``scores`` [T, K], from one side) more than ``max_ulp``
    ulp apart."""
    rows = np.nonzero(a != b)[0]
    sa = scores[rows, a[rows]].astype(np.float32)
    sb = scores[rows, b[rows]].astype(np.float32)
    gap = np.abs(sa - sb)
    tol = max_ulp * np.spacing(np.maximum(np.abs(sa), np.abs(sb)))
    return rows[~(gap <= tol)]


def _torch_args(phi, psi, theta, alpha, uid, beta, device="cpu"):
    t = lambda x: torch.from_numpy(x).to(device)
    return (t(phi), t(psi), t(theta), t(alpha),
            torch.tensor(beta, dtype=torch.float32, device=device),
            t(uid.astype(np.int64)))


def _scores(phi, psi, theta, alpha, uid, beta, seed, V, temperature):
    """The score plane of the plain version, for judging near-ties."""
    return gibbs_scores(*_torch_args(phi, psi, theta, alpha, uid, beta), seed, V,
                        temperature).numpy()


@pytest.fixture(scope="module")
def jax_gibbs():
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.gibbs import ops as jops

    def run(phi, psi, theta, alpha, uid, beta, seed, V, temperature):
        z = jops.gibbs_argmax(jnp.array(phi), jnp.array(psi), jnp.array(theta),
                              jnp.array(alpha), jnp.float32(beta), jnp.array(uid),
                              jnp.uint32(seed), V, temperature, force="ref")
        return np.asarray(z)
    return run


@pytest.mark.parametrize("psi_row", [False, True], ids=["psi_plane", "psi_row"])
@pytest.mark.parametrize("temperature", [1.0, 0.0])
@pytest.mark.parametrize("T,K", SHAPES)
def test_plain_matches_jax(jax_gibbs, T, K, temperature, psi_row):
    phi, psi, theta, alpha, uid = _inputs(T, K, psi_row=psi_row)
    args = (phi, psi, theta, alpha, uid, 0.01, 42, 5000, temperature)
    zj = jax_gibbs(*args)
    zt = ops.gibbs_argmax(*_torch_args(*args[:6]), 42, 5000, temperature).numpy()
    assert zt.dtype == np.int32 and zt.shape == (T,)
    assert ((zt >= 0) & (zt < K)).all()
    assert near_tie_rows(_scores(*args), zt, zj).size == 0


def test_gumbel_max_is_exact_categorical():
    """Empirical law of the Gumbel-max draw matches the true posterior."""
    T, K = 4000, 12
    weights = np.random.default_rng(7).integers(1, 40, K).astype(np.float32)
    phi = torch.from_numpy(weights)[None, :].expand(T, K).contiguous()
    z = gibbs_argmax_ref(phi, torch.full((T, K), 400.0), torch.zeros(T, K),
                         torch.ones(K), torch.tensor(0.1), torch.arange(T), 9, 100)
    p_emp = np.bincount(z.numpy(), minlength=K) / T
    p_true = (weights + 0.1) / (weights + 0.1).sum()
    assert np.abs(p_emp - p_true).max() < 0.03


def test_nan_rows_stay_in_range():
    """A NaN counts as the largest score and an all-NaN row yields 0, as in
    jnp.argmax; the index is always in [0, K)."""
    T, K = 3, 40
    phi = torch.full((T, K), 5.0)
    phi[0, 17] = -1.0                 # log(-1 + beta) is NaN
    phi[1] = -1.0                     # whole row NaN
    z = gibbs_argmax_ref(phi, torch.full((T, K), 100.0), torch.ones(T, K),
                         torch.ones(K), torch.tensor(0.01), torch.arange(T), 3, 50)
    assert z.tolist()[:2] == [17, 0] and 0 <= int(z[2]) < K


def test_cpu_tensors_use_plain_version_and_do_not_count():
    before = ops.launches
    args = _torch_args(*_inputs(8, 64), 0.01)
    a = ops.gibbs_argmax(*args, 5, 100, 1.0)
    b = gibbs_argmax_ref(*args, 5, 100, 1.0)
    assert torch.equal(a, b) and ops.launches == before


def test_kernel_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        gibbs_argmax_cuda(*_torch_args(*_inputs(8, 64), 0.01), 5, 100, 1.0)


@pytest.mark.kernels
@pytest.mark.parametrize("psi_row", [False, True], ids=["psi_plane", "psi_row"])
@pytest.mark.parametrize("temperature", [1.0, 0.0])
@pytest.mark.parametrize("T,K", [(8, 64), (257, 513), (31, 1000), (64, 5000)])
def test_cuda_kernel_matches_plain(T, K, temperature, psi_row):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    phi, psi, theta, alpha, uid = _inputs(T, K, psi_row=psi_row)
    theta[0, :] = 0.0            # a row with exact ties at temperature 0
    phi[1, 3] = -1.0             # a NaN score
    args = _torch_args(phi, psi, theta, alpha, uid, 0.01, device="cuda")
    before = ops.launches
    zk = ops.gibbs_argmax(*args, 42, 5000, temperature)
    torch.cuda.synchronize()
    assert ops.launches == before + 1
    zp = gibbs_argmax_ref(*args, 42, 5000, temperature)
    zk, zp = zk.cpu().numpy(), zp.cpu().numpy()
    assert ((zk >= 0) & (zk < K)).all()
    scores = _scores(phi, psi, theta, alpha, uid, 0.01, 42, 5000, temperature)
    assert near_tie_rows(scores, zk, zp).size == 0
