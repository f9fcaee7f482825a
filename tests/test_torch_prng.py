"""Port conformance: the counter-based RNG of ``repro_torch.core.prng`` against
``repro.core.prng``. Integer paths must agree bitwise; the Gumbel transform
goes through two ``log``s, and torch's and XLA's ``log`` may differ by 1 ulp.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import one_torch_thread as _one_torch_thread  # noqa: F401  (autouse)
from repro.core import prng as jprng
from repro_torch.core import prng as tprng

pytestmark = pytest.mark.port

UID = np.arange(4096, dtype=np.uint32) * np.uint32(7919) + np.uint32(3)
KS = np.arange(1024, dtype=np.uint32)


def _both(fn_name, seed):
    j = getattr(jprng, fn_name)(jnp.uint32(seed), jnp.array(UID)[:, None],
                                jnp.array(KS)[None, :])
    t = getattr(tprng, fn_name)(seed, torch.from_numpy(UID.astype(np.int64))[:, None],
                                torch.from_numpy(KS.astype(np.int64))[None, :])
    return np.asarray(j), t.numpy()


@pytest.mark.parametrize("seed", [0, 42, 2**32 - 1])
def test_hash_bits_bitwise(seed):
    j, t = _both("hash_bits", seed)
    assert t.shape == (4096, 1024)
    np.testing.assert_array_equal(j.astype(np.int64), t)


@pytest.mark.parametrize("seed", [0, 42, 2**32 - 1])
def test_uniform01_bitwise(seed):
    j, t = _both("uniform01", seed)
    assert t.dtype == np.float32
    np.testing.assert_array_equal(j.view(np.int32), t.view(np.int32))
    assert 0.0 < t.min() and t.max() <= 1.0


@pytest.mark.parametrize("seed", [0, 2**32 - 1])
def test_gumbel_within_one_ulp_per_log(seed):
    """-log(-log u): the inner log may differ by 1 ulp of its result; that
    moves the outer log's result by at most 2⁻²³ (relative input error),
    and the outer log adds 1 ulp of its own result."""
    j, t = _both("gumbel", seed)
    bound = 2.0 ** -23 + np.spacing(np.abs(j).astype(np.float32))
    assert (np.abs(j - t) <= bound).all()


def test_top_bits_all_ones_give_u_one_in_both():
    """At (seed 0, a 8165116, b 0) the hash's top 24 bits are all ones;
    (2²⁴ − 1) + 0.5 rounds to 2²⁴ in float32, so the reference's uniform01 is
    exactly 1.0 there and the Gumbel noise +inf (a forced draw). The port
    keeps that bit for bit."""
    a = np.array([8165116, 8165117], np.uint32)
    j = jprng.gumbel(jnp.uint32(0), jnp.array(a), jnp.uint32(0))
    t = tprng.gumbel(0, torch.from_numpy(a.astype(np.int64)), 0)
    assert float(tprng.uniform01(0, 8165116, 0)) == 1.0
    assert float(j[0]) == float(t[0]) == float("inf")
    assert np.isfinite(float(t[1])) and abs(float(t[1]) - float(j[1])) <= 1e-6


def test_scalar_and_tensor_forms_agree():
    """A hash of Python ints equals the same entry of a tensor hash."""
    grid = tprng.hash_bits(7, torch.arange(5, dtype=torch.int64)[:, None],
                           torch.arange(3, dtype=torch.int64)[None, :])
    assert int(tprng.hash_bits(7, 4, 2)) == int(grid[4, 2])
    assert int(tprng.fmix32(0)) == 0
