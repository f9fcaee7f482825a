"""Port conformance of ``repro_torch.optim.l1_loglinear`` against
``repro.optim.l1_loglinear`` (the pCTR model of Fig. 8).

Logits are f32 sums in another order (rtol 1e-6, atol 1e-6; predictions
rtol 1e-6, atol 1e-7: a sigmoid near 0 turns the logit's absolute error
into its relative one); 50 proximal
SGD steps from the same init agree to rtol 1e-5, atol 1e-6, and a weight
JAX's soft-threshold zeroed may stay nonzero in the port only by less than
1e-6 (its pre-threshold value sat that close to lr·l1). ``auc`` is the same
host numpy on both sides.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import one_torch_thread as _one_torch_thread  # noqa: F401  (autouse)
from repro.optim import l1_loglinear as jl1
from repro_torch import convert
from repro_torch.optim import l1_loglinear as tl1

pytestmark = pytest.mark.port


def _data(seed, n=600, n_sparse=40, F=4, n_dense=32):
    """Multi-hot ids with -1 padding, dense features and labels that depend on both."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, n_sparse, (n, F)).astype(np.int32)
    ids[rng.uniform(size=(n, F)) < 0.25] = -1
    dx = rng.uniform(0, 2, (n, n_dense)).astype(np.float32)
    w_true = np.zeros(n_sparse)
    w_true[:6] = 1.5
    lg = np.where(ids >= 0, w_true[np.maximum(ids, 0)], 0).sum(1) + dx[:, 0] - dx[:, 1] - 0.5
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-lg))).astype(np.float32)
    return ids, dx, y


def _t(x):
    return torch.from_numpy(np.array(x))


def test_logits_and_predict_match():
    ids, dx, _ = _data(0)
    rng = np.random.default_rng(1)
    w_sparse = rng.normal(size=40).astype(np.float32)
    w_dense = rng.normal(size=32).astype(np.float32)
    bias = np.float32(-0.3)
    js = jl1.CTRState(jnp.array(w_sparse), jnp.array(w_dense), jnp.float32(bias))
    ts = convert.ctr_state_from_numpy(w_sparse, w_dense, bias, device="cpu")
    np.testing.assert_allclose(tl1.logits(ts, _t(ids), _t(dx)).numpy(),
                               np.asarray(jl1.logits(js, jnp.array(ids), jnp.array(dx))),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tl1.predict(ts, _t(ids), _t(dx)).numpy(),
                               np.asarray(jl1.predict(js, jnp.array(ids), jnp.array(dx))),
                               rtol=1e-6, atol=1e-7)
    # an all-padding row is the bias plus its dense term
    none = np.full((1, 4), -1, np.int32)
    np.testing.assert_allclose(float(tl1.logits(ts, _t(none), _t(dx[:1]))[0]),
                               bias + float(dx[0] @ w_dense), rtol=1e-6)


@pytest.mark.parametrize("lr,l1", [(0.3, 1e-2), (0.1, 1e-5)], ids=["sparsifying", "light_l1"])
def test_fifty_steps_match_jax(lr, l1):
    ids, dx, y = _data(2)
    js = jl1.init_state(40, 32)
    ts = tl1.init_state(40, 32, device="cpu")
    j_losses, t_losses = [], []
    for _ in range(50):
        js, jl = jl1.train_step(js, jnp.array(ids), jnp.array(dx), jnp.array(y), lr, l1)
        ts, tlv = tl1.train_step(ts, _t(ids), _t(dx), _t(y), lr, l1)
        j_losses.append(float(jl))
        t_losses.append(float(tlv))
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-5, atol=1e-6)
    for name in ("w_sparse", "w_dense", "bias"):
        a, b = getattr(ts, name).numpy(), np.asarray(getattr(js, name))
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6, err_msg=name)
        zeroed = b == 0
        assert (np.abs(a[zeroed]) < 1e-6).all(), name
    if l1 >= 1e-2:
        assert (np.asarray(js.w_sparse) == 0).any()     # the case holds real zeros


def test_sparsifies_and_learns():
    """``tests/test_checkpoint_optim.py::test_l1_loglinear_sparsifies_and_learns`` on the port."""
    rng = np.random.default_rng(0)
    n, n_sparse = 2000, 50
    ids = rng.integers(0, n_sparse, (n, 3)).astype(np.int32)
    w_true = np.zeros(n_sparse)
    w_true[:5] = 2.0
    logits = w_true[ids].sum(1) - 1.0
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-logits))).astype(np.float32)
    st = tl1.init_state(n_sparse, 1, device="cpu")
    dx = torch.zeros((n, 1))
    for _ in range(200):
        st, loss = tl1.train_step(st, _t(ids), dx, _t(y), 0.3, 3e-3)
    w = st.w_sparse.numpy()
    assert (np.abs(w) < 1e-6).mean() > 0.3          # L1 sparsity
    assert w[:5].mean() > np.abs(w[5:]).mean()      # signal recovered
    scores = tl1.predict(st, _t(ids), dx)
    assert tl1.auc(scores, y) > 0.65


def test_auc_matches_jax_with_ties():
    rng = np.random.default_rng(3)
    scores = np.round(rng.uniform(size=500), 2).astype(np.float32)    # many ties
    y = (rng.uniform(size=500) < scores).astype(np.int32)
    assert tl1.auc(_t(scores), _t(y)) == jl1.auc(scores, y)
    assert tl1.auc(scores, y) == jl1.auc(scores, y)


def test_auc_known_values():
    assert tl1.auc(np.array([0.9, 0.8, 0.1]), np.array([1, 1, 0])) == 1.0
    assert abs(tl1.auc(np.array([0.1, 0.8, 0.9]), np.array([1, 0, 0]))) < 1e-9
    assert tl1.auc(np.array([0.5, 0.5]), np.array([1, 0])) == 0.5
    assert tl1.auc(np.array([0.2, 0.7]), np.array([1, 1])) == 0.5     # one class only


def test_ctr_state_from_numpy_round_trip():
    rng = np.random.default_rng(4)
    w_sparse = rng.normal(size=7).astype(np.float32)
    js = jl1.CTRState(jnp.array(w_sparse), jnp.zeros(3), jnp.float32(0.25))
    ts = convert.ctr_state_from_numpy(*(np.asarray(x) for x in js), device="cpu")
    assert all(x.dtype == torch.float32 for x in ts)
    assert ts.bias.shape == ()
    for a, b in zip(ts, js):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the no-card error")
def test_init_state_on_cuda_raises_without_a_card():
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tl1.init_state(4, 2)
