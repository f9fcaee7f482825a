"""Port conformance of the alias-table build and the MH probe.

On the CPU: the plain PyTorch versions against the JAX package
(``force="ref"``) on the same numpy inputs. ``_prepare``'s order and small
counts are equal and its normalized weights allclose (torch and XLA sum a row
in different orders); on rows whose sums are exact in any order its scale,
normalized weights and tables are bit for bit JAX's; given the same
(wn, order, ns) the sweep is bitwise;
the MH probe is bitwise given the same tables (its α is dyadic, so Σα is
exact in any order), with and without the by-word reorder.

On a CUDA card (tests marked ``kernels``; they skip without one): each
hand-written kernel against its plain version on the card, bit for bit; the
alias build also on rows made to hit its tile logic, on a 2,049-row table at
K = 100,000 and on sampled rows of a table of more than 2³¹ elements. The
JAX package is imported only by the tests that compare with it, so the card
tests also run where jax is not installed.
"""
import types

import numpy as np
import pytest
import torch

from _torch_port import one_torch_thread as _one_torch_thread  # noqa: F401  (autouse)
from repro_torch import convert
from repro_torch.core import sparse as tsparse
from repro_torch.kernels.alias import ops
from repro_torch.kernels.alias.kernel import alias_build_cuda, mh_resample_cuda, mh_slot_bound
from repro_torch.kernels.alias.ref import build_alias_ref, edge_rows, mh_resample_ref
from repro_torch.kernels.gibbs.ref import gibbs_argmax_ref

pytestmark = pytest.mark.port

BUILD_SHAPES = [(1, 8), (5, 37), (16, 128), (3, 513)]
MH_CASES = [(37, 16, 1), (300, 16, 5), (64, 130, 4)]


def _weights(R, K, seed=11):
    rng = np.random.default_rng(seed + R * 1000 + K)
    return rng.gamma(0.3, 1.0, (R, K)).astype(np.float32) + np.float32(1e-3)


def _special_rows(K):
    """A one-hot row, an all-equal row and a row with a zero-weight tail."""
    w = np.ones((3, K), np.float32)
    w[0] = 0.0
    w[0, 3] = 5.0
    w[2, K // 2:] = 0.0
    return w


def _int_rows(K, R=64, seed=3):
    """Integer weights 0–9 and a zero row: every row sum is exact in f32 in
    any summation order, so the two packages' sums agree bit for bit."""
    w = np.random.default_rng(seed).integers(0, 10, (R, K)).astype(np.float32)
    w[5] = 0.0
    return w


def _t(x, device="cpu"):
    return torch.from_numpy(np.array(x)).to(device)


@pytest.fixture(scope="module")
def jx():
    """The JAX package's alias modules."""
    jnp = pytest.importorskip("jax.numpy")
    from repro.core import sparse
    from repro.kernels.alias import ops as jops, ref as jref
    return types.SimpleNamespace(jnp=jnp, sparse=sparse, ops=jops, ref=jref)


# ------------------------------------------------------------- build --------


@pytest.mark.parametrize("R,K", BUILD_SHAPES + [(3, 16), (3, 129)])
def test_prepare_matches_jax(jx, R, K):
    w = _special_rows(K) if (R, K) in ((3, 16), (3, 129)) else _weights(R, K)
    jwn, jorder, jns = (np.asarray(x) for x in jx.ops._prepare(jx.jnp.asarray(w)))
    twn, torder, tns = ops._prepare(_t(w))
    np.testing.assert_array_equal(torder.numpy(), jorder)
    np.testing.assert_array_equal(tns.numpy(), jns)
    np.testing.assert_allclose(twn.numpy(), jwn, rtol=1e-6)


@pytest.mark.parametrize("K", [1000, 4097, 100_000])
def test_prepare_scale_matches_jax_bitwise(jx, K):
    """The mean-1 scale is JAX's f32 K / Σw, an IEEE division, so with the
    same sums wn, order and ns are bit for bit JAX's (a reciprocal times K
    differs in about a quarter of the rows at K not a power of two)."""
    w = _int_rows(K)
    jwn, jorder, jns = (np.asarray(x) for x in jx.ops._prepare(jx.jnp.asarray(w)))
    twn, torder, tns = ops._prepare(_t(w), ops._scale(_t(w)))
    np.testing.assert_array_equal(twn.numpy().view(np.int32), jwn.view(np.int32))
    np.testing.assert_array_equal(torder.numpy(), jorder)
    np.testing.assert_array_equal(tns.numpy(), jns)


@pytest.mark.parametrize("K", [1000, 4097, 100_000])
def test_build_alias_matches_jax_bitwise(jx, K):
    """End to end on the CPU: ``build_alias`` equals JAX's ``build_alias``
    (``force="ref"``) bit for bit on rows with exact sums."""
    w = _int_rows(K)
    jp, ja = (np.asarray(x) for x in jx.ops.build_alias(jx.jnp.asarray(w), force="ref"))
    tp, ta = ops.build_alias(_t(w))
    np.testing.assert_array_equal(tp.numpy().view(np.int32), jp.view(np.int32))
    np.testing.assert_array_equal(ta.numpy(), ja)


@pytest.mark.parametrize("R,K", BUILD_SHAPES)
def test_sweep_matches_jax_bitwise(jx, R, K):
    """Given JAX's own (wn, order, ns), the sweep is bit for bit."""
    wn, order, ns = jx.ops._prepare(jx.jnp.asarray(_weights(R, K)))
    jp, ja = jx.ref.build_alias_ref(wn, order, ns)
    tp, ta = build_alias_ref(_t(wn), _t(order), _t(ns))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))


@pytest.mark.parametrize("shape", [(4, 64), (2, 3, 32), (3, 16)])
def test_table_identity(shape):
    """q(k) = (prob_k + Σ_j (1−prob_j)·1[alias_j = k]) / K = w_k / Σw."""
    K = shape[-1]
    w = _special_rows(K) if shape == (3, 16) else \
        np.random.default_rng(5).gamma(0.5, 1.0, shape).astype(np.float32) + 1e-3
    prob, alias = ops.build_alias(_t(w))
    assert prob.shape == w.shape and alias.shape == w.shape
    p, a = prob.reshape(-1, K).numpy(), alias.reshape(-1, K).numpy()
    wn = w.reshape(-1, K) * (K / w.reshape(-1, K).sum(1, keepdims=True))
    rec = p.copy()
    for r in range(p.shape[0]):
        np.add.at(rec[r], a[r], 1.0 - p[r])
    np.testing.assert_allclose(rec, wn, atol=2e-5, rtol=1e-5)
    assert (p >= 0).all() and (p <= 1).all() and ((a >= 0) & (a < K)).all()


def test_build_alias_out_fills_given_tensors():
    w = _t(_weights(5, 37))
    prob, alias = torch.empty(5, 37), torch.empty(5, 37, dtype=torch.int32)
    p, a = ops.build_alias(w, out=(prob, alias))
    assert p.data_ptr() == prob.data_ptr() and a.data_ptr() == alias.data_ptr()
    p2, a2 = ops.build_alias(w)
    assert torch.equal(prob, p2) and torch.equal(alias, a2)


# ------------------------------------------------------------- probe --------


def _mh_case(V, K, D, T, cap, seed=3, jx=None, hollow=0):
    """Consistent counts, pairs, dyadic α and tables, as numpy: pairs and
    tables from the JAX package when ``jx`` is given, else from the port.
    With ``hollow`` the tokens of every doc d ≡ 0 (mod hollow) are left out
    of the pairs, so their rows hold zero counts (as padding tokens see)."""
    rng = np.random.default_rng(seed)
    w = rng.integers(0, V, T).astype(np.int32)
    d = (np.arange(T) % D).astype(np.int32)       # ⌈T/D⌉ tokens per doc
    z = rng.integers(0, K, T).astype(np.int32)
    phi = np.zeros((V, K), np.int32)
    np.add.at(phi, (w, z), 1)
    psi = np.bincount(z, minlength=K).astype(np.int32)
    # multiples of 2⁻⁸ below 1: Σα is exact in any summation order
    alpha = (rng.integers(13, 205, K) / 256.0).astype(np.float32)
    if jx is not None:
        jnp = jx.jnp
        tp, ct = jx.sparse.pairs_from_assignments(jnp.asarray(d), jnp.asarray(z),
                                                  jnp.ones(T, bool), D, cap)
        tabs = jx.sparse.make_tables(jnp.asarray(phi), jnp.asarray(psi), jnp.asarray(alpha),
                                     jnp.float32(0.01), V, force="ref")
    else:
        valid = torch.ones(T, dtype=torch.bool) if not hollow else _t(d % hollow != 0)
        tp, ct = tsparse.pairs_from_assignments(_t(d), _t(z), valid, D, cap)
        tabs = tsparse.make_tables(_t(phi), _t(psi), _t(alpha), 0.01, V)
    uid = np.arange(T, dtype=np.uint32) + np.uint32(7)
    return dict(phi=phi, psi=psi, tp=np.asarray(tp), ct=np.asarray(ct),
                tabs=[np.asarray(x) for x in tabs], alpha=alpha, w=w, d=d, z=z,
                uid=uid, V=V)


def _jax_mh(jx, c, seed, n_mh):
    jnp = jx.jnp
    wq, wp, wa, ap, aa = c["tabs"]
    out = jx.ops.mh_resample(
        jnp.asarray(c["phi"]), jnp.asarray(c["psi"]), jnp.asarray(c["tp"]),
        jnp.asarray(c["ct"]), jnp.asarray(wq), jnp.asarray(wp), jnp.asarray(wa),
        jnp.asarray(c["alpha"]), jnp.asarray(ap), jnp.asarray(aa), jnp.asarray(c["w"]),
        jnp.asarray(c["d"]), jnp.asarray(c["z"]), jnp.asarray(c["uid"]),
        jnp.uint32(seed), jnp.float32(0.01), c["V"], n_mh, force="ref")
    return np.asarray(out)


def _torch_mh_args(c, device="cpu"):
    tabs = convert.alias_tables_from_numpy(*c["tabs"], device)
    t = lambda x: _t(x, device)
    return (t(c["phi"]), t(c["psi"]), t(c["tp"]), t(c["ct"]), tabs.wq, tabs.wp, tabs.wa,
            t(c["alpha"]), tabs.ap, tabs.aa, t(c["w"]), t(c["d"]), t(c["z"]),
            t(c["uid"].astype(np.int64)))


def test_alpha_sum_is_exact_in_any_order(jx):
    alpha = _mh_case(20, 130, 8, 64, 130)["alpha"]
    assert float(jx.jnp.sum(jx.jnp.asarray(alpha))) == float(_t(alpha).sum()) \
        == float(np.sum(alpha.astype(np.float64)))


@pytest.mark.parametrize("seed", [42, 0xFFFF_FFFF])
@pytest.mark.parametrize("T,K,n_mh", MH_CASES)
def test_mh_plain_matches_jax_bitwise(jx, T, K, n_mh, seed):
    """Tables carried from JAX give the same draw as JAX's own."""
    c = _mh_case(V=20, K=K, D=8, T=T, cap=K, jx=jx)
    zt = ops.mh_resample(*_torch_mh_args(c), seed, 0.01, 20, n_mh)
    assert zt.dtype == torch.int32
    np.testing.assert_array_equal(zt.numpy(), _jax_mh(jx, c, seed, n_mh))


def test_mh_batch_by_word_is_bitwise_free():
    """The card's stable sort by word and scatter back changes no draw."""
    c = _mh_case(V=20, K=64, D=16, T=400, cap=30)
    args = _torch_mh_args(c)
    off = ops.mh_resample(*args, 5, 0.01, 20, 4)
    order = torch.sort(args[10], stable=True).indices
    perm = list(args)
    for i in (10, 11, 12, 13):
        perm[i] = args[i][order]
    on_sorted = ops.mh_resample(*perm, 5, 0.01, 20, 4)
    on = torch.empty_like(on_sorted)
    on[order] = on_sorted
    assert torch.equal(on, off)


def test_mh_uniform_of_one_stays_in_range(jx):
    """u_draw = 1.0 (a hash whose top 24 bits are all ones) finds no slot in
    the cumulative walk, so the doc proposal falls back to s, and
    jk = min(K, K − 1)."""
    from repro_torch.core import prng
    uid = 12_533_967      # the first uid whose draw-1 uniform at seed 9 is 1.0
    assert float(prng.uniform01(ops.mh_seed(9), torch.tensor([uid]), 1)) == 1.0
    c = _mh_case(V=6, K=16, D=2, T=4, cap=16, jx=jx)
    c["uid"] = np.array([uid] * 4, np.uint32)
    zt = ops.mh_resample(*_torch_mh_args(c), 9, 0.01, 6, 1)
    np.testing.assert_array_equal(zt.numpy(), _jax_mh(jx, c, 9, 1))
    assert ((zt >= 0) & (zt < 16)).all()


def test_mh_marginals_match_exact_categorical():
    """The alias-MH chain's topic marginals match the exact collapsed
    posterior and the Gumbel-max draw within total-variation 0.02."""
    rng = np.random.default_rng(5)
    V, K, T = 6, 12, 40000
    doc = np.zeros(K, np.int32)
    doc[[1, 3, 5, 8, 9]] = [12, 7, 3, 20, 1]
    phi = rng.integers(0, 30, (V, K)).astype(np.int32)
    phi[0, 3] = max(phi[0, 3], 8)
    psi = phi.sum(0).astype(np.int32) + rng.integers(0, 40, K).astype(np.int32)
    nz = np.nonzero(doc)[0]
    tp = np.full((1, K), -1, np.int32)
    ct = np.zeros((1, K), np.int32)
    tp[0, :len(nz)], ct[0, :len(nz)] = nz, doc[nz]
    alpha = _t(rng.uniform(0.1, 0.6, K).astype(np.float32))
    tabs = tsparse.make_tables(_t(phi), _t(psi), alpha, 0.05, V)
    zeros = torch.zeros(T, dtype=torch.int32)
    uid = torch.arange(T, dtype=torch.int64)
    zs = ops.mh_resample(_t(phi), _t(psi), _t(tp), _t(ct), tabs.wq, tabs.wp, tabs.wa,
                         alpha, tabs.ap, tabs.aa, zeros, zeros, zeros + 3, uid, 9,
                         0.05, V, 8)
    emp_mh = np.bincount(zs.numpy(), minlength=K) / T

    ex = np.zeros(K, np.float32)
    ex[3] = 1.0
    p_true = ((phi[0] - ex + 0.05) / (psi - ex + V * 0.05) * (doc - ex + alpha.numpy()))
    p_true = p_true / p_true.sum()
    rows = lambda x: _t(np.broadcast_to(x.astype(np.float32), (T, K)).copy())
    g = gibbs_argmax_ref(rows(phi[0] - ex), rows(psi - ex), rows(doc - ex), alpha,
                         torch.tensor(0.05), uid, 4, V)
    emp_gumbel = np.bincount(g.numpy(), minlength=K) / T
    tv = lambda a, b: 0.5 * np.abs(a - b).sum()
    assert tv(emp_mh, p_true) < 0.02
    assert tv(emp_mh, emp_gumbel) < 0.02


def test_cpu_tensors_use_plain_versions_and_do_not_count():
    before = (ops.build_launches, ops.mh_launches)
    w = _t(_weights(4, 40))
    p, a = ops.build_alias(w)
    p2, a2 = build_alias_ref(*ops._prepare(w))
    assert torch.equal(p, p2) and torch.equal(a, a2)
    c = _mh_case(V=20, K=16, D=8, T=37, cap=16)
    args = _torch_mh_args(c)
    z = ops.mh_resample(*args, 3, 0.01, 20, 2)
    alpha = args[7]
    z2 = mh_resample_ref(*args, ops.mh_seed(3), torch.tensor(0.01), alpha.sum(), 20, 2)
    assert torch.equal(z, z2)
    assert (ops.build_launches, ops.mh_launches) == before


@pytest.mark.parametrize("cap,bound", [(1, 16), (14, 16), (16, 16), (17, 32), (32, 32),
                                       (33, 0), (130, 0)])
def test_mh_slot_bound(cap, bound):
    """Pair rows up to 16 slots take the 16-slot register kernel, up to 32 the
    32-slot one, longer rows the generic kernel (0)."""
    assert mh_slot_bound(cap) == bound


@pytest.mark.parametrize("n_mh", [1, 4])
def test_mh_trace_records_the_chain_without_changing_it(n_mh):
    """``trace`` gets one (s, t, jk, alias-coin rejected) entry a step, the
    last None on doc steps, and the draw is the same as without it; each
    step's state is the draw of the chain cut after the steps before it."""
    c = _mh_case(V=20, K=64, D=16, T=400, cap=30, hollow=5)
    args = _torch_mh_args(c)
    plain = lambda n, trace=None: mh_resample_ref(*args, ops.mh_seed(5), torch.tensor(0.01),
                                                  args[7].sum(), 20, n, trace=trace)
    trace = []
    assert torch.equal(plain(n_mh, trace), plain(n_mh))
    assert len(trace) == n_mh
    for step, (s, t, jk, rejects) in enumerate(trace):
        assert (rejects is None) == (step % 2 == 0)
        assert torch.equal(s.to(torch.int32), plain(step))
        assert ((t >= 0) & (t < 64)).all() and ((jk >= 0) & (jk < 64)).all()


def test_kernel_wrappers_refuse_cpu_tensors():
    w = _t(_weights(2, 8))
    with pytest.raises(ValueError, match="CUDA"):
        alias_build_cuda(w, ops._scale(w))
    c = _mh_case(V=20, K=16, D=8, T=37, cap=16)
    with pytest.raises(ValueError, match="CUDA"):
        mh_resample_cuda(*_torch_mh_args(c), 1, torch.tensor(0.01), torch.tensor(1.0),
                         20, 1)


# ------------------------------------------------------- on the card --------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _cuda_build_check(w, rows=None):
    """The kernel, through ``ops.build_alias`` (one launch), against the plain
    sweep on the same scale, bit for bit; on ``rows`` only when given."""
    scale = ops._scale(w)
    before = ops.build_launches
    pk, ak = ops.build_alias(w)
    torch.cuda.synchronize()
    assert ops.build_launches == before + 1
    if rows is not None:
        pk, ak, w, scale = pk[rows], ak[rows], w[rows], scale[rows]
    pp, ap_ = build_alias_ref(*ops._prepare(w, scale))
    assert torch.equal(pk.view(torch.int32), pp.view(torch.int32)) and torch.equal(ak, ap_)


@pytest.mark.kernels
@pytest.mark.parametrize("R,K", BUILD_SHAPES + [(3, 16), (64, 4096)])
def test_cuda_alias_build_matches_plain(cuda, R, K):
    w = _special_rows(K) if R == 3 and K == 16 else _weights(R, K)
    _cuda_build_check(_t(w, cuda))


@pytest.mark.kernels
@pytest.mark.parametrize("K", [1, 31, 32, 33, 63, 64, 65, 4097])
def test_cuda_alias_build_tile_edges(cuda, K):
    """Edge rows and 37 gamma rows (R = 48, not a multiple of 32)."""
    w = np.concatenate([edge_rows(K), _weights(37, K)])
    _cuda_build_check(_t(w, cuda))


@pytest.mark.kernels
def test_cuda_alias_build_2049_rows_full_k(cuda):
    g = torch.Generator(device=cuda).manual_seed(5)
    counts = torch.randint(1, 50, (2049, 100_000), generator=g, device=cuda)
    counts *= torch.rand(counts.shape, generator=g, device=cuda) < 0.002
    _cuda_build_check((counts.to(torch.float32) + 0.01) / 400.0)


@pytest.mark.kernels
def test_cuda_alias_build_past_2_31_elements(cuda):
    """R·K = 2.15·10⁹ > 2³¹: rows on both sides of element 2³¹ and the last
    one are bit for bit the plain sweep's."""
    R, K = 21_500, 100_000
    g = torch.Generator(device=cuda).manual_seed(9)
    w = torch.rand((R, K), generator=g, device=cuda)
    w *= w > 0.9
    rows = torch.tensor([0, 1, 7_777, 21_474, 21_475, R - 2, R - 1], device=cuda)
    _cuda_build_check(w, rows)


@pytest.mark.kernels
@pytest.mark.parametrize("seed", [0, 0xFFFF_FFFF])
@pytest.mark.parametrize("T,K,n_mh,cap", [(37, 16, 1, 16), (300, 16, 5, 16),
                                           (64, 130, 4, 130), (4000, 512, 4, 20)])
def test_cuda_mh_resample_matches_plain(cuda, T, K, n_mh, cap, seed):
    c = _mh_case(V=20, K=K, D=max(8, -(-T // cap)), T=T, cap=cap)
    args = _torch_mh_args(c, cuda)
    before = ops.mh_launches
    zk = ops.mh_resample(*args, seed, 0.01, 20, n_mh)
    torch.cuda.synchronize()
    assert ops.mh_launches == before + 1
    zp = mh_resample_ref(*args, ops.mh_seed(seed), torch.tensor(0.01, device=cuda),
                         args[7].sum(), 20, n_mh)
    assert torch.equal(zk, zp)


@pytest.mark.kernels
@pytest.mark.parametrize("n_mh", [1, 3, 4])
@pytest.mark.parametrize("cap", [1, 14, 16, 17, 32, 33])
def test_cuda_mh_resample_slot_bounds(cuda, cap, n_mh):
    """Caps on both sides of the register kernel's slot bounds (16, 32) and
    past them (the generic kernel), odd and even n_mh, and tokens whose doc
    rows hold zero counts (every fifth doc's tokens are left out of the
    pairs): bit for bit with the plain version."""
    T, K = 3000, 256
    c = _mh_case(V=40, K=K, D=max(8, -(-T // cap)), T=T, cap=cap, seed=cap, hollow=5)
    args = _torch_mh_args(c, cuda)
    assert bool((args[3].sum(dim=1) == 0).any())
    for seed in (1, 0xFFFF_FFFF):
        zk = ops.mh_resample(*args, seed, 0.01, 40, n_mh)
        zp = mh_resample_ref(*args, ops.mh_seed(seed), torch.tensor(0.01, device=cuda),
                             args[7].sum(), 40, n_mh)
        assert torch.equal(zk, zp)
