"""The port's dense ring on one device against the JAX package's
``make_ring_epoch`` on a 1×1 mesh, for each knob setting of ``RingConfig``.

Both sides start from the same sharded corpus and the same seeds, and run
three epochs on their own; z, Φ and Ψ must then be equal bit for bit (a
difference would be allowed only at a near-tie of the Gumbel-max scores, and
is logged). With ``column_exclusion`` the port folds ψ's self-exclusion into
Φ's z column, the form of JAX's kernel branch (``use_kernel=True``, run here
with the Pallas kernel in interpret mode); the tokens on which JAX's plain
branch (a log difference) draws otherwise are logged.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import one_torch_thread as _one_torch_thread  # noqa: F401  (autouse)
from repro.core import distributed as jdist
from repro.data import corpus as jcorpus, synthetic as jsynthetic
from repro.kernels.gibbs import ops as jgibbs_ops
from repro_torch.configs import peacock_lda as tpl
from repro_torch.core import distributed as tdist, lda as tlda

pytestmark = pytest.mark.port

V, K, EPOCHS = 300, 32, 3


@pytest.fixture(scope="module")
def sharded():
    c, _ = jsynthetic.lda_corpus(seed=0, n_docs=400, n_topics=12, vocab_size=V,
                                 doc_len_mean=6)
    return c, jcorpus.shard_corpus(c, 1, 1, K, seed=1)


def _kw(sc, package_div=1):
    cap = sc.word_local.shape[2]
    return dict(n_topics=K, vocab_size=V, rows_per_shard=sc.rows_per_shard,
                docs_per_shard=sc.docs_per_shard, cap=cap, package_len=cap // package_div,
                n_rounds=1)


def _jax_epochs(sc, jcfg, epochs=EPOCHS):
    mesh = jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    epoch = jdist.make_ring_epoch(mesh, jcfg)
    st = jdist.device_arrays(sc, K)
    alpha = jnp.full((K,), 50.0 / K, jnp.float32)
    for ep in range(epochs):
        st = epoch(*st, alpha, jnp.float32(0.01), jnp.uint32(ep * 977 + 3))
    return [np.asarray(x) for x in st]


def _torch_epochs(sc, tcfg, epochs=EPOCHS):
    epoch = tdist.build_epoch_body(tcfg)
    st = tdist.device_arrays(sc, K, device="cpu")
    alpha = torch.full((K,), 50.0 / K)
    for ep in range(epochs):
        st = epoch(*st, alpha, torch.tensor(0.01), ep * 977 + 3)
    return st


def _check(sc, corpus, ts, js, label):
    for name, i in (("phi", 0), ("psi", 1), ("z", 5)):
        diff = int((ts[i].numpy() != js[i]).sum())
        if diff:
            print(f"[{label}] {name}: {diff} entries differ from JAX")
        np.testing.assert_array_equal(ts[i].numpy(), js[i], err_msg=f"{label}: {name}")
    phi, psi, wl, _, _, z = ts
    valid = wl >= 0
    rebuilt, _ = tlda.build_counts(wl[valid], z[valid], K, sc.rows_per_shard)
    assert torch.equal(rebuilt, phi[0]), "Φ is not the counts of the travelling z"
    assert int(psi.sum()) == corpus.n_tokens
    assert torch.equal(phi.sum(dim=(0, 1)), psi)


KNOBS = {
    "default, one package": (1, {}, {}),
    "default, two packages": (2, {}, {}),
    "small_theta": (2, dict(small_theta=True), dict(small_theta=True)),
    "theta int8": (1, dict(theta_dtype=jnp.int8), dict(theta_dtype=torch.int8)),
    "optimized": (2, dict(theta_dtype=jnp.int8, column_exclusion=True, small_theta=True,
                          use_kernel=True),
                  dict(theta_dtype=torch.int8, column_exclusion=True, small_theta=True)),
    "column_exclusion": (1, dict(column_exclusion=True, use_kernel=True),
                         dict(column_exclusion=True)),
}


@pytest.mark.parametrize("label", list(KNOBS))
def test_dense_ring_epochs_match_jax(sharded, monkeypatch, label):
    corpus, sc = sharded
    div, jknobs, tknobs = KNOBS[label]
    if jknobs.get("use_kernel"):
        # JAX's kernel branch hard-codes force="pallas": run it in interpret mode
        monkeypatch.setattr(jgibbs_ops, "gibbs_argmax_pallas",
                            functools.partial(jgibbs_ops.gibbs_argmax_pallas, interpret=True))
    js = _jax_epochs(sc, jdist.RingConfig(**_kw(sc, div), **jknobs))
    ts = _torch_epochs(sc, tdist.RingConfig(**_kw(sc, div), **tknobs))
    _check(sc, corpus, ts, js, label)
    if jknobs.get("column_exclusion"):
        plain = _jax_epochs(sc, jdist.RingConfig(**_kw(sc, div), **{
            **jknobs, "use_kernel": False}))
        print(f"[{label}] JAX's plain branch (log difference) differs from the kernel "
              f"form at {int((plain[5] != js[5]).sum())} of {corpus.n_tokens} tokens")


def test_int8_theta_wraps_like_jax():
    """A doc with 130 tokens of one topic: its Θ entry wraps in int8 on both
    sides (the ring's Θ is transient, rebuilt from z every round)."""
    z = np.zeros(130, np.int32)
    d = np.zeros(130, np.int32)
    valid = np.ones(130, bool)
    cfg = tdist.RingConfig(n_topics=4, vocab_size=10, rows_per_shard=10, docs_per_shard=2,
                           cap=130, package_len=130, theta_dtype=torch.int8)
    theta, _ = tdist._rebuild_theta(torch.from_numpy(d), torch.from_numpy(z),
                                    torch.from_numpy(valid), torch.from_numpy(d), cfg)
    jtheta = jnp.zeros((2, 4), jnp.int8).at[d, z].add(jnp.asarray(valid).astype(jnp.int8))
    np.testing.assert_array_equal(theta.numpy(), np.asarray(jtheta))
    assert int(theta[0, 0]) == 130 - 256


def test_ring_config_geometry():
    """The port's mesh-free ring_config has the JAX package's cap arithmetic."""
    from repro.configs import peacock_lda as jpl

    for M in (1, 4, 256):
        mesh = jax.make_mesh((1, 1), ("data", "model"),
                             axis_types=(jax.sharding.AxisType.Auto,) * 2)
        if M == 1:
            j = jpl.ring_config(mesh)
            assert (j.rows_per_shard, j.cap) == (tpl.ring_config(1).rows_per_shard,
                                                 tpl.ring_config(1).cap)
        t = tpl.ring_config(M)
        assert t.rows_per_shard == -(-tpl.VOCAB // M)
        assert t.cap == max(8, int(np.ceil(tpl.DOCS_PER_SHARD * tpl.TOKENS_PER_DOC / M / 8) * 8))
    opt = tpl.ring_config(1, optimized=True)
    assert (opt.theta_dtype, opt.column_exclusion, opt.small_theta) == (torch.int8, True, True)
    assert tpl.ring_config(1).theta_dtype == torch.int32
    assert (tpl.K_TOPICS, tpl.VOCAB, tpl.DOCS_PER_SHARD, tpl.TOKENS_PER_DOC) == (
        jpl.K_TOPICS, jpl.VOCAB, jpl.DOCS_PER_SHARD, jpl.TOKENS_PER_DOC)
    assert tpl.TRAIN_DEFAULTS == jpl.TRAIN_DEFAULTS


def test_dense_epoch_builder_refuses_what_is_not_ported(sharded):
    _, sc = sharded
    # a ring of several ranks, or model slices, need the rank's RankLayout
    for bad in (dict(n_rounds=2), dict(model_shards=2)):
        with pytest.raises(ValueError, match="RankLayout"):
            tdist.build_epoch_body(tdist.RingConfig(**{**_kw(sc), **bad}))
    with pytest.raises(ValueError, match="package_len"):
        tdist.build_epoch_body(tdist.RingConfig(**{**_kw(sc), "package_len": 7}))
    st = tdist.device_arrays(sc, K, device="cpu")
    epoch = tdist.build_epoch_body(tdist.RingConfig(**_kw(sc)))
    with pytest.raises(TypeError):                 # the dense epoch takes no tables
        epoch(*st, torch.full((K,), 1.0), torch.tensor(0.01), 3, *st[:5])
