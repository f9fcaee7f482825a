"""The port's coordinator loop ``run_hierarchical`` against the JAX package's,
driving each package's dense ring on one device: the ``on_epoch_end`` α
replacement, and a toy ``agg_fn`` at ``agg_every = 2`` with its refs, seeds
and ``on_aggregate`` events. The states must be equal bit for bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import one_torch_thread as _one_torch_thread  # noqa: F401  (autouse)
from repro.core import distributed as jdist, hierarchy as jhier
from repro.data import corpus as jcorpus, synthetic as jsynthetic
from repro_torch.core import distributed as tdist, hierarchy as thier

pytestmark = pytest.mark.port

V, K, EPOCHS, SEED0 = 200, 16, 5, 11


@pytest.fixture(scope="module")
def ring():
    c, _ = jsynthetic.lda_corpus(seed=1, n_docs=250, n_topics=8, vocab_size=V,
                                 doc_len_mean=6)
    sc = jcorpus.shard_corpus(c, 1, 1, K, seed=1)
    cap = sc.word_local.shape[2]
    kw = dict(n_topics=K, vocab_size=V, rows_per_shard=sc.rows_per_shard,
              docs_per_shard=sc.docs_per_shard, cap=cap, package_len=cap, n_rounds=1)
    return sc, kw


def _run(ring, side, with_agg):
    """One run_hierarchical on ``side`` ("jax" or "port"); returns the final
    state as numpy and the log of events."""
    sc, kw = ring
    events = []
    if side == "jax":
        mesh = jax.make_mesh((1, 1), ("data", "model"),
                             axis_types=(jax.sharding.AxisType.Auto,) * 2)
        inner = jdist.make_ring_epoch(mesh, jdist.RingConfig(**kw))
        state = jdist.device_arrays(sc, K)
        alpha, beta = jnp.full((K,), 50.0 / K, jnp.float32), jnp.float32(0.01)
        run, xp = jhier.run_hierarchical, jnp
    else:
        inner = tdist.build_epoch_body(tdist.RingConfig(**kw))
        state = tdist.device_arrays(sc, K, device="cpu")
        alpha, beta = torch.full((K,), 50.0 / K), torch.tensor(0.01)
        run, xp = thier.run_hierarchical, torch

    def epoch(*args):
        events.append(("epoch", int(args[8])))
        return inner(*args)

    def agg(phi, psi, phi_ref, psi_ref, seed):
        # a toy merge that reads both the live state and the refs
        events.append(("agg", int(seed), int(phi_ref.sum()), int(psi_ref.sum())))
        return xp.maximum(phi, phi_ref), xp.maximum(psi, psi_ref)

    def on_aggregate(ep, st):
        events.append(("on_aggregate", ep, int(st[0].sum())))

    def on_epoch_end(ep, st, a):
        events.append(("on_epoch_end", ep, float(a.sum())))
        return a * 1.25 if ep in (1, 3) else None

    out = run(epoch, agg if with_agg else None, state, alpha, beta, EPOCHS,
              agg_every=2, seed0=SEED0, on_epoch_end=on_epoch_end,
              on_aggregate=on_aggregate)
    return [np.asarray(x) for x in out], events


@pytest.mark.parametrize("with_agg", [False, True], ids=["no agg_fn", "toy agg_fn"])
def test_run_hierarchical_matches_jax(ring, with_agg):
    js, jev = _run(ring, "jax", with_agg)
    ts, tev = _run(ring, "port", with_agg)
    assert tev == jev
    assert [e[1] for e in tev if e[0] == "epoch"] == [SEED0 + ep for ep in range(EPOCHS)]
    assert sum(e[0] == "agg" for e in tev) == (EPOCHS // 2 if with_agg else 0)
    for name, i in (("phi", 0), ("psi", 1), ("z", 5)):
        np.testing.assert_array_equal(ts[i], js[i], err_msg=name)


def test_run_hierarchical_seeds_resume_and_refusals():
    seen = []

    def epoch(phi, psi, wl, dl, uid, z, alpha, beta, seed, *aux):
        seen.append((seed, aux))
        return phi + 1, psi, wl, dl, uid, z

    st = tuple(torch.zeros(2, dtype=torch.int32) for _ in range(6))
    out = thier.run_hierarchical(epoch, None, st, torch.ones(2), torch.tensor(0.01), 4, 2,
                                 seed0=2 ** 32 - 2, start_epoch=1,
                                 epoch_aux=lambda: ("tables",))
    # (seed0 + ep) mod 2³², from the resumed epoch on
    assert seen == [(2 ** 32 - 1, ("tables",)), (0, ("tables",)), (1, ("tables",))]
    assert out[0].tolist() == [3, 3]
    # refs given on resume are the merge's baseline; the boundary clones them
    got = []
    thier.run_hierarchical(epoch, lambda p, s, pr, sr, seed: (got.append(int(pr[0])) or (p, s)),
                           st, torch.ones(2), torch.tensor(0.01), 4, 2, start_epoch=1,
                           refs=(torch.full((2,), 7, dtype=torch.int32), st[1]))
    assert got == [7, 1]
    with pytest.raises(NotImplementedError, match="stream"):
        thier.run_hierarchical(epoch, None, st[:2], torch.ones(2), torch.tensor(0.01), 1, 1,
                               segments=object())
