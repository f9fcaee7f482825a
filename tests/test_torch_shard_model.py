"""Word-sharded model parallelism in the port (``model_shards = P > 1``:
the ring rotates over "data", each "model" rank holds rows/P of its coarse
Φ shard), gloo over CPU processes.

P = 2 and P = 4 on a 2-rank data ring (4 and 8 ranks) run 3 epochs of the
dense and the alias ring and must equal the JAX package's word-sharded ring
on XLA host devices bit for bit in JAX's global layout (Φ, Ψ, stacks, z),
and the port's own replicated ring (P = 1) in the model: Φ by word, Ψ and z
by token uid. Then the resharding algebra of ``training/reshard.py`` against
JAX's on the same arrays, and the bucket-major layout of ``shard_corpus``.
"""
import numpy as np
import pytest

import _torch_ranks as R
from _torch_port import one_torch_thread as _one_torch_thread  # noqa: F401  (autouse)
from repro_torch.core import distributed as tdist, sparse as tsparse
from repro_torch.data import corpus as tcorpus, synthetic as tsynthetic
from repro_torch.dist.sharding import RankLayout
from repro_torch.launch import mesh
from repro_torch.training import reshard as treshard

pytestmark = pytest.mark.port

D, K, V, EPOCHS = 2, 12, 180, 3
SAMPLERS = ("dense", "alias")

JAX_CODE = r"""
import numpy as np, jax, jax.numpy as jnp
from repro.core import distributed as dist, sparse
from repro.data import synthetic, corpus as corpus_mod
corpus, _ = synthetic.lda_corpus(seed=0, n_docs=240, n_topics=10, vocab_size=%(V)d,
                                 doc_len_mean=11)
D, K = %(D)d, %(K)d
out = {}
for P in (2, 4):
    sc = corpus_mod.shard_corpus(corpus, D, D, K, seed=1, n_model_shards=P)
    mesh = jax.make_mesh((D, P), ("data", "model"), devices=jax.devices()[:D * P],
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    cap = sc.word_local.shape[2]
    for sampler in ("dense", "alias"):
        cfg = dist.RingConfig(n_topics=K, vocab_size=corpus.vocab_size,
                              rows_per_shard=sc.rows_per_shard,
                              docs_per_shard=sc.docs_per_shard, cap=cap, package_len=cap,
                              n_rounds=D, model_shards=P, sampler=sampler, n_mh=4,
                              doc_topic_cap=sparse.suggest_cap(corpus.doc_lengths(), K))
        epoch = dist.make_ring_epoch(mesh, cfg)
        st = dist.device_arrays(sc, K)
        alpha, beta = jnp.full((K,), 50.0 / K, jnp.float32), jnp.float32(0.01)
        tabs = ()
        if sampler == "alias":
            tabs = tuple(sparse.make_word_tables(st[0], st[1], beta, corpus.vocab_size)) + \
                tuple(sparse.make_alpha_table(alpha))
        for ep in range(%(EPOCHS)d):
            st = epoch(*st, alpha, beta, jnp.uint32(ep * 977 + 3), *tabs)
        for name, x in zip(("phi", "psi", "wl", "dl", "uid", "z"), st):
            out[f"{P}/{sampler}/{name}"] = np.asarray(x)
np.savez(OUT, **out)
"""


def _cfgs(corpus, sc, P):
    cap = sc.word_local.shape[2]
    return {s: tdist.RingConfig(
        n_topics=K, vocab_size=V, rows_per_shard=sc.rows_per_shard,
        docs_per_shard=sc.docs_per_shard, cap=cap, package_len=cap, n_rounds=D,
        model_shards=P, sampler=s, n_mh=4,
        doc_topic_cap=tsparse.suggest_cap(corpus.doc_lengths(), K)) for s in SAMPLERS}


@pytest.fixture(scope="module")
def runs():
    from conftest import run_with_devices

    corpus, _ = tsynthetic.lda_corpus(seed=0, n_docs=240, n_topics=10, vocab_size=V,
                                      doc_len_mean=11)
    port = {}
    for P in (1, 2, 4):
        sc = tcorpus.shard_corpus(corpus, D, D, K, seed=1, n_model_shards=P)
        cfgs = _cfgs(corpus, sc, P)
        views = mesh.spawn(R.ring_forms, data=D, model=P, device="cpu",
                           args=([sc], cfgs, EPOCHS), threads=1, timeout_s=R.TIMEOUT_S)
        layout = RankLayout(1, D, P)
        port[P] = (sc, {s: R.assemble_state([v[s] for v in views], cfgs[s], layout)
                        for s in SAMPLERS})
    jax = R.jax_run(run_with_devices, JAX_CODE % dict(V=V, D=D, K=K, EPOCHS=EPOCHS),
                    n_devices=8)
    return corpus, port, jax


def _model(sc, state, n_tokens):
    phi, psi, wl, _, uid, z = state
    return (tdist.gather_phi(__import__("torch").from_numpy(phi), sc).numpy(), psi,
            R.z_by_uid(wl, uid, z, n_tokens))


@pytest.mark.parametrize("P", [2, 4])
@pytest.mark.parametrize("sampler", SAMPLERS)
def test_word_sharded_ring_matches_jax_and_the_replicated_ring(runs, P, sampler):
    corpus, port, jax = runs
    sc, states = port[P]
    state = states[sampler]
    for i, name in enumerate(("phi", "psi", "wl", "dl", "uid", "z")):
        got, want = state[i], jax[f"{P}/{sampler}/{name}"]
        if name == "uid":
            got = got.astype(np.uint32)
        assert got.shape == want.shape, (name, got.shape, want.shape)
        np.testing.assert_array_equal(got, want, err_msg=f"P={P} {sampler}: {name}")
    sc1, states1 = port[1]
    for a, b, name in zip(_model(sc, state, corpus.n_tokens),
                          _model(sc1, states1[sampler], corpus.n_tokens), ("phi", "psi", "z")):
        np.testing.assert_array_equal(a, b, err_msg=f"P={P} {sampler} vs P=1: {name}")


def test_reshard_algebra_matches_jax():
    from repro.training import reshard as jreshard

    rng = np.random.default_rng(0)
    rows_coarse = 23
    for p_a, p_b in [(1, 2), (2, 4), (4, 3), (1, 8)]:
        rows_a = p_a * (-(-rows_coarse // p_a))
        rows_b = p_b * (-(-rows_coarse // p_b))
        arr = rng.integers(0, 100, (4, rows_a, 6)).astype(np.int32)
        ga, gb = treshard.row_permutation(rows_coarse, p_a, rows_a, p_b, rows_b)
        ja, jb = jreshard.row_permutation(rows_coarse, p_a, rows_a, p_b, rows_b)
        assert (ga == ja).all() and (gb == jb).all()
        mask = np.zeros(rows_a, bool)
        mask[ga] = True
        arr[:, ~mask, :] = 0
        fwd = treshard.permute_rows(arr, ga, gb, rows_b)
        np.testing.assert_array_equal(fwd, jreshard.permute_rows(arr, ga, gb, rows_b))
        back = treshard.permute_rows(fwd, *treshard.row_permutation(
            rows_coarse, p_b, rows_b, p_a, rows_a), rows_a)
        np.testing.assert_array_equal(back, arr, err_msg=f"{p_a} -> {p_b} -> {p_a}")


@pytest.mark.parametrize("p_old,p_new", [(1, 2), (2, 1), (2, 4)])
def test_reshard_checkpoint_matches_jax(runs, p_old, p_new):
    """A checkpoint tree of the P = p_old ring (state after 3 epochs, refs,
    tables) resharded to p_new: the port's and JAX's trees are equal."""
    from repro.data import corpus as jcorpus, synthetic as jsynthetic
    from repro.training import reshard as jreshard

    corpus, port, _ = runs
    sc_old, states = port[p_old]
    phi, psi, wl, dl, uid, z = states["dense"]
    tree = {"state": (phi, psi, wl, dl, uid.astype(np.uint32), z), "alpha": np.ones(K, np.float32),
            "tables": (phi.astype(np.float32), phi.astype(np.float32) + 1, phi + 2,
                       np.ones(K, np.float32), np.arange(K, dtype=np.int32)),
            "refs": (phi + 3, psi)}
    sc_new = port[p_new][0]
    jc, _ = jsynthetic.lda_corpus(seed=0, n_docs=240, n_topics=10, vocab_size=V,
                                  doc_len_mean=11)
    jsc = jcorpus.shard_corpus(jc, D, D, K, seed=1, n_model_shards=p_new)
    got = treshard.reshard_checkpoint(tree, p_old, p_new, [sc_new])
    want = jreshard.reshard_checkpoint(tree, p_old, p_new, [jsc])
    for key in ("state", "tables", "refs"):
        for i, (a, b) in enumerate(zip(got[key], want[key])):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=f"{key}[{i}]")
    # the resharded state is the P = p_new ring's model after the same epochs
    sc, states_new = port[p_new]
    for a, b, name in zip(_model(sc, got["state"], corpus.n_tokens),
                          _model(sc, states_new["dense"], corpus.n_tokens), ("phi", "psi", "z")):
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_bucket_layout_matches_jax():
    from repro.data import corpus as jcorpus, synthetic as jsynthetic

    jc, _ = jsynthetic.lda_corpus(seed=3, n_docs=120, n_topics=6, vocab_size=90, doc_len_mean=9)
    tc, _ = tsynthetic.lda_corpus(seed=3, n_docs=120, n_topics=6, vocab_size=90, doc_len_mean=9)
    for P in (1, 3):
        a = tcorpus.shard_corpus(tc, 2, 2, 8, seed=5, n_model_shards=P)
        b = jcorpus.shard_corpus(jc, 2, 2, 8, seed=5, n_model_shards=P)
        for name in ("word_local", "doc_local", "uid", "z0", "shard_of_word", "local_of_word"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name), err_msg=name)
        assert (a.rows_per_shard, a.rows_coarse, a.n_model_shards) == (
            b.rows_per_shard, b.rows_coarse, b.n_model_shards)
    pods_t = tcorpus.shard_corpus_pods(tc, 2, 2, 2, 8, seed=1, n_model_shards=2)
    pods_j = jcorpus.shard_corpus_pods(jc, 2, 2, 2, 8, seed=1, n_model_shards=2)
    for a, b in zip(pods_t, pods_j):
        for name in ("word_local", "doc_local", "uid", "z0"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name), err_msg=name)


@pytest.mark.parametrize("P", [1, 2])
def test_rank_tables_equal_jax_per_shard_tables(P):
    """Each rank's alias word tables, built from its own Φ rows, are the block
    that rank holds of the tables built over the global Φ on one device, bit
    for bit (the tables are per row), and of JAX's ``make_word_tables``: wq
    and the alias indices bit for bit, the probabilities within 1e-5. JAX
    and torch round a row's f32 total differently (the one-device port's
    tables differ from JAX's the same way; its ring tests hand JAX's tables
    over), which moves a probability by a few ulps of the sweep's running
    residual."""
    import jax.numpy as jnp
    import torch

    from repro.core import distributed as jdist, sparse as jsparse
    from repro.data import corpus as jcorpus, synthetic as jsynthetic
    from repro_torch.dist import sharding as shd

    jc, _ = jsynthetic.lda_corpus(seed=0, n_docs=240, n_topics=10, vocab_size=V, doc_len_mean=11)
    tc, _ = tsynthetic.lda_corpus(seed=0, n_docs=240, n_topics=10, vocab_size=V, doc_len_mean=11)
    jsc = jcorpus.shard_corpus(jc, D, D, K, seed=1, n_model_shards=P)
    tsc = tcorpus.shard_corpus(tc, D, D, K, seed=1, n_model_shards=P)
    jphi, jpsi = jdist.device_arrays(jsc, K)[:2]
    jax_tabs = [np.asarray(x) for x in jsparse.make_word_tables(jphi, jpsi, jnp.float32(0.01), V)]
    phi, psi = tdist.device_arrays(tsc, K, device="cpu")[:2]
    one_device = [x.numpy() for x in tsparse.make_word_tables(phi, psi, torch.tensor(0.01), V)]
    layout = RankLayout(1, D, P)
    spec = tdist.specs(P)["tables"]
    for r in range(layout.world_size):
        st = tdist.rank_arrays([tsc], K, layout.at(r), device="cpu")
        got = tsparse.make_word_tables(st[0], st[1], torch.tensor(0.01), V)
        for name, a, b, c in zip(("wq", "wp", "wa"), got, one_device, jax_tabs):
            block = lambda x: shd.local_view(x, spec, layout, rank=r)
            np.testing.assert_array_equal(a.numpy(), block(b), err_msg=f"rank {r}: {name}")
            if name == "wp":
                np.testing.assert_allclose(a.numpy(), block(c), rtol=0, atol=1e-5,
                                           err_msg=f"rank {r}: wp against JAX")
            else:
                np.testing.assert_array_equal(a.numpy(), block(c),
                                              err_msg=f"rank {r}: {name} against JAX")
