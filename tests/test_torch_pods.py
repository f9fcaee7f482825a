"""The port's pods (2 pods × a 2×2 ring: 8 ranks, gloo over CPU processes)
against the JAX package's ``make_pod_ring_epoch`` + ``run_hierarchical`` on
8 XLA host devices: 9 epochs, a merge every 3, with the exact aggregate, the
compressed one (int8 payload, stochastic rounding; the port cuts its f32
temporaries into chunks of 64 elements, so the counters' offsets are
exercised) and the elastic one (pod 1 dead at the first boundary, pod 0 at
the third). Φ, Ψ, the stacks and z must equal JAX's bit for bit, and the
pods must agree after the last merge."""
import numpy as np
import pytest

import _torch_ranks as R
from _torch_port import one_torch_thread as _one_torch_thread  # noqa: F401  (autouse)
from repro_torch.core import distributed as tdist
from repro_torch.data import corpus as tcorpus, synthetic as tsynthetic
from repro_torch.dist.sharding import RankLayout
from repro_torch.launch import mesh

pytestmark = pytest.mark.port

PODS, D, MP, K, V, EPOCHS, AGG = 2, 2, 2, 12, 200, 9, 3
M = D * MP
SCHEDULE = {2: [1, 0], 5: [1, 1], 8: [0, 1]}
MODES = ("exact", "compressed", "elastic")

JAX_CODE = r"""
import numpy as np, jax, jax.numpy as jnp
from repro.core import distributed as dist, hierarchy
from repro.data import synthetic, corpus as corpus_mod
corpus, _ = synthetic.lda_corpus(seed=0, n_docs=300, n_topics=10, vocab_size=%(V)d,
                                 doc_len_mean=10)
mesh = jax.make_mesh((%(PODS)d, %(D)d, %(MP)d), ("pod", "data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 3)
M, K = %(M)d, %(K)d
scs = corpus_mod.shard_corpus_pods(corpus, %(PODS)d, M, M, K, seed=1)
schedule = {k: np.array(v) for k, v in %(SCHEDULE)r.items()}
out = {}
for mode in %(MODES)r:
    st = hierarchy.init_pod_state(scs, K)
    cap = st[2].shape[3]
    cfg = dist.RingConfig(n_topics=K, vocab_size=corpus.vocab_size,
                          rows_per_shard=scs[0].rows_per_shard,
                          docs_per_shard=scs[0].docs_per_shard, cap=cap,
                          package_len=cap // 2, n_rounds=M)
    epoch = hierarchy.make_pod_ring_epoch(mesh, cfg)
    if mode == "elastic":
        agg, live = hierarchy.make_elastic_aggregate(mesh), (lambda ep: schedule[ep])
    else:
        agg, live = hierarchy.make_aggregate(mesh, compressed=mode == "compressed"), None
    alpha, beta = jnp.full((K,), 50.0 / K, jnp.float32), jnp.float32(0.01)
    st = hierarchy.run_hierarchical(epoch, agg, st, alpha, beta, n_epochs=%(EPOCHS)d,
                                    agg_every=%(AGG)d, seed0=11, liveness=live)
    for name, x in zip(("phi", "psi", "wl", "dl", "uid", "z"), st):
        out[mode + "/" + name] = np.asarray(x)
    if mode == "elastic":
        out["elastic/n_live"] = np.asarray(agg.last_n_live)
np.savez(OUT, **out)
"""


@pytest.fixture(scope="module")
def runs():
    from conftest import run_with_devices

    corpus, _ = tsynthetic.lda_corpus(seed=0, n_docs=300, n_topics=10, vocab_size=V,
                                      doc_len_mean=10)
    scs = tcorpus.shard_corpus_pods(corpus, PODS, M, M, K, seed=1)
    cap = scs[0].word_local.shape[2]
    cfg = tdist.RingConfig(n_topics=K, vocab_size=V, rows_per_shard=scs[0].rows_per_shard,
                           docs_per_shard=scs[0].docs_per_shard, cap=cap,
                           package_len=cap // 2, n_rounds=M)
    views = mesh.spawn(R.pod_body, pods=PODS, data=D, model=MP, device="cpu",
                       args=(scs, cfg, EPOCHS, AGG, MODES), kwargs=dict(schedule=SCHEDULE),
                       threads=1, timeout_s=R.TIMEOUT_S)
    layout = RankLayout(PODS, D, MP)
    port = {mode: (R.assemble_state([v[mode][0] for v in views], cfg, layout, pod_axis=True),
                   [v[mode][1] for v in views]) for mode in MODES}
    jax = R.jax_run(run_with_devices, JAX_CODE % dict(
        V=V, PODS=PODS, D=D, MP=MP, M=M, K=K, EPOCHS=EPOCHS, AGG=AGG, SCHEDULE=SCHEDULE,
        MODES=MODES), n_devices=PODS * M)
    return corpus, port, jax


@pytest.mark.parametrize("mode", MODES)
def test_pods_match_jax(runs, mode):
    corpus, port, jax = runs
    state, n_live = port[mode]
    for i, name in enumerate(("phi", "psi", "wl", "dl", "uid", "z")):
        got, want = state[i], jax[f"{mode}/{name}"]
        if name == "uid":
            got = got.astype(np.uint32)
        assert got.shape == want.shape, (name, got.shape, want.shape)
        np.testing.assert_array_equal(got, want, err_msg=f"{mode}: {name}")
    phi, psi = state[0], state[1]
    assert (phi[0] == phi[1]).all() and (psi[0] == psi[1]).all(), "pods disagree"
    if mode == "elastic":
        assert set(n_live) == {1} and int(jax["elastic/n_live"]) == 1
    if mode == "exact":
        # exact merges keep Ψ the token count and ΣΦ = Ψ
        assert int(psi[0].sum()) == corpus.n_tokens
        assert (phi[0].sum(axis=(0, 1)) == psi[0]).all()
