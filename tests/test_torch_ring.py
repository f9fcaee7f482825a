"""The port's ring of M = 8 ranks (a 4×2 mesh, gloo over CPU processes)
against the JAX package's ``make_ring_epoch`` on 8 XLA host devices.

Both sides shard the same seeded corpus and run 3 epochs; the ranks' views,
assembled into JAX's global layout, must equal JAX's Φ, Ψ, stacks and z bit
for bit, for the dense ring in its default, ``column_exclusion``,
``small_theta`` and int8-Θ forms and for the alias ring (JAX's alias
kernels through their plain references). With ``column_exclusion`` the port
takes the JAX kernel branch's form, so JAX runs that branch with its Pallas
kernel in interpret mode. Plus the invariants of the ring: Φ is the counts of
the travelling z, ΣΦ = Ψ, ΣΨ = tokens.
"""
import numpy as np
import pytest
import torch

import _torch_ranks as R
from _torch_port import one_torch_thread as _one_torch_thread  # noqa: F401  (autouse)
from repro_torch.core import distributed as tdist
from repro_torch.data import corpus as tcorpus, synthetic as tsynthetic
from repro_torch.dist.sharding import RankLayout
from repro_torch.launch import mesh

pytestmark = pytest.mark.port

D, MP, K, V, EPOCHS = 4, 2, 16, 300, 3
M = D * MP
# label: (JAX RingConfig knobs as source, port knobs)
FORMS = {
    "default": ("{}", {}),
    "column_exclusion": ("dict(column_exclusion=True, use_kernel=True)",
                         dict(column_exclusion=True)),
    "small_theta": ("dict(small_theta=True)", dict(small_theta=True)),
    "theta_int8": ("dict(theta_dtype=jnp.int8)", dict(theta_dtype=torch.int8)),
    "alias": ("dict(sampler='alias', n_mh=4, doc_topic_cap=DOC_CAP)", dict(sampler="alias", n_mh=4)),
}

JAX_CODE = r"""
import functools
import numpy as np, jax, jax.numpy as jnp
from repro.core import distributed as dist, sparse
from repro.data import synthetic, corpus as corpus_mod
from repro.kernels.gibbs import ops as gops
gops.gibbs_argmax_pallas = functools.partial(gops.gibbs_argmax_pallas, interpret=True)
corpus, _ = synthetic.lda_corpus(seed=0, n_docs=400, n_topics=12, vocab_size=%(V)d,
                                 doc_len_mean=12)
mesh = jax.make_mesh((%(D)d, %(MP)d), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
M, K = %(M)d, %(K)d
sc = corpus_mod.shard_corpus(corpus, M, M, K, seed=1)
cap = sc.word_local.shape[2]
DOC_CAP = sparse.suggest_cap(corpus.doc_lengths(), K)
out = {}
for label, knobs in %(FORMS)s.items():
    alias = knobs.get("sampler") == "alias"
    cfg = dist.RingConfig(n_topics=K, vocab_size=corpus.vocab_size,
                          rows_per_shard=sc.rows_per_shard, docs_per_shard=sc.docs_per_shard,
                          cap=cap, package_len=cap if alias else cap // 2, n_rounds=M, **knobs)
    epoch = dist.make_ring_epoch(mesh, cfg)
    st = dist.device_arrays(sc, K)
    alpha, beta = jnp.full((K,), 50.0 / K, jnp.float32), jnp.float32(0.01)
    tabs = ()
    if alias:
        tabs = tuple(sparse.make_word_tables(st[0], st[1], beta, corpus.vocab_size)) + \
            tuple(sparse.make_alpha_table(alpha))
    for ep in range(%(EPOCHS)d):
        st = epoch(*st, alpha, beta, jnp.uint32(ep * 977 + 3), *tabs)
    for name, x in zip(("phi", "psi", "wl", "dl", "uid", "z"), st):
        out[label + "/" + name] = np.asarray(x)
np.savez(OUT, **out)
"""


@pytest.fixture(scope="module")
def runs(request):
    from conftest import run_with_devices

    corpus, _ = tsynthetic.lda_corpus(seed=0, n_docs=400, n_topics=12, vocab_size=V,
                                      doc_len_mean=12)
    sc = tcorpus.shard_corpus(corpus, M, M, K, seed=1)
    cap = sc.word_local.shape[2]
    from repro_torch.core import sparse

    doc_cap = sparse.suggest_cap(corpus.doc_lengths(), K)
    cfgs = {}
    for label, (_, knobs) in FORMS.items():
        alias = knobs.get("sampler") == "alias"
        cfgs[label] = tdist.RingConfig(
            n_topics=K, vocab_size=V, rows_per_shard=sc.rows_per_shard,
            docs_per_shard=sc.docs_per_shard, cap=cap, package_len=cap if alias else cap // 2,
            n_rounds=M, doc_topic_cap=doc_cap if alias else 0, **knobs)
    views = mesh.spawn(R.ring_forms, data=D, model=MP, device="cpu",
                       args=([sc], cfgs, EPOCHS), threads=1, timeout_s=R.TIMEOUT_S)
    layout = RankLayout(1, D, MP)
    port = {label: R.assemble_state([v[label] for v in views], cfgs[label], layout)
            for label in FORMS}
    forms = "{" + ", ".join(f"{k!r}: {src}" for k, (src, _) in FORMS.items()) + "}"
    jax = R.jax_run(run_with_devices, JAX_CODE % dict(V=V, D=D, MP=MP, M=M, K=K, EPOCHS=EPOCHS,
                                                       FORMS=forms), n_devices=M)
    return corpus, sc, port, jax


@pytest.mark.parametrize("label", list(FORMS))
def test_ring_of_eight_ranks_matches_jax(runs, label):
    corpus, sc, port, jax = runs
    for i, name in enumerate(("phi", "psi", "wl", "dl", "uid", "z")):
        got = port[label][i]
        want = jax[f"{label}/{name}"]
        if name == "uid":
            got = got.astype(np.uint32)
        assert got.shape == want.shape, (name, got.shape, want.shape)
        np.testing.assert_array_equal(got, want, err_msg=f"{label}: {name}")
    phi, psi, wl, _, _, z = port[label]
    valid = wl >= 0
    counts = np.zeros_like(phi)
    for m in range(M):
        np.add.at(counts[m], (wl[:, m][valid[:, m]], z[:, m][valid[:, m]]), 1)
    np.testing.assert_array_equal(counts, phi, err_msg="Φ is not the counts of the travelling z")
    assert (phi.sum(axis=(0, 1)) == psi).all() and int(psi.sum()) == corpus.n_tokens
