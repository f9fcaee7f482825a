"""Port conformance of RT-LDA's ``serve_rt`` across ranks
(``configs.peacock_lda.serve_cell`` with a ``RankLayout``): P̂ and the R
cache row-sharded over each pod's ring, every point read of them summed over
"ring", pkd's columns split over "model", held against the JAX package's
GSPMD-partitioned serving cell.

One JAX subprocess on 4 XLA host devices runs JAX's own ``serve_rt`` cell
(``repro.configs.peacock_lda``'s ``fn`` under ``jax.jit`` with its in/out
shardings) on small global arguments; two spawned gloo worlds (4 ranks, then
2) run the port's step on each rank's views of the same arguments, at
(1, 2, 2), (1, 1, 4), (2, 1, 2) and (1, 1, 2):

- every rank's pkd columns match JAX's within ``test_torch_rtlda.py``'s
  tolerance (rtol 1e-6, atol 1e-7: the final row sum's order);
- every rank's columns equal the port's one-rank step bit for bit: each
  point read has one owner and the other ranks add +0.0;
- the collectives ``count_cost`` logs on each rank equal the port's formula
  (``port_collectives``): JAX's ``model_coll_bytes`` plus the two [B, Ld]
  reads of the R cache and of P̂ at it.

The model is drawn with numpy so that every topic holds the same number of
tokens: P̂ of a word that no document holds is the same in every column, so
in a query of such a word and two words holding one token each, on topics
1 and 2, the word's candidates tie between topics 1 and 2. K = 60 makes α
(50 / K) a number that sums round, so the order of the row sums shows.
"""
import pickle

import numpy as np
import pytest
import torch

import _torch_ranks as R
from _torch_port import one_torch_thread as _one_torch_thread  # noqa: F401  (autouse)
from repro_torch.configs import peacock_lda as tpl
from repro_torch.core import rtlda as trtlda
from repro_torch.dist import sharding as shd
from repro_torch.launch import mesh

pytestmark = pytest.mark.port

V, K, B, LD = 512, 60, 24, 8
N_ITERS, N_TRIALS = 5, 2
TOL = dict(rtol=1e-6, atol=1e-7)
UNSEEN = list(range(V - 8, V))          # words no document holds
A, B_WORD, FILL = V - 10, V - 9, V - 11
TIE_ROW = 20


def _model_and_queries(seed=29):
    """Global numpy arguments (pvk, alpha, r_topic, r_value, word_ids): 8
    documents of 4 tokens a topic (words uniform below V − 16), word A one
    token on topic 1, B_WORD one on topic 2, FILL one on every other topic,
    so Ψ is 33 in every column; P̂ = (Φ + β) / (Ψ + Vβ) in f64, then f32;
    α = 50 / K; the R cache the first maximum of P̂ · α. Queries: one word
    in each quarter of the vocabulary, 19 drawn queries of 1 … 8 tokens, the
    tie query [A, B_WORD, UNSEEN[0]], four unseen words, an empty query, a
    repeated word."""
    rng = np.random.default_rng(seed)
    beta = 0.01
    phi = np.zeros((V, K), np.int64)
    topics = np.repeat(np.arange(K), 8 * 4)
    np.add.at(phi, (rng.integers(0, V - 16, topics.size), topics), 1)
    phi[A, 1] = phi[B_WORD, 2] = 1
    phi[FILL] = 1
    phi[FILL, 1:3] = 0
    psi = phi.sum(axis=0)
    assert np.all(psi == psi[0])
    pvk = ((phi + beta) / (psi + V * beta)).astype(np.float32)
    alpha = np.full(K, 50.0 / K, np.float32)
    prior = pvk * alpha
    r_topic, r_value = prior.argmax(axis=1).astype(np.int32), prior.max(axis=1)
    q = np.full((B, LD), -1, np.int32)
    q[0, :4] = [5, 133, 261, 389]
    for i in range(1, TIE_ROW):
        n = rng.integers(1, LD + 1)
        q[i, :n] = rng.integers(0, V - 16, n)
    q[TIE_ROW, :3] = [A, B_WORD, UNSEEN[0]]
    q[21, :4] = UNSEEN[1:5]
    q[23, :4] = [7, 7, 300, 7]
    return pvk, alpha, r_topic, r_value, q


def _drawn(seed=5):
    """The cell's own ``make_args`` on the CPU, as numpy."""
    g = torch.Generator().manual_seed(seed)
    return [a.numpy() for a in tpl.serve_cell(V, K, batch=B, query_len=LD).make_args(g, "cpu")]


@pytest.fixture(scope="module")
def runs():
    """label → (mesh shape, (vocab, K, B, Ld), global numpy arguments) of
    the 4-rank and the 2-rank worlds."""
    built, drawn = _model_and_queries(), _drawn()
    dims = (V, K, B, LD)
    four = {"122": ((1, 2, 2), dims, built), "114": ((1, 1, 4), dims, built),
            "212": ((2, 1, 2), dims, built), "drawn/122": ((1, 2, 2), dims, drawn)}
    two = {"112": ((1, 1, 2), dims, built)}
    return four, two


JAX_CELL = r"""
import pickle
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh
from repro.configs import get_arch

with open(IN, "rb") as f:
    runs = pickle.load(f)
out = {}
for label, (shape, dims, args) in runs.items():
    multi_pod = shape[0] > 1
    mdims, names = (shape, ("pod", "data", "model")) if multi_pod else \
        (shape[1:], ("data", "model"))
    mesh = Mesh(np.array(jax.devices()[:int(np.prod(shape))]).reshape(mdims), names)
    cell = get_arch("peacock-lda").cell("serve_rt", mesh, multi_pod)
    fn = jax.jit(cell.fn, in_shardings=cell.in_shardings, out_shardings=cell.out_shardings)
    out[label] = np.asarray(fn(*map(jnp.asarray, args)))
np.savez(OUT, **out)
"""


@pytest.fixture(scope="module")
def results(runs, tmp_path_factory):
    """(port, jax_out), one after another: the port's 4-rank and 2-rank
    worlds (label → each rank's (pkd columns, collectives, bytes)), then
    JAX's sharded cell at each run's mesh in one subprocess on 4 host
    devices."""
    pytest.importorskip("jax")
    from conftest import run_with_devices

    four, two = runs

    def world(runs, data, model):
        res = mesh.spawn(R.rtlda_across_ranks, data=data, model=model, device="cpu",
                         args=(runs,), threads=1, timeout_s=R.TIMEOUT_S)
        return {label: [r[label] for r in res] for label in runs}

    port = {**world(four, 2, 2), **world(two, 1, 2)}
    path = tmp_path_factory.mktemp("rtlda_ranks") / "runs.pkl"
    with open(path, "wb") as f:
        pickle.dump({**four, **two}, f)
    return port, R.jax_run(run_with_devices, f"IN = {str(path)!r}\n" + JAX_CELL, n_devices=4)


def _run(runs, label):
    return {**runs[0], **runs[1]}[label]


def _columns(layout, rank):
    return shd.row_slice(K, layout.at(rank), "model")


LABELS = ["122", "114", "212", "112", "drawn/122"]


@pytest.mark.parametrize("label", LABELS)
def test_serve_across_ranks_equals_jax_sharded_cell(runs, results, label):
    """Each rank's [B, K / model] columns against JAX's ``P(None, "model")``
    output at the same mesh."""
    port, jax_out = results
    lay = shd.RankLayout(*_run(runs, label)[0])
    want = jax_out[label]
    assert want.shape == (B, K)
    for rank, (got, _, _) in enumerate(port[label]):
        lo, hi = _columns(lay, rank)
        np.testing.assert_allclose(got, want[:, lo:hi], **TOL, err_msg=f"rank {rank}")


def _one_rank(args):
    cell = tpl.serve_cell(V, K, batch=B, query_len=LD)
    return cell.fn(*(torch.from_numpy(np.array(a)) for a in args)).numpy()


@pytest.mark.parametrize("label", LABELS)
def test_serve_across_ranks_equals_the_one_rank_step_bit_for_bit(runs, results, label):
    """Every rank's columns are the one-rank step's bits (replicas over
    "data" and "pod" included)."""
    shape, _, args = _run(runs, label)
    lay = shd.RankLayout(*shape)
    want = _one_rank(args)
    np.testing.assert_allclose(want.sum(axis=1), 1.0, rtol=1e-5)
    for rank, (got, _, _) in enumerate(results[0][label]):
        lo, hi = _columns(lay, rank)
        assert got.tobytes() == np.ascontiguousarray(want[:, lo:hi]).tobytes(), \
            f"{label}: rank {rank}"


def test_the_tie_query_ties_and_takes_the_first_maximum(runs, results):
    """In the tie query the unseen word's candidates at topics 1 and 2 score
    the same in the first hill step, where argmax takes topic 1 (the first
    column); a step that took the last maximum would give topic 2. JAX, one
    rank and every rank agree on that row."""
    pvk, alpha, r_topic, r_value, q = _model_and_queries()
    u = UNSEEN[0]
    assert (r_topic[A], r_topic[B_WORD], r_topic[u]) == (1, 2, 0)
    assert pvk[u, 1] == pvk[u, 2] and len(set(pvk[u].tolist())) == 1
    model = trtlda.RTLDAModel(*(torch.from_numpy(x) for x in (pvk, alpha, r_topic, r_value)))
    one_step = trtlda.rtlda_infer_batch(model, torch.from_numpy(q[TIE_ROW:TIE_ROW + 1]), 17,
                                        n_iters=1, n_trials=1).numpy()[0]
    theta = np.round(one_step / one_step[0] * alpha - alpha, 4)    # θ_0 = 0: counts by ratio
    assert theta[1] == 2 and theta[2] == 1, theta[:4]
    full = _one_rank(_run(runs, "122")[2])[TIE_ROW]
    np.testing.assert_allclose(full, results[1]["122"][TIE_ROW], **TOL)


def port_collectives(b, ld, n_iters=N_ITERS, n_trials=N_TRIALS):
    """The port's collectives of one serving step on one rank (calls,
    payload bytes by JAX primitive name): a sum over "ring" of the [b, ld]
    int32 R topics, of the [b, ld] f32 P̂ at them, and of the [b, ld, ld] f32
    P̂ at the candidates in every hill step."""
    steps = n_iters * n_trials
    return {"psum": 2.0 + steps}, {"psum": 8.0 * b * ld + steps * 4.0 * b * ld * ld}


@pytest.mark.parametrize("label", LABELS)
def test_collectives_of_a_serve_step_match_the_ports_formula(runs, results, label):
    """Each rank's ``count_cost`` collectives equal ``port_collectives``:
    JAX's ``model_coll_bytes`` (the candidate reads) and the two [B, Ld]
    reads."""
    lay = shd.RankLayout(*_run(runs, label)[0])
    want = port_collectives(B, LD)
    cell = tpl.serve_cell(V, K, lay, B, LD)
    assert want[1]["psum"] == cell.model_coll_bytes + 8.0 * B * LD
    for rank, (_, calls, nbytes) in enumerate(results[0][label]):
        assert (calls, nbytes) == want, (label, rank, calls, nbytes)


def test_serve_cell_draws_queries_and_pads_the_vocabulary():
    """``make_args``: V padded to a multiple of 512, P̂ normalised per
    column, queries of 1 … Ld tokens, −1 padded, drawn again from the same
    seed; the ``meta`` stand-ins have the same shapes and dtypes."""
    cell = tpl.serve_cell(500, 16, batch=32, query_len=4)
    real = cell.make_args(torch.Generator().manual_seed(1), "cpu")
    meta = cell.make_args(None, "meta")
    for r, m in zip(real, meta):
        assert (r.shape, r.dtype) == (m.shape, m.dtype) and m.device.type == "meta"
    pvk, alpha, r_topic, _, q = real
    assert pvk.shape == (512, 16) and q.shape == (32, 4)
    np.testing.assert_allclose(pvk.sum(dim=0).numpy(), 1.0, rtol=1e-5)
    n = (q >= 0).sum(dim=1)
    assert bool((n >= 1).all()) and bool((q[:, 0] >= 0).all()) and int(q.max()) < 500
    assert bool(((q >= 0) == (torch.arange(4)[None, :] < n[:, None])).all())
    assert torch.equal(r_topic, torch.argmax(pvk * alpha, dim=1).to(torch.int32))
    again = cell.make_args(torch.Generator().manual_seed(1), "cpu")
    assert all(torch.equal(a, b) for a, b in zip(real, again))
