"""Port conformance of the LM cells across ranks (``configs.base.build_lm_cell``
with a ``RankLayout``): FSDP over "data", tensor parallelism over "model",
the vocab-parallel embedding and loss, the sequence-sharded KV cache with its
log-sum-exp combine, and both MoE placements, held against the JAX package's
GSPMD-partitioned cells.

Four variants of ``small_lm`` (``_torch_ranks.lm_variant``, built with
``dataclasses.replace`` in both packages): dense and tied; MoE with qk_norm
and a shared expert, experts over "model"; the same with each expert's d_ff
over "model"; dense with 3 query heads and 1 KV head, whose attention is
gathered over "model". Tiny shapes (``_torch_ranks.LM_TINY``) are set into
both packages' ``LM_SHAPES``: a train step of 8 sequences of 64 (2 or more
microbatches at each mesh; MoE at the default capacity factor 1.25, so
pairs are dropped, by JAX's global order over the microbatch) with about
one label in ten −1; a 64-position cache of 4 sequences, one prefill chunk of
all 64 positions (across both slices), then decodes at positions 20 (the
second slice has no valid position), 45 and 33.

JAX's cells run under ``jax.jit`` with their in/out shardings (inside
``repro.dist.sharding.ambient_mesh_scope``) on 4 XLA host devices; the
port's in spawned gloo worlds of 4 ranks at (1, 2, 2) and 2 at (1, 1, 2), on
each rank's views of the same global arguments (JAX's parameter draw carried
across by ``convert.lm_params_from_numpy``). Held, in f32, with
``test_torch_lm.py``'s one-rank tolerances:

- train, 2 steps: the losses, the parameters and AdamW's m at rtol = atol =
  1e-5, v at (1e-4, 1e-9), every replica of a block the same bits;
- serve: the next tokens equal, the logits and the cache views within 1e-5;
- the collectives ``count_cost`` counts on each rank, against the port's own
  formula (``port_collectives``);
- AdamW at a ``clip_norm`` that binds: the global norm across (1, 2, 2)
  equals JAX's; at one rank ``update`` keeps the bits of the norm summed
  leaf by leaf.
"""
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_ranks as R
from _torch_port import one_torch_thread as _one_torch_thread  # noqa: F401  (autouse)
from repro_torch.configs import lm_archs as tla
from repro_torch.dist import sharding as shd
from repro_torch.launch import mesh
from repro_torch.optim import adamw

pytestmark = pytest.mark.port

TOL = dict(rtol=1e-5, atol=1e-5)
V_TOL = dict(rtol=1e-4, atol=1e-9)
STEPS = 2
CLIP = 1e-3
MESHES = {"122": (1, 2, 2), "112": (1, 1, 2)}
# every variant at (1, 2, 2); at (1, 1, 2), pure tensor parallelism, the MoE
# with experts over "model" and the gathered attention (each JAX cell's
# compile takes 7-12 s of the file's time)
CASES = [(v, "122") for v in R.LM_VARIANTS] + [("expert", "112"), ("gathered", "112")]
DECODES = (20, 45, 33)


def _paths(tree, pre=""):
    """(path, leaf) of a nested dict in sorted order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _paths(tree[k], f"{pre}/{k}")]
    return [(pre, tree)]


def _get(tree, path):
    for k in path.strip("/").split("/"):
        tree = tree[k]
    return tree


@pytest.fixture(scope="module")
def runs():
    """label → (mesh, variant, kind, global numpy args, plan)."""
    pytest.importorskip("jax")
    import jax
    from repro.configs import lm_archs as jla
    from repro.models import transformer as jtf

    rng = np.random.default_rng(7)
    out = {}
    for i, variant in enumerate(R.LM_VARIANTS):
        cfg = R.lm_variant(variant, tla)
        raw = jax.tree.map(np.asarray, jtf.init_params(R.lm_variant(variant, jla),
                                                       jax.random.key(11 + i)))
        zeros = jax.tree.map(np.zeros_like, raw)
        train = R.LM_TINY["train_t"]
        toks = rng.integers(0, cfg.vocab_size, (2, train["global_batch"], train["seq_len"]))
        toks = toks.astype(np.int32)
        toks[1][rng.random(toks[1].shape) < 0.1] = -1
        state = {"step": np.zeros((), np.int32), "m": zeros, "v": zeros}
        B = R.LM_TINY["decode_t"]["global_batch"]
        cache = np.zeros((cfg.n_layers, B, 64, cfg.n_kv_heads, cfg.d_head), np.float32)
        plan = [("prefill_t", rng.integers(0, cfg.vocab_size, (B, 64)).astype(np.int32), 0)]
        plan += [("decode_t", rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32), cl)
                 for cl in DECODES]
        for name, layout in MESHES.items():
            if (variant, name) not in CASES:
                continue
            out[f"{variant}/train/{name}"] = (layout, variant, "train",
                                             (raw, state, toks[0], toks[1]), STEPS)
            out[f"{variant}/serve/{name}"] = (layout, variant, "serve",
                                             (raw, {"k": cache, "v": cache}), plan)
    grads = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32), raw)
    out["clip/122"] = (MESHES["122"], R.LM_VARIANTS[-1], "clip", (raw, grads), CLIP)
    return out


JAX_CELLS = r"""
import pickle
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh
import _torch_ranks as R
from repro.configs import base as jbase, lm_archs as jla
from repro.dist import sharding as jshd
from repro.optim import adamw as jadamw

jbase.LM_SHAPES.update(R.LM_TINY)
with open(IN, "rb") as f:
    runs = pickle.load(f)
out = {}


def flat(pre, tree):
    return {pre + "/" + "/".join(k.key for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


for label, (shape, variant, kind, args, plan) in runs.items():
    cfg = R.lm_variant(variant, jla)
    tree = lambda a: jax.tree.map(jnp.asarray, a)
    if kind == "clip":
        params, grads = tree(args[0]), tree(args[1])
        opt = jadamw.AdamW(lr=1e-3, clip_norm=plan)
        new, _ = opt.update(grads, opt.init(params), params)
        out[f"{label}/norm"] = np.asarray(jadamw.global_norm(grads))
        out.update(flat(f"{label}/p", new))
        continue
    mesh = Mesh(np.array(jax.devices()[:int(np.prod(shape))]).reshape(shape[1:]),
                ("data", "model"))
    spec = jbase.make_lm_arch(cfg)
    jit = lambda c: jax.jit(c.fn, in_shardings=c.in_shardings, out_shardings=c.out_shardings)
    with jshd.ambient_mesh_scope(mesh, False):
        if kind == "train":
            fn = jit(spec.cell("train_t", mesh))
            params, state, rest = tree(args[0]), tree(args[1]), [tree(a) for a in args[2:]]
            for step in range(plan):
                params, state, loss = fn(params, state, *rest)
                out[f"{label}/loss{step}"] = np.asarray(loss)
            out.update(flat(f"{label}/p", params))
            out.update(flat(f"{label}/m", state["m"]))
            out.update(flat(f"{label}/v", state["v"]))
            continue
        fns = {s: jit(spec.cell(s, mesh)) for s in ("prefill_t", "decode_t")}
        params, cache = tree(args[0]), tree(args[1])
        for i, (s, toks, cl) in enumerate(plan):
            nxt, logits, cache = fns[s](params, jnp.asarray(toks), cache, jnp.int32(cl))
            out[f"{label}/{i}/next"] = np.asarray(nxt)
            out[f"{label}/{i}/logits"] = np.asarray(logits)
            out[f"{label}/{i}/k"] = np.asarray(cache["k"])
            out[f"{label}/{i}/v"] = np.asarray(cache["v"])
np.savez(OUT, **out)
"""


# JAX's runs in three subprocesses of about one train compile's weight each
# (the MoE cells at (1, 2, 2); the dense ones; (1, 1, 2) and the clip)
JAX_JOBS = (lambda k: k.endswith("122") and k.split("/")[0] in ("expert", "ffn"),
            lambda k: k.endswith("122") and k.split("/")[0] in ("dense", "gathered"),
            lambda k: not k.endswith("122") or k.startswith("clip/"))


@pytest.fixture(scope="module")
def results(runs, tmp_path_factory):
    """(port, jax_out): the port's worlds of 4 and 2 ranks (label → each
    rank's outputs) and JAX's sharded cells on 4 host devices, in the
    subprocesses of ``JAX_JOBS``, which run while the worlds do."""
    from conftest import run_with_devices

    import concurrent.futures as cf

    paths = []
    for part in JAX_JOBS:
        paths.append(tmp_path_factory.mktemp("lm_ranks") / "runs.pkl")
        with open(paths[-1], "wb") as f:
            pickle.dump({k: v for k, v in runs.items() if part(k)}, f)
    with cf.ThreadPoolExecutor(len(paths)) as pool:
        jobs = [pool.submit(R.jax_run, run_with_devices,
                            f"import sys; sys.path.insert(0, {R.TESTS!r})\n"
                            f"IN = {str(p)!r}\n" + JAX_CELLS, 4) for p in paths]

        def world(name, data, model):
            sub = {k: v for k, v in runs.items() if k.endswith(name)}
            res = mesh.spawn(R.lm_cells_across_ranks, data=data, model=model, device="cpu",
                             args=(sub,), threads=1, timeout_s=R.TIMEOUT_S)
            return {label: [r[label] for r in res] for label in sub}

        port = {**world("122", 2, 2), **world("112", 1, 2)}
        return port, {k: v for job in jobs for k, v in job.result().items()}


def _same_replicas(blocks, spec, layout, what):
    """The ranks that hold one block of a leaf under ``spec`` hold the same
    bits."""
    first = {}
    for r, b in enumerate(blocks):
        key = tuple(i for _, i in shd.block_index(spec, layout, r))
        assert b.tobytes() == first.setdefault(key, b).tobytes(), (what, r)


@pytest.mark.parametrize("variant,name", CASES)
def test_train_across_ranks_equals_jax_sharded_cell(results, runs, variant, name):
    port, jax_out = results
    label = f"{variant}/train/{name}"
    ranks = port[label]
    layout = shd.RankLayout(*runs[label][0])
    for r in ranks:
        assert r[1] == ranks[0][1]                              # one loss on every rank
    np.testing.assert_allclose(ranks[0][1], [float(jax_out[f"{label}/loss{i}"])
                                             for i in range(STEPS)], **TOL)
    specs = shd.lm_param_specs(R.lm_variant(variant, tla))
    for part, pick, tol in (("p", lambda r: r[0][0], TOL), ("m", lambda r: r[0][1]["m"], TOL),
                            ("v", lambda r: r[0][1]["v"], V_TOL)):
        for path, spec in _paths(specs):
            blocks = [_get(pick(r), path) for r in ranks]
            _same_replicas(blocks, spec, layout, f"{part}{path}")
            got = shd.assemble(blocks, spec, layout)
            np.testing.assert_allclose(got, jax_out[f"{label}/{part}{path}"], **tol,
                                       err_msg=f"{part}{path}")
    assert all(int(r[0][1]["step"]) == STEPS for r in ranks)


@pytest.mark.parametrize("variant,name", CASES)
def test_serve_across_ranks_equals_jax_sharded_cell(results, runs, variant, name):
    """Prefill over both cache slices, then decodes in each; the decode at 20
    finds no valid position in the second slice."""
    port, jax_out = results
    label = f"{variant}/serve/{name}"
    layout = shd.RankLayout(*runs[label][0])
    ranks = [r[0] for r in port[label]]
    dp, cache = shd.lm_batch_spec(), shd.lm_cache_spec()
    for i in range(1 + len(DECODES)):
        nxt = shd.assemble([r[i][0] for r in ranks], dp, layout)
        np.testing.assert_array_equal(nxt, jax_out[f"{label}/{i}/next"])
        logits = shd.assemble([r[i][1] for r in ranks], (dp[0], "model"), layout)
        np.testing.assert_allclose(logits, jax_out[f"{label}/{i}/logits"], **TOL)
        for j, part in enumerate("kv"):
            got = shd.assemble([r[i][2][part] for r in ranks], cache, layout)
            np.testing.assert_allclose(got, jax_out[f"{label}/{i}/{part}"], **TOL,
                                       err_msg=f"step {i} {part}")


def port_collectives(variant, kind, layout, C=None):
    """The port's collectives of one step on one rank (calls, payload bytes by
    JAX primitive name) at the tiny shapes, from ``models.transformer``'s
    plan (D = "data", M = "model" ranks; axes of one rank exchange nothing):

    - train, each microbatch: the embedding's psum over "model"; each layer's
      FSDP all_gather over "data" of every weight its spec splits there, and
      their reduce-scatter backward; where attention does not split by
      heads, the attention weights' all_gather over "model" (no collective
      backward); the row-parallel psums (attention, FFN or MoE), the
      ``grad_psum`` sums backward (attention input, qnorm and knorm, FFN
      input; MoE: the gathered tokens and gates, the shared experts' input);
      MoE: the tokens' all_gather over "dp" and its reduce-scatter backward;
      the loss: a pmax and one psum (Σexp and gold) a chunk, tot and cnt
      over "dp", the head input's sum backward. Each step: the tokens and
      labels gathered over "dp" (more than one microbatch), the replicated
      gradients summed over "dp" in one buffer, the norm's leaf sums over
      "world";
    - serve, a step of C tokens: the embedding's psum; each layer's FSDP
      gathers (and the attention weights' over "model" where attention does
      not split, else one all_gather of the chunk's q, k and v), the
      log-sum-exp combine's pmax and psum, the row-parallel psums, MoE's
      gather over "dp"; the argmax's two pmax."""
    cfg = R.lm_variant(variant, tla)
    D, M = layout.data, layout.model
    L, d, H, KV, dh = cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    e = torch.empty((), dtype=cfg.dtype).element_size()
    split = M > 1 and H % M == 0 and KV % M == 0
    specs = shd.lm_param_specs(cfg)
    shapes = dict(_paths(R.tla_param_shapes(cfg)))
    block = {p: int(np.prod(shapes[p])) // (D if "data" in sp else 1) // (M if "model" in sp else 1)
             for p, sp in _paths(specs)}
    layer = [p for p in block if p.startswith("/layers/")]
    fsdp = sum(block[p] for p in layer if "data" in _get(specs, p)) // L
    attn = sum(int(np.prod(shapes[f"/layers/{w}"])) // L // M for w in ("wq", "wk", "wv", "wo"))
    calls, nbytes = {}, {}

    def add(name, n, b):
        calls[name] = calls.get(name, 0.0) + n
        nbytes[name] = nbytes.get(name, 0.0) + b

    n_fsdp = sum(1 for p in layer if "data" in _get(specs, p))
    moe = cfg.moe is not None
    if kind == "train":
        info = R.LM_TINY["train_t"]
        S, B = info["seq_len"], info["global_batch"]
        n_micro = max(1, B // (D * (1 if moe else 2)))
        b = B // n_micro // D
        chunks = S // min(cfg.loss_chunk, S)
        act = b * S * d * e
        for _ in range(n_micro):
            if D > 1:
                add("all_gather", L * n_fsdp, L * fsdp * e)
                add("reduce_scatter", L * n_fsdp, L * fsdp * e * D)
                add("psum", 2, 8)
                if moe:
                    add("all_gather", L, L * act)
                    add("reduce_scatter", L, L * act * D)
            if M > 1:
                add("psum", 2 + L + chunks, 2 * act + L * act + chunks * 2 * b * min(
                    cfg.loss_chunk, S) * 4)
                if not moe:
                    add("psum", L, L * act)
                add("pmax", chunks, chunks * b * min(cfg.loss_chunk, S) * 4)
                if split:
                    add("psum", 2 * L, 2 * L * act)
                    if cfg.qk_norm:
                        add("psum", 2 * L, 2 * L * dh * e)
                else:
                    add("all_gather", 4 * L, L * attn * e)
                if moe:
                    T = b * S * D
                    add("psum", 2 * L, L * (T * d * e + T * cfg.moe.top_k * 4))
                    if cfg.moe.n_shared_experts:
                        add("psum", L, L * act)
        if D > 1:
            if n_micro > 1:
                add("all_gather", 1, 2 * (B // D) * S * 4)
            add("psum", 1, 4 * sum(block[p] for p, sp in _paths(specs) if "data" not in sp))
        add("psum", 1, 4 * len(block))
        return calls, nbytes
    b = R.LM_TINY[f"{kind}_t"]["global_batch"] // D
    act = b * C * d * e
    if D > 1:
        add("all_gather", L * n_fsdp, L * fsdp * e)
        if moe:
            add("all_gather", L, L * act)
    if M > 1:
        add("psum", 1 + L * (2 + split), act + L * (b * C * H * (dh + 1) * 4 + act * (1 + split)))
        add("pmax", L + 2, L * b * C * H * 4 + b * 12)
        if split:
            add("all_gather", L, L * b * C * (H + 2 * KV) // M * dh * e)
        else:
            add("all_gather", 4 * L, L * attn * e)
    return calls, nbytes


@pytest.mark.parametrize("variant,name", CASES)
def test_collectives_of_a_step_match_the_ports_formula(results, runs, variant, name):
    """Each rank's collectives in its first train step, its prefill step and
    its first decode step equal ``port_collectives``."""
    port, _ = results
    layout = shd.RankLayout(*runs[f"{variant}/train/{name}"][0])
    want = port_collectives(variant, "train", layout)
    for r in port[f"{variant}/train/{name}"]:
        assert (r[2], r[3]) == want, (r[2], r[3], want)
    for shape, C in (("prefill_t", 64), ("decode_t", 1)):
        want = port_collectives(variant, shape[:-2], layout, C)
        for r in port[f"{variant}/serve/{name}"]:
            assert r[1][shape] == want, (shape, r[1][shape], want)


def test_clip_scale_across_ranks_equals_jax(results, runs):
    """AdamW at clip_norm 1e-3 (the scale ≈ 1e-5 binds) on the rank's blocks
    of drawn gradients at (1, 2, 2): every rank's global norm equals JAX's
    ``global_norm`` of the whole tree, and the updated parameters JAX's."""
    port, jax_out = results
    norm = float(jax_out["clip/122/norm"])
    assert min(1.0, CLIP / norm) < 1e-4
    ranks = port["clip/122"]
    layout = shd.RankLayout(*runs["clip/122"][0])
    for r in ranks:
        np.testing.assert_allclose(r[0], norm, rtol=1e-6)
    specs = shd.lm_param_specs(R.lm_variant(runs["clip/122"][1], tla))
    for path, spec in _paths(specs):
        got = shd.assemble([_get(r[1], path) for r in ranks], spec, layout)
        np.testing.assert_allclose(got, jax_out[f"clip/122/p{path}"], **TOL, err_msg=path)


def _norm_leaf_by_leaf(tree):
    """AdamW's global norm as it was summed before it learnt the shards."""
    total = 0
    for leaf in adamw._leaves(tree):
        total = total + torch.sum(torch.square(leaf.to(torch.float32)))
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


@pytest.mark.parametrize("layout", [None, shd.RankLayout(1, 1, 1)])
def test_one_rank_update_keeps_its_bits(monkeypatch, layout):
    """At one rank (no layout, or a layout of one rank) the norm and the
    clipped update (parameters, m, v) have the bits of the update through
    the leaf-by-leaf norm."""
    g = torch.Generator().manual_seed(4)
    cfg = tla.small_lm(True)
    draw = lambda: R.tla_tree(cfg, lambda s: torch.randn(s, generator=g))
    params, grads = draw(), draw()
    specs = shd.lm_param_specs(cfg)
    opt = adamw.AdamW(lr=1e-3, clip_norm=1e-3)
    assert torch.equal(adamw.global_norm(grads, layout, specs), _norm_leaf_by_leaf(grads))
    new, state = opt.update(grads, opt.init(params), params, layout, specs)
    monkeypatch.setattr(adamw, "global_norm", lambda tree, *rest: _norm_leaf_by_leaf(tree))
    old, old_state = opt.update(grads, opt.init(params), params)
    for a, b in ((new, old), (state.m, old_state.m), (state.v, old_state.v)):
        for (path, x), (_, y) in zip(_paths(a), _paths(b)):
            assert torch.equal(x, y), path


@pytest.mark.parametrize("variant,name", [c for c in CASES if c[0] in ("expert", "ffn")])
def test_moe_cases_drop_pairs(runs, monkeypatch, variant, name):
    """The MoE cases' first step drops pairs at capacity factor 1.25 (at the
    mesh's microbatch, a microbatch's rows), so their match with JAX's
    sharded cell holds the global dispatch order."""
    from repro_torch import convert
    from repro_torch.models import moe, transformer as tf

    layout, _, _, args, _ = runs[f"{variant}/train/{name}"]
    cfg = R.lm_variant(variant, tla)
    assert cfg.moe.capacity_factor == 1.25
    real, dropped = moe.dispatch, []

    def recorded(expert, T, C, E):
        out = real(expert, T, C, E)
        dropped.append(int((~out[2]).sum()))
        return out

    monkeypatch.setattr(moe, "dispatch", recorded)
    params = convert.lm_params_from_numpy(args[0], "cpu")
    B = args[2].shape[0]
    rows = B // max(1, B // layout[1])              # a microbatch: n_micro = B / dp at mpd 1
    with torch.no_grad():
        for i in range(0, B, rows):
            tf.lm_loss(cfg, params, torch.from_numpy(args[2][i:i + rows]),
                       torch.from_numpy(args[3][i:i + rows]))
    assert sum(dropped) > 0, dropped
