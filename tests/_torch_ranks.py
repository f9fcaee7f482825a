"""Rank bodies and the JAX host-mesh runner shared by the port's multi-rank
tests (``tests/test_torch_ring.py``, ``test_torch_shard_model.py``,
``test_torch_pods.py``, ``test_torch_trainer_multipod.py``,
``test_torch_dryrun.py``, ``test_torch_preflight.py``, the ``*_ranks.py``
files).

The rank bodies run in processes started by ``repro_torch.launch.mesh.spawn``
(gloo over CPU processes), so this module imports torch and the port only,
never jax. ``jax_run`` runs a JAX script on XLA host devices in a subprocess
(``conftest.run_with_devices``) and reads back the arrays it saved.
"""
import os
import tempfile

import numpy as np
import torch

from repro_torch.dist import sharding as shd

BETA = 0.01
TESTS = os.path.dirname(os.path.abspath(__file__))
# a rank that waits this long in a collective fails the test instead of hanging it
TIMEOUT_S = 300


def alpha0(K):
    return torch.full((K,), 50.0 / K)


def rank_tables(st, alpha, V, pod_axis=False):
    """This rank's alias tables from its own Φ rows and the α row."""
    from repro_torch.core import sparse

    wq, wp, wa = sparse.make_word_tables(st[0], st[1], torch.tensor(BETA), V)
    ap, aa = sparse.make_alpha_table(alpha)
    return (wq, wp, wa, ap, aa)


def ring_body(layout, scs, cfg, epochs, pod_axis=False):
    """``epochs`` ring epochs of one rank from its views of ``scs``; returns
    the rank's (phi, psi, wl, dl, uid, z) views as numpy."""
    from repro_torch.core import distributed as dist

    K = cfg.n_topics
    st = dist.rank_arrays(scs, K, layout, device="cpu", pod_axis=pod_axis)
    epoch = dist.build_epoch_body(cfg, layout, pod_axis=pod_axis)
    alpha = alpha0(K)
    tabs = rank_tables(st, alpha, cfg.vocab_size) if cfg.sampler == "alias" else ()
    for ep in range(epochs):
        st = epoch(*st, alpha, torch.tensor(BETA), ep * 977 + 3, *tabs)
    return [x.numpy().copy() for x in st]


def ring_forms(layout, scs, cfgs, epochs, pod_axis=False):
    """``ring_body`` for each labelled RingConfig of ``cfgs``, in one world."""
    return {label: ring_body(layout, scs, cfg, epochs, pod_axis)
            for label, cfg in cfgs.items()}


def assemble_state(views, cfg, layout, pod_axis=False):
    """The ranks' views → the JAX package's global (phi, psi, wl, dl, uid,
    z). Ψ must be the same on every rank of a pod."""
    from repro_torch.core import distributed as dist

    sp = dist.specs(cfg.model_shards, pod_axis)
    per = list(zip(*views))
    out = [shd.assemble(per[0], sp["phi"], layout), shd.assemble(per[1], sp["psi"], layout)]
    out += [shd.assemble(per[i], sp["stack"], layout) for i in range(2, 6)]
    ring = layout.data * layout.model
    for r, v in enumerate(per[1]):
        first = per[1][(r // ring) * ring]
        assert np.array_equal(v, first), f"rank {r}: Ψ differs from its pod's first rank"
    return out


def jax_run(subproc, code, n_devices):
    """Run JAX ``code`` (which must ``np.savez(OUT, **arrays)``) on
    ``n_devices`` XLA host devices through the ``subproc`` fixture; returns
    the saved arrays by name."""
    fd, path = tempfile.mkstemp(suffix=".npz")
    os.close(fd)
    try:
        subproc(f"OUT = {path!r}\n" + code, n_devices=n_devices, timeout=900)
        with np.load(path) as f:
            return {k: f[k] for k in f.files}
    finally:
        os.remove(path)


def z_by_uid(wl, uid, z, n_tokens):
    valid = wl >= 0
    out = np.zeros(n_tokens, np.int32)
    out[uid[valid]] = z[valid]
    return out


def pod_body(layout, scs, cfg, n_epochs, agg_every, modes, seed0=11, chunk_elems=64,
             schedule=None):
    """``run_hierarchical`` over pods, once per aggregate mode ("exact",
    "compressed", "elastic" with ``schedule`` {epoch: live flags}); returns
    {mode: (views, last_n_live)}."""
    from repro_torch.core import hierarchy

    out = {}
    for mode in modes:
        st = hierarchy.init_pod_state(scs, cfg.n_topics, layout, device="cpu")
        epoch = hierarchy.make_pod_ring_epoch(cfg, layout)
        if mode == "elastic":
            agg = hierarchy.make_elastic_aggregate(layout)
            liveness = lambda ep: schedule[ep]
        else:
            agg = hierarchy.make_aggregate(layout, compressed=mode == "compressed",
                                           chunk_elems=chunk_elems)
            liveness = None
        st = hierarchy.run_hierarchical(epoch, agg, st, alpha0(cfg.n_topics),
                                        torch.tensor(BETA), n_epochs, agg_every,
                                        seed0=seed0, liveness=liveness)
        out[mode] = ([x.numpy().copy() for x in st], getattr(agg, "last_n_live", None))
    return out


def compressed_body(layout, g, seeds):
    """``compressed_psum`` of this pod's row of ``g`` for each seed."""
    from repro_torch.dist import collectives as coll

    x = torch.from_numpy(g[layout.pod_index])
    return [coll.compressed_psum({"w": x}, layout, "pod", seed=s)["w"].numpy() for s in seeds]


def elastic_body(layout, phi_ref, deltas, live):
    """``elastic_aggregate`` of (ref + this pod's delta) over the live pods."""
    from repro_torch.dist import collectives as coll

    ref = torch.from_numpy(phi_ref)
    phi = ref + int(deltas[layout.pod_index])
    merged, n_live = coll.elastic_aggregate(phi, ref, live[layout.pod_index], layout)
    return merged.numpy(), n_live


def collectives_body(layout, device):
    """Shift, all_reduce (sum, max) and all_gather over the flattened ring on
    ``device``; returns what this rank received."""
    from repro_torch.dist import collectives as coll

    me = layout.rank
    x = torch.arange(6, dtype=torch.int32, device=device) + 10 * me
    got = coll.shift(layout, "ring", [x, x.to(torch.int64) * 2])
    s = coll.all_reduce_(x.clone(), layout, "ring")
    mx = coll.all_reduce_(x.to(torch.float32), layout, "ring", "max")
    g = coll.all_gather(x, layout, "ring")
    return [t.cpu().numpy() for t in (*got, s, mx, g)]


def card_collectives_body(layout):
    """Sums, maxes and gathers of int64 over "world" on ranks that share one
    card, across a workspace's half: through the card's workspaces and
    through host memory (the same ranks seen as a card each); returns both."""
    import dataclasses
    from repro_torch.dist import collectives as coll

    x = torch.arange(coll.CARD_CHUNK // 8 + 5, dtype=torch.int64, device="cuda")
    x = x * (layout.rank + 1) - 3 * layout.rank
    out = []
    for lay in (layout, dataclasses.replace(layout, ranks_per_device=1)):
        out.append([coll.all_reduce_(x.clone(), lay, "world").cpu().numpy(),
                    coll.all_reduce_(x.clone(), lay, "world", "max").cpu().numpy(),
                    coll.all_gather(x[:7], lay, "world").cpu().numpy()])
    return out


def trainer_run(layout, cfg_kw, ckpt=None, kill=None, resume=False, schedule=None,
                publish=None, ckpt_every=None, ckpt_segments=None, kill_segment=None,
                alpha_opt=False, fault_on=None):
    """One multi-rank ``Trainer`` session on the CPU; returns the global
    checkpoint tree (rank 0; ``None`` elsewhere; streamed sessions' trees
    carry the global z), a streamed session's Ω statistics re-read from the
    source, and the session's counters, or ``{"killed": code}``.
    ``alpha_opt`` adds an ``AlphaOptimizer`` first; ``fault_on`` = (rank,
    key, nth) installs on that rank only a ``FaultPlane`` that fails the
    ``nth`` ``disk.segment_read`` of segment ``key``, and returns its (hits,
    injections)."""
    import contextlib

    from repro_torch.reliability import faults
    from repro_torch.training import (AlphaOptimizer, Checkpointing, ElasticLiveness,
                                      KillSwitch, Metrics, ModelPublisher, Trainer,
                                      TrainerConfig)

    cfg = TrainerConfig(device="cpu", ckpt_dir=ckpt, resume=resume,
                        ckpt_every=ckpt_every or 5, **cfg_kw)
    cbs, live, pub = [AlphaOptimizer()] if alpha_opt else [], None, None
    if schedule:
        live = ElasticLiveness(lambda ep: np.array(schedule[ep]))
        cbs.append(live)
    if ckpt:
        cbs.append(Checkpointing(every_segments=ckpt_segments))
    if kill:
        cbs.append(KillSwitch(kill, at_segment=kill_segment))
    if publish:
        pub = ModelPublisher(publish, every=1)
        cbs.append(pub)
    cbs.append(Metrics(printer=lambda m: None))
    tr = Trainer(cfg, callbacks=cbs, layout=layout)
    tr.log = lambda m: None
    plane = None
    if fault_on and fault_on[0] == layout.rank:
        plane = faults.FaultPlane().fail("disk.segment_read", key=fault_on[1], nth=fault_on[2])
    try:
        with faults.injected(plane) if plane else contextlib.nullcontext():
            tr.fit()
    except SystemExit as exc:
        return {"killed": exc.code}
    omega = None
    if tr._streaming:             # Ω re-read from the source (a collective)
        tr._omega_parts.clear()
        omega = tr.alpha_statistics()[0].numpy()
    return {"tree": tr.checkpoint_tree(), "omega": omega,
            "n_live": live.last_n_live if live else None,
            "n_agg": len(tr.metrics["agg_s"]), "version": pub.last_version if pub else None,
            "ll": tr.metrics["ll"], "epoch": tr.epoch,
            "hits": (plane.hits("disk.segment_read"), plane.injected("disk.segment_read"))
            if plane else None}


def trainer_runs(layout, runs):
    """``trainer_run`` for each (label, kwargs) of ``runs``, in one world."""
    return {label: trainer_run(layout, **kw) for label, kw in runs}


def stream_world(layout, runs):
    """``trainer_run`` for each (label, (data, model), kwargs) of ``runs`` in
    one world, each on the single-pod mesh (data, model) over the world's
    ranks (``mesh.relayout``); returns {label: result}."""
    from repro_torch.launch import mesh

    out = {}
    for label, (data, model), kw in runs:
        lay = layout if layout.shape == (1, data, model) else mesh.relayout(layout, 1, data, model)
        out[label] = trainer_run(lay, **kw)
    return out


def lookup_body(layout, table, vocab_sizes, ids, dtype):
    """``recsys.lookup_sharded`` of ``ids`` on this rank's row slice (over
    "model") of ``table`` cast to ``dtype``; returns the rows as f32 numpy
    and how many ranks hit each (sample, field)."""
    from repro_torch.dist import collectives as coll
    from repro_torch.models import recsys

    spec = recsys.EmbeddingSpec(vocab_sizes=tuple(vocab_sizes), dim=table.shape[1])
    lo, hi = shd.row_slice(table.shape[0], layout, "model")
    shard = torch.from_numpy(table[lo:hi]).to(getattr(torch, dtype))
    ids_t = torch.from_numpy(ids)
    out = recsys.lookup_sharded(shard, spec, ids_t, layout)
    flat = ids_t.long() + torch.from_numpy(spec.offsets).long()[None, :]
    hits = coll.all_reduce_(((flat >= lo) & (flat < hi)).to(torch.int32), layout, "model")
    return out.dtype, out.to(torch.float32).numpy(), hits.numpy()


def train_cell_body(layout, scs, cfg, epochs):
    """``epochs`` epochs of peacock-lda's train cell ``fn`` for ring ``cfg``
    on this rank, the first under ``count_cost``; returns the rank's
    (phi, psi, wl, dl, uid, z) views as numpy and the first epoch's
    collectives (calls and payload bytes by JAX primitive name)."""
    from repro_torch.configs import peacock_lda
    from repro_torch.core import distributed as dist
    from repro_torch.dist import analysis

    cell = peacock_lda.train_cell(cfg, layout)
    st = dist.rank_arrays(scs, cfg.n_topics, layout, device="cpu")
    alpha = alpha0(cfg.n_topics)
    cost = None
    for ep in range(epochs):
        args = (*st, alpha, torch.tensor(BETA), ep * 977 + 3)
        if cost is None:
            cost, st = analysis.count_cost(cell.fn, *args)
        else:
            st = cell.fn(*args)
    return [x.numpy().copy() for x in st], cost.collectives, cost.collective_bytes


def skipped_shift_rank(layout, sc, cfgs, seed):
    """``analysis.preflight.session_rank`` on a ring whose z re-ship is a
    copy, not a shift: a seeded fault for the sharding audit."""
    from repro_torch.analysis import preflight
    from repro_torch.dist import collectives as coll

    coll.shift = lambda layout, name, tensors: [t.clone() for t in tensors]
    return preflight.session_rank(layout, sc, cfgs, seed)


# ------------------------------------------- recsys and GNN cells across ranks ---

RECSYS_FORWARDS = {"dlrm-mlperf": "dlrm_forward", "xdeepfm": "xdeepfm_forward",
                   "din": "din_forward", "autoint": "autoint_forward"}
RECSYS_FLOPS = {"dlrm-mlperf": "_dlrm_flops", "xdeepfm": "_xdeepfm_flops",
                "din": "_din_flops", "autoint": "_autoint_flops"}


def recsys_inputs(arch, cfg, seed=0, n=64):
    """Seeded numpy inputs of ``arch``'s forward at config ``cfg`` (DIN's
    history −1-padded)."""
    rng = np.random.default_rng(seed)
    if arch == "din":
        hist = rng.integers(0, cfg.n_items, (n, cfg.seq_len)).astype(np.int32)
        hist[rng.random((n, cfg.seq_len)) < 0.3] = -1
        return (rng.integers(0, cfg.n_items, n).astype(np.int32), hist,
                rng.integers(0, cfg.context_vocab, (n, cfg.n_context)).astype(np.int32))
    sizes = np.array(cfg.embedding.vocab_sizes)
    ids = (rng.random((n, len(sizes))) * sizes).astype(np.int32)
    if arch == "dlrm-mlperf":
        return rng.normal(size=(n, cfg.n_dense)).astype(np.float32), ids
    return (ids,)


def small_cell(build, layout=None):
    """The port's cell of ``build``: ("recsys", arch, shape, table dtype) at
    ``small_recsys()[arch]`` or ("gnn", kind, shape dict) at ``small_gnn()``,
    for ``layout`` (None: one rank)."""
    import functools

    from repro_torch.configs import base as tbase, gnn_archs as tga, recsys_archs as tra
    from repro_torch.models import recsys as trec

    if build[0] == "gnn":
        return tbase.build_gnn_cell(tga.small_gnn(), build[1], build[2], layout)
    arch, shape = build[1], build[2]
    cfg = tra.small_recsys()[arch]
    maker = {"dlrm-mlperf": functools.partial(tra._dlrm_inputs, cfg=cfg),
             "din": functools.partial(tra._din_inputs, cfg=cfg)}.get(arch)
    if maker is None:
        maker = tra._sparse_inputs(cfg.embedding.vocab_sizes)
    return tbase.build_recsys_cell(cfg, getattr(trec, RECSYS_FORWARDS[arch]), maker,
                                   getattr(tra, RECSYS_FLOPS[arch]), shape, layout)


def cell_args(build, args):
    """The global numpy arguments ``args`` of the cell of ``build`` as CPU
    tensors: parameters and AdamW state carried across by ``convert`` (a
    recsys arch's tables in ``build[3]``), the rest as they are."""
    from repro_torch import convert

    def plain(x):
        return [plain(v) for v in x] if isinstance(x, (list, tuple)) else \
            torch.from_numpy(np.array(x))

    args = list(args)
    kind = small_cell(build).step_kind
    if kind == "retrieval":
        return [plain(a) for a in args[1:]]
    if build[0] == "gnn":
        params = convert.gnn_params_from_numpy(args[0], "cpu")
    else:
        params = convert.recsys_params_from_numpy(args[0], "cpu", getattr(torch, build[3]))
    if kind != "train":
        return [params] + [plain(a) for a in args[1:]]
    return [params, convert.adamw_state_from_numpy(args[1], "cpu")] + [plain(a) for a in args[2:]]


def to_numpy(tree):
    """torch tensors (or a dict/list/tuple of them) → numpy; bf16 as f32."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_numpy(x) for x in tree]
    t = tree.detach()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy().copy()


def views(arg, spec, layout):
    """This rank's block of the global ``arg`` under ``spec`` (dicts and
    lists of them elementwise), as its own tensors."""
    if isinstance(arg, dict):
        return {k: views(arg[k], spec[k], layout) for k in arg}
    if isinstance(arg, (list, tuple)):
        return [views(a, s, layout) for a, s in zip(arg, spec)]
    if not isinstance(arg, torch.Tensor):          # a Python scalar (LDA's beta, seed)
        return arg
    return shd.local_view(arg, spec, layout).clone()


def run_cell(cell, args, steps):
    """``steps`` calls of ``cell.fn`` on ``args`` (a train step carries
    its params and state), the first under ``count_cost``: (the last
    outputs, the losses, the first call's collectives and bytes)."""
    from repro_torch.dist import analysis

    args, losses, cost = list(args), [], None
    for _ in range(steps):
        if cost is None:
            cost, out = analysis.count_cost(cell.fn, *args)
        else:
            out = cell.fn(*args)
        if cell.step_kind == "train":
            args[0], args[1] = out[0], out[1]
            losses.append(float(out[2]))
    return out, losses, (cost.collectives, cost.collective_bytes)


def cells_across_ranks(layout, runs):
    """Each run of ``runs`` (label → (mesh shape, build, global numpy args,
    steps)) on this rank of the world relaid out to that mesh: the rank's
    views of the global arguments (``arg_specs``) through ``cell.fn``;
    returns label → (outputs as numpy, losses, collectives, bytes)."""
    from repro_torch.launch import mesh

    out = {}
    for label, (shape, build, args, steps) in runs.items():
        lay = layout if tuple(shape) == layout.shape else mesh.relayout(layout, *shape)
        cell = small_cell(build, lay)
        local = [views(a, s, lay) for a, s in zip(cell_args(build, args), cell.arg_specs)]
        res, losses, (calls, nbytes) = run_cell(cell, local, steps)
        out[label] = (to_numpy(res), losses, calls, nbytes)
    return out



def lookup_grad_body(layout, table, vocab_sizes, ids, upstream, meshes):
    """The table gradient of ``recsys.lookup_sharded`` under each mesh of
    ``meshes``: this rank's row slice (over "model") of ``table`` (f32), its
    batch rows (over "dp") of ``ids`` [B, F] and of the upstream cotangent
    [B, F, D]; returns mesh → (the slice's [lo, hi), its dense gradient)."""
    from repro_torch.launch import mesh
    from repro_torch.models import recsys

    spec = recsys.EmbeddingSpec(vocab_sizes=tuple(vocab_sizes), dim=table.shape[1])
    out = {}
    for shape in meshes:
        lay = layout if tuple(shape) == layout.shape else mesh.relayout(layout, *shape)
        lo, hi = shd.row_slice(table.shape[0], lay, "model")
        shard = torch.from_numpy(table[lo:hi].copy()).requires_grad_(True)
        rows = shd.local_view(torch.from_numpy(ids), (shd.dp_axes(lay.pods > 1), None), lay)
        up = shd.local_view(torch.from_numpy(upstream), (shd.dp_axes(lay.pods > 1), None, None),
                            lay)
        emb = recsys.lookup_sharded(shard, spec, rows, lay)
        (grad,) = torch.autograd.grad(emb, [shard], up)
        out[tuple(shape)] = (lo, hi, grad.to_dense().numpy())
    return out


# ------------------------------------------------ RT-LDA serving across ranks ---

def rtlda_across_ranks(layout, runs):
    """Each run of ``runs`` (label → (mesh shape, (vocab, K, B, Ld), global
    numpy arguments)) on this rank of the world relaid out to that mesh: the
    serving cell's step (``configs.peacock_lda.serve_cell``) on the rank's
    views under ``count_cost``; returns label → (its pkd columns,
    collectives, bytes)."""
    from repro_torch.configs import peacock_lda
    from repro_torch.dist import analysis
    from repro_torch.launch import mesh

    out = {}
    for label, (shape, (vocab, K, B, Ld), args) in runs.items():
        lay = layout if tuple(shape) == layout.shape else mesh.relayout(layout, *shape)
        cell = peacock_lda.serve_cell(vocab, K, lay, B, Ld)
        local = [views(torch.from_numpy(np.array(a)), s, lay)
                 for a, s in zip(args, cell.arg_specs)]
        cost, pkd = analysis.count_cost(cell.fn, *local)
        out[label] = (pkd.numpy().copy(), cost.collectives, cost.collective_bytes)
    return out


# ------------------------------------------------------------ LM cells across ranks ---

# tiny LM shapes, set into ``configs.base.LM_SHAPES`` of both packages: a train
# step of 8 sequences of 64 (n_micro ≥ 2 at every mesh of the tests) and a
# 64-position cache of 4 sequences, one prefill chunk of all 64 positions
LM_TINY = {"train_t": dict(seq_len=64, global_batch=8, kind="train"),
           "prefill_t": dict(seq_len=64, global_batch=4, kind="prefill"),
           "decode_t": dict(seq_len=64, global_batch=4, kind="decode")}
LM_VARIANTS = ("dense", "expert", "ffn", "gathered")


def lm_variant(name, la):
    """``la.small_lm`` (either package's ``configs.lm_archs``) as variant
    ``name``: dense and tied; MoE with qk_norm and a shared expert, experts
    over "model"; the same with each expert's d_ff over "model"; dense with 3
    query heads and 1 KV head (attention gathered over "model" at M = 2)."""
    import dataclasses

    if name == "dense":
        return la.small_lm()
    if name == "gathered":
        return dataclasses.replace(la.small_lm(), n_heads=3, n_kv_heads=1)
    cfg = la.small_lm(True)
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, moe_shard=name))


def lm_cell(variant, shape, layout=None):
    """The port's LM cell of ``variant`` at the tiny ``shape`` for ``layout``
    (the shape is in ``LM_SHAPES`` only while the cell is built)."""
    from repro_torch.configs import base as tbase, lm_archs as tla

    had = shape in tbase.LM_SHAPES
    tbase.LM_SHAPES.setdefault(shape, LM_TINY[shape])
    try:
        return tbase.make_lm_arch(lm_variant(variant, tla)).cell(shape, layout)
    finally:
        if not had:
            del tbase.LM_SHAPES[shape]


def lm_steps_on_views(layout, variant="dense"):
    """Each tiny LM cell of ``variant`` built for ``layout`` and called on
    the rank's views of its drawn arguments (rank 0's): without a world the
    call stops at its first collective."""
    import pytest

    for shape in LM_TINY:
        cell = lm_cell(variant, shape, layout)
        args = cell.make_args(torch.Generator().manual_seed(0), "cpu")
        with pytest.raises(RuntimeError, match="process groups"):
            cell.fn(*views(list(args), list(cell.arg_specs), layout))


def lm_cell_args(args, train):
    """Global numpy LM arguments as CPU tensors: params (and AdamW's state) by
    ``convert``, the rest as they are."""
    from repro_torch import convert

    params = convert.lm_params_from_numpy(args[0], "cpu")
    if train:
        return [params, convert.adamw_state_from_numpy(args[1], "cpu")] + \
            [torch.from_numpy(np.array(a)) for a in args[2:]]
    cache = {k: torch.from_numpy(np.array(v)) for k, v in args[1].items()}
    return [params, cache]


def lm_cells_across_ranks(layout, runs):
    """Each run of ``runs`` (label → (mesh shape, variant, kind, global numpy
    args, plan)) on this rank of the world relaid out to that mesh, on the
    rank's views by the cell's ``arg_specs``. A train run (args: params,
    state, tokens, labels; plan: steps) returns (outputs, losses,
    collectives, bytes) as ``cells_across_ranks``; a serve run (args:
    params, cache; plan: [(shape, tokens, cache_len)], the cache carried
    from step to step) returns each step's (next tokens, logits, cache) and
    the first step's collectives and bytes of each shape."""
    from repro_torch.dist import analysis
    from repro_torch.launch import mesh

    out = {}
    for label, (shape, variant, kind, args, plan) in runs.items():
        lay = layout if tuple(shape) == layout.shape else mesh.relayout(layout, *shape)
        if kind == "clip":
            out[label] = clip_rank(lay, variant, args, plan)
            continue
        if kind == "train":
            cell = lm_cell(variant, "train_t", lay)
            local = [views(a, s, lay) for a, s in zip(lm_cell_args(args, True), cell.arg_specs)]
            res, losses, (calls, nbytes) = run_cell(cell, local, plan)
            out[label] = (to_numpy(res), losses, calls, nbytes)
            continue
        params, cache = lm_cell_args(args, False)
        steps, costs = [], {}
        for shape_name, tokens, cache_len in plan:
            cell = lm_cell(variant, shape_name, lay)
            if not steps:
                params = views(params, cell.arg_specs[0], lay)
                cache = views(cache, cell.arg_specs[2], lay)
            toks = views(torch.from_numpy(tokens), cell.arg_specs[1], lay)
            cl = torch.tensor(cache_len, dtype=torch.int32)
            if shape_name not in costs:
                cost, (nxt, logits, cache) = analysis.count_cost(cell.fn, params, toks, cache, cl)
                costs[shape_name] = (cost.collectives, cost.collective_bytes)
            else:
                nxt, logits, cache = cell.fn(params, toks, cache, cl)
            steps.append(to_numpy((nxt, logits, cache)))
        out[label] = (steps, costs)
    return out


def clip_rank(layout, variant, args, clip_norm):
    """AdamW (``clip_norm``) at step 0 on this rank's views of global numpy
    (params, grads) of ``variant``: (the global norm, the new params' views)."""
    from repro_torch import convert
    from repro_torch.configs import lm_archs as tla
    from repro_torch.dist import sharding as tshd
    from repro_torch.optim import adamw

    specs = tshd.lm_param_specs(lm_variant(variant, tla))
    params, grads = (views(convert.lm_params_from_numpy(a, "cpu"), specs, layout) for a in args)
    opt = adamw.AdamW(lr=1e-3, clip_norm=clip_norm)
    norm = adamw.global_norm(grads, layout, specs)
    new, _ = opt.update(grads, opt.init(params), params, layout, specs)
    return float(norm), to_numpy(new)


def tla_param_shapes(cfg):
    """``models.transformer.param_shapes`` of the port's ``cfg``."""
    from repro_torch.models import transformer

    return transformer.param_shapes(cfg)


def tla_tree(cfg, leaf):
    """``leaf(shape)`` at every leaf of ``cfg``'s parameter tree."""
    from repro_torch.models import transformer

    return transformer.tree_map(leaf, transformer.param_shapes(cfg))


# ------------------------------------------------------------ mirror worlds ---

MIRROR_GROUPS = ("world", "ring", "data", "model", "pod", "dp")


def mirror_tensors(seed=0):
    """The tensors every rank passes in ``mirror_primitives``: int32, int64,
    f32 and bf16 [8, 6] (bf16 small integers: gloo adds a group's bf16
    tensors one at a time in bf16, whose partial sums round unless the
    values are integers)."""
    g = torch.Generator().manual_seed(seed)
    return {"int32": torch.randint(-50, 50, (8, 6), generator=g, dtype=torch.int32),
            "int64": torch.randint(-50, 50, (8, 6), generator=g, dtype=torch.int64),
            "float32": torch.randn((8, 6), generator=g),
            "bfloat16": torch.randint(-8, 8, (8, 6), generator=g).to(torch.bfloat16)}


def mirror_primitives(layout, seed=0):
    """Every collective of ``dist.collectives`` over each group of ``layout``,
    every rank passing the same tensors (``mirror_tensors``): the primitives
    (``all_reduce_`` sum and max, ``all_gather``, ``reduce_scatter``,
    ``Shift``) and the functions built on them but ``compressed_psum``,
    whose rounding each shard seeds with its own index (a mirror world
    carries this rank's payload for every shard); label → result as numpy."""
    from repro_torch.dist import collectives as coll

    ts, out = mirror_tensors(seed), {}
    for name in MIRROR_GROUPS:
        for dt, t in ts.items():
            out[f"{name}/sum/{dt}"] = coll.all_reduce_(t.clone(), layout, name)
            out[f"{name}/all_gather/{dt}"] = coll.all_gather(t, layout, name)
            out[f"{name}/reduce_scatter/{dt}"] = coll.reduce_scatter(t, layout, name)
            out[f"{name}/psum/{dt}"] = coll.psum(t.clone(), layout, name)
            out[f"{name}/gather_dim1/{dt}"] = coll.gather_dim(t, layout, name, 1)
        for dt in ("int32", "float32"):
            out[f"{name}/max/{dt}"] = coll.all_reduce_(ts[dt].clone(), layout, name, "max")
            out[f"{name}/pmax/{dt}"] = coll.pmax(ts[dt], layout, name)
        out[f"{name}/shift"] = coll.shift(layout, name, [ts["int32"], ts["int64"],
                                                         ts["float32"]])
        out[f"{name}/all_gather_v"] = coll.all_gather_v(ts["float32"][:3], layout, name)
        state = {"a": ts["int32"].clone(), "b": ts["float32"].clone()}
        ref = {"a": ts["int32"] // 2, "b": ts["float32"] * 0.5}
        merged, n_live = coll.elastic_aggregate(state, ref, 1, layout, name)
        out[f"{name}/elastic"] = (merged, torch.tensor(n_live))
        x = ts["float32"].clone().requires_grad_(True)
        (gx,) = torch.autograd.grad((coll.grad_psum(x, layout, name) * 2).sum(), [x])
        out[f"{name}/grad_psum_backward"] = gx
        (gx,) = torch.autograd.grad(coll.all_gather_rows(x, layout, name).square().sum(), [x])
        out[f"{name}/all_gather_rows_backward"] = gx
    return to_numpy(out)


def mirror_groups(layout):
    """The global rank lists of the layout's groups."""
    return {name: list(layout.group(name)[1]) for name in MIRROR_GROUPS}


def mirror_cells(layout, names):
    """The small cells ``names`` (``MIRROR_CELLS``) built for ``layout``; each
    run once on its rank's views under ``count_cost``, from the global
    arguments of ``make_args`` (seed 0) where ``layout`` is a real world,
    or from ``rank_args`` (seed 0) where it is a mirror world. Returns name →
    (the ordered collective log, the outputs' shapes and dtypes)."""
    from repro_torch.dist import analysis

    out = {}
    for name in names:
        cell = mirror_cell(name, layout)
        g = torch.Generator().manual_seed(0)
        if layout.backend == "mirror":
            args = cell.rank_args(g, "cpu", layout)
        else:
            args = [views(a, s, layout) for a, s in zip(cell.make_args(g, "cpu"),
                                                         cell.arg_specs)]
        cost, res = analysis.count_cost(cell.fn, *args)
        out[name] = ([list(e) for e in cost.collective_log], shapes_of(res))
    return out


def shapes_of(tree):
    """(shape, dtype) at every tensor leaf of ``tree``."""
    if isinstance(tree, dict):
        return {k: shapes_of(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [shapes_of(x) for x in tree]
    if isinstance(tree, torch.Tensor):
        return [list(tree.shape), str(tree.dtype)]
    return type(tree).__name__


# the small cell of each family that the mirror tests run
MIRROR_CELLS = ("recsys_train", "recsys_serve", "gnn_full", "gnn_sampled", "lm_train",
                "lm_prefill", "moe_train", "moe_decode", "lda_train", "lda_train_opt",
                "lda_serve")
GNN_TINY = {"full_graph_sm": dict(n_nodes=40, n_edges=150, d_feat=16, n_classes=4,
                                  kind="full"),
            "minibatch_lg": dict(batch_nodes=8, kind="sampled")}


def mirror_ring_config(layout, optimized=False):
    """A small dense ring (K = 16, V = 300, 20 docs a shard, cap 8 in
    packages of 4; or cap 8 in one package, int8 Θ and column exclusion)
    of ``layout``'s flattened ring."""
    from repro_torch.core import distributed as dist

    M = layout.data * layout.model
    return dist.RingConfig(n_topics=16, vocab_size=300, rows_per_shard=-(-300 // M),
                           docs_per_shard=20, cap=8, package_len=8 if optimized else 4,
                           n_rounds=M, theta_dtype=torch.int8 if optimized else torch.int32,
                           column_exclusion=optimized, small_theta=optimized)


def mirror_cell(name, layout):
    """The small cell ``name`` of ``MIRROR_CELLS`` for ``layout``."""
    from repro_torch.configs import peacock_lda

    if name == "recsys_train":
        return small_cell(("recsys", "dlrm-mlperf", "train_batch"), layout)
    if name == "recsys_serve":
        return small_cell(("recsys", "autoint", "serve_p99"), layout)
    if name.startswith("gnn"):
        shape = "full_graph_sm" if name == "gnn_full" else "minibatch_lg"
        return small_cell(("gnn", shape, GNN_TINY[shape]), layout)
    if name in ("lm_train", "lm_prefill", "moe_train", "moe_decode"):
        variant = {"lm": "dense", "moe": "expert"}[name.split("_")[0]]
        variant = "ffn" if name == "moe_decode" else variant
        return lm_cell(variant, name.split("_")[1] + "_t", layout)
    if name.startswith("lda_train"):
        cfg = mirror_ring_config(layout, optimized=name.endswith("opt"))
        return peacock_lda.train_cell(cfg, layout, n_pods=layout.pods)
    return peacock_lda.serve_cell(512, 60, layout, batch=4, query_len=8)


def mirror_world_body(layout, names):
    """A real world's rank: its groups' rank lists, the primitives with
    every rank passing the same tensors, and the small cells' collective
    logs and output shapes."""
    return {"groups": mirror_groups(layout), "primitives": mirror_primitives(layout),
            "cells": mirror_cells(layout, names)}
