"""Cell builders: (architecture × input shape × layout) → a runnable step
(port of ``repro.configs.base``; the LDA cells are in
``configs/peacock_lda.py``).

A ``Cell`` holds the step function, a maker of its arguments (real inputs
and state drawn on a device from a generator, or empty ``meta`` tensors of
the same shapes, where JAX's cell holds ``ShapeDtypeStruct`` stand-ins), the
layout spec of each argument (JAX's in_shardings, in the port's tuple idiom
of ``dist/sharding.py``) and the analytic MODEL_FLOPS. It has no ``lower``:
PyTorch runs eagerly. The dry run (``launch/dryrun.py``) cuts the global
arguments to one rank's bytes with the specs.

Step functions by shape kind:
  train_*      → full train step: fwd + bwd + optimizer update (LM:
                 microbatched gradient accumulation, f32 master params, bf16
                 compute; GNN: AdamW; recsys: SGD on the table rows a batch
                 touches, AdamW on the dense parameters)
  prefill_*    → one chunked-prefill ``serve_step`` (C = 4,096) against a
                 seq_len KV cache
  decode_*     → one-token ``serve_step`` against a seq_len KV cache
  serve_*      → recsys batch forward; retrieval_cand → streamed top-k scoring
  (LDA)        → one rank's ring Gibbs epoch / RT-LDA serving batch

Across ranks a cell's ``fn`` is one rank's step: it takes the rank's views
(``sharding.local_view`` of ``make_args``' global arguments by
``arg_specs``) and returns the rank's views, as JAX's GSPMD-partitioned
cell computes them. The recsys steps row-shard the tables over "model"
(``models.recsys.ShardedReads``; dense gradients all_reduced over "dp");
the GNN steps split node and edge rows over every axis (``models.gnn``'s
``layout=``; gradients all_reduced over "world"); the LM steps are FSDP
over "data" and tensor parallel over "model" (``models.transformer``'s
``layout=``): the train step takes JAX's microbatches of the global batch
(n_micro = B / (dp · micro_per_device)), the replicated leaves' gradients
summed over "dp" and AdamW clipped by the global norm; the serving steps
read a sequence-sharded KV cache; peacock-lda's ``serve_rt`` reads P̂
row-sharded over the ring (``core/rtlda.py``'s ``layout=``). An LM train
cell at one rank carries ``one_rank_cut``: the same step on one microbatch,
which the dry run's one-rank record runs (the global batch is 128
microbatches there).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.dist import collectives as coll
from repro_torch.dist import sharding as shd
from repro_torch.models import gnn as gnn_mod
from repro_torch.models import recsys as rec_mod
from repro_torch.models import transformer as tf_mod
from repro_torch.optim import schedules
from repro_torch.optim.adamw import AdamW


@dataclasses.dataclass
class Cell:
    arch: str
    shape: str
    step_kind: str                 # train | serve | retrieval | lda_train | lda_serve
    fn: Callable
    make_args: Callable[..., Tuple[Any, ...]]
                                   # (generator, device, params=None) → fn's
                                   # global args (device "meta": empty stand-ins)
    model_flops: float             # analytic useful FLOPs per step
    model_coll_bytes: float = 0.0  # analytic GLOBAL collective traffic per step of
                                   # JAX's sharded step (the same formula); one
                                   # rank exchanges nothing
    donate: Tuple[int, ...] = ()   # args the step updates in place or consumes
    note: str = ""
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)
                                   # analytic side-channel merged into the
                                   # dry-run record (e.g. sampler_traffic)
    arg_specs: Tuple[Any, ...] = ()
                                   # per arg: a layout spec, or a dict of them
                                   # for a dict arg (JAX's in_shardings)
    arg_roles: Tuple[str, ...] = ()
                                   # per arg: the role its bytes count under
    one_rank_cut: Optional[Callable[[], "Cell"]] = None
                                   # the cell a one-rank run takes instead
                                   # (an LM train step on one microbatch)
    reduced: str = ""              # what that cut cell leaves out


@dataclasses.dataclass
class ArchSpec:
    arch_id: str
    family: str                    # lm | gnn | recsys | lda
    shapes: Dict[str, Dict[str, Any]]
    build: Callable[[str, Any], Optional[Cell]]   # (shape, layout)
    skip: Dict[str, str] = dataclasses.field(default_factory=dict)  # shape → reason

    def cell(self, shape: str, layout=None) -> Optional[Cell]:
        if shape in self.skip:
            return None
        return self.build(shape, layout)


# ===========================================================================
# RecSys family
# ===========================================================================

RECSYS_SHAPES = {
    "train_batch": dict(batch=65536, kind="train"),
    "serve_p99": dict(batch=512, kind="serve"),
    "serve_bulk": dict(batch=262144, kind="serve"),
    "retrieval_cand": dict(batch=1, n_candidates=1_000_000, kind="retrieval"),
}

# the train step's optimizers: SGD on the tables (MLPerf reference practice,
# no optimizer state for the 10⁸-row tables), AdamW on the dense parameters
TABLE_LR = 0.01
DENSE_OPT = AdamW(lr=1e-3, weight_decay=0.0)


def _split_table_params(params):
    tables = {k: v for k, v in params.items() if k.endswith("table") or k == "linear_w"}
    dense = {k: v for k, v in params.items() if k not in tables}
    return tables, dense


def _param_dtype(name: str) -> torch.dtype:
    """Tables live in bf16 (as in JAX's cell, ``base.py:396``); the rest,
    ``linear_w`` included, in f32."""
    return torch.bfloat16 if name.endswith("table") else torch.float32


def _params(cfg, generator, dev) -> Dict[str, torch.Tensor]:
    """``cfg``'s parameters on ``dev``: drawn by ``init_params`` (tables bf16,
    drawn chunk by chunk), or empty ``meta`` tensors of the same shapes and
    dtypes."""
    if dev.type == "meta":
        return {k: torch.empty(s, dtype=_param_dtype(k), device=dev)
                for k, s in sorted(cfg.param_shapes().items())}
    return rec_mod.init_params(cfg, generator, dev, torch.bfloat16)


def all_reduce_grads_(grads: Dict[str, torch.Tensor], layout, name: str) -> None:
    """Sum the dense gradients ``grads`` over group ``name`` in place, as one
    flat f32 buffer (one collective): every rank of the group then holds the
    same bits."""
    names = sorted(grads)
    flat = coll.all_reduce_(torch.cat([grads[k].reshape(-1) for k in names]), layout, name)
    lo = 0
    for k in names:
        n = grads[k].numel()
        grads[k].copy_(flat[lo:lo + n].view(grads[k].shape))
        lo += n


def _input_specs(inputs, bspec) -> tuple:
    """JAX's input shardings: [B] arrays over the data-parallel axes, [B, ...]
    arrays as ``bspec``."""
    return tuple((bspec[0],) if x.dim() == 1 else bspec for x in inputs)


def build_recsys_cell(cfg, forward_fn, input_maker, flops_fn,
                      shape_name: str, layout=None) -> Cell:
    """Generic builder; ``input_maker(batch, generator, device)`` → the model
    inputs after params. ``layout``: a ``RankLayout`` (None: one rank); the
    arguments are global, ``arg_specs`` split them over the layout's mesh."""
    info = RECSYS_SHAPES[shape_name]
    B = info["batch"]
    shapes = cfg.param_shapes()
    emb_dim = cfg.embedding.dim if hasattr(cfg, "embedding") else cfg.embed_dim
    multi_pod = layout is not None and layout.pods > 1
    pspecs = shd.recsys_param_specs(shapes)
    bspec = shd.recsys_batch_spec(multi_pod)
    probe = input_maker(1, None, "meta") if input_maker is not None else ()
    n_inputs, input_specs = len(probe), _input_specs(probe, bspec)
    # across ranks: the tables' reads of a row shard, the batch split over "dp"
    sharded = layout is not None and layout.world_size > 1
    reads = rec_mod.ShardedReads(layout) if sharded else rec_mod.LOCAL_READS

    if info["kind"] == "retrieval":
        N = info["n_candidates"]

        def retrieval(query, cand):
            if sharded:
                return rec_mod.retrieval_scores_sharded(query, cand, layout, top_k=100)
            return rec_mod.retrieval_scores(query, cand, top_k=100)

        def make_args(generator, device="cuda", params=None):
            dev = resolve_device(device)
            if dev.type == "meta":
                return (torch.empty((B, emb_dim), device=dev),
                        torch.empty((N, emb_dim), device=dev))
            return (torch.randn((B, emb_dim), generator=generator, device=dev),
                    torch.randn((N, emb_dim), generator=generator, device=dev))

        return Cell(cfg.name, shape_name, "retrieval", retrieval, make_args,
                    model_flops=2.0 * B * N * emb_dim,
                    arg_specs=((None, None), shd.table_rows_spec()),
                    arg_roles=("query", "candidates"))

    table_bytes = 4.0 * sum(
        float(np.prod(s)) for k, s in shapes.items()
        if k.endswith("table") or k == "linear_w")
    n_fields = cfg.embedding.n_fields if hasattr(cfg, "embedding") else 2
    lookup_bytes = 4.0 * B * n_fields * emb_dim   # psum of gathered rows

    if info["kind"] == "serve":
        def serve(params, *inputs):
            """The logits of the rank's batch rows."""
            return forward_fn(cfg, params, *inputs, reads=reads)

        def make_args(generator, device="cuda", params=None):
            dev = resolve_device(device)
            params = _params(cfg, generator, dev) if params is None else params
            return (params, *input_maker(B, generator, dev))

        return Cell(cfg.name, shape_name, "serve", serve, make_args,
                    model_flops=flops_fn(B, False), model_coll_bytes=lookup_bytes,
                    arg_specs=(pspecs, *input_specs),
                    arg_roles=("params",) + ("inputs",) * n_inputs)

    # train: the tables' SGD touches only the rows the batch reads (their
    # sparse gradients from the row-gradient kernel), in place; the dense
    # parameters get AdamW, functionally, over a state of the dense ones only.
    # Across ranks the loss is the global batch's mean (each rank's mean ÷
    # the "dp" size, summed over "dp"), a table shard's gradient already sums
    # every data replica's items, and the dense gradients are summed over
    # "dp": the ranks of one "model" group repeat one dense path on the same
    # rows, so every rank applies the same bits.
    _, dense_shapes = _split_table_params(shapes)

    def train_step(params, opt_state, labels, *inputs):
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        loss = rec_mod.bce_loss(forward_fn(cfg, leaves, *inputs, reads=reads), labels)
        if sharded:
            n_dp = len(layout.group("dp")[1])
            loss = coll.psum(loss * (1.0 / n_dp), layout, "dp")
        names = sorted(leaves)
        grads = dict(zip(names, torch.autograd.grad(loss, [leaves[k] for k in names])))
        tab_g, dense_g = _split_table_params(grads)
        if sharded:
            all_reduce_grads_(dense_g, layout, "dp")
        tab_p, dense_p = _split_table_params(params)
        for k in tab_p:
            rec_mod.sgd_rows_(tab_p[k], tab_g[k], TABLE_LR)
        new_dense, opt_state = DENSE_OPT.update(dense_g, opt_state, dense_p)
        return {**tab_p, **new_dense}, opt_state, loss.detach()

    def make_args(generator, device="cuda", params=None):
        """(params, opt_state, labels [B] f32 in {0, 1}, *inputs): AdamW's
        state over the dense parameters only, zeros at step 0, as a dict
        (JAX's ``{"step", "m", "v"}``). ``params`` given are used as they
        are (their tables are then updated in place by the step)."""
        dev = resolve_device(device)
        params = _params(cfg, generator, dev) if params is None else params
        dense = {k: params[k] for k in sorted(dense_shapes)}
        zeros = lambda: {k: torch.zeros_like(v) for k, v in dense.items()}
        opt_state = {"step": torch.zeros((), dtype=torch.int32, device=dev),
                     "m": zeros(), "v": zeros()}
        labels = torch.empty((B,), device=dev) if dev.type == "meta" else \
            torch.randint(0, 2, (B,), generator=generator, device=dev).to(torch.float32)
        return (params, opt_state, labels, *input_maker(B, generator, dev))

    dense_specs = {k: pspecs[k] for k in sorted(dense_shapes)}
    opt_specs = {"step": (), "m": dense_specs, "v": dense_specs}
    return Cell(cfg.name, shape_name, "train", train_step, make_args,
                model_flops=flops_fn(B, True), donate=(0, 1),
                # JAX's formula: lookup psum fwd + dense table-grad reduce over
                # "data" + dense-param grad all-reduce
                model_coll_bytes=2 * lookup_bytes + table_bytes,
                arg_specs=(pspecs, opt_specs, (bspec[0],), *input_specs),
                arg_roles=("params", "opt_state", "labels") + ("inputs",) * n_inputs)


# ===========================================================================
# LM family
# ===========================================================================

LM_SHAPES = {
    "train_4k": dict(seq_len=4096, global_batch=256, kind="train"),
    "prefill_32k": dict(seq_len=32768, global_batch=32, kind="prefill"),
    "decode_32k": dict(seq_len=32768, global_batch=128, kind="decode"),
    "long_500k": dict(seq_len=524288, global_batch=1, kind="decode"),
}

def _dp_size(layout) -> int:
    return 1 if layout is None else layout.data * layout.pods


def _lm_attn_flops(cfg, seq: int, tokens: int, bwd: bool) -> float:
    """QK^T + PV over an average causal window of S/2: 4·L·H·dh·(S/2) per token."""
    per_tok = 4.0 * cfg.n_layers * cfg.n_heads * cfg.d_head * (seq / 2.0)
    return per_tok * tokens * (3.0 if bwd else 1.0)


def lm_train_flops(cfg, batch: int, seq: int) -> float:
    """6·N_active·T + causal attention term (fwd+bwd = 3× fwd)."""
    tokens = batch * seq
    return 6.0 * cfg.n_active_params * tokens + _lm_attn_flops(cfg, seq, tokens, True)


def _microbatches(tokens, labels, n_micro: int, layout):
    """[n_micro, rows, S] tokens and labels of the step's microbatches: JAX's
    ``reshape(n_micro, B // n_micro, S)`` of the global batch. Across ranks
    the rank takes its "dp" block of each microbatch's rows; where there is
    more than one microbatch those are not the rows it holds, so the batch
    (tokens and labels stacked, int32) is first all-gathered over "dp"."""
    S = tokens.shape[1]
    n_dp = 1 if layout is None else layout.pods * layout.data
    if n_dp == 1 or n_micro == 1:
        return (tokens.reshape(n_micro, tokens.shape[0] // n_micro, S),
                labels.reshape(n_micro, labels.shape[0] // n_micro, S))
    both = coll.all_gather(torch.stack([tokens, labels]), layout, "dp")   # [n_dp, 2, B/dp, S]
    both = both.permute(1, 0, 2, 3).reshape(2, n_micro, -1, S)
    rows = both.shape[2] // n_dp
    if rows * n_dp != both.shape[2]:
        raise ValueError(f"a microbatch of {both.shape[2]} rows does not split over {n_dp} "
                         "data-parallel ranks")
    i = coll.group_index(layout, "dp")
    return both[:, :, i * rows:(i + 1) * rows].unbind(0)


def _sum_replicated_grads_(grads, specs, layout) -> None:
    """Sum in place the LM gradients ``grads`` (the rank's blocks, leaves in
    order, with their ``specs``) over the data-parallel ranks that replicate
    them: over "dp" where the spec does not split "data", over "pod" where it
    does (the FSDP gather's reduce-scatter summed "data" already); one flat
    buffer a group."""
    over = {"dp": {}, "pod": {}}
    for i, (g, spec) in enumerate(zip(grads, specs)):
        split = {a for entry in spec for a in shd._axes(entry)}
        over["pod" if "data" in split else "dp"][str(i)] = g
    for name, part in over.items():
        n = layout.pods * (layout.data if name == "dp" else 1)
        if part and n > 1:
            all_reduce_grads_(part, layout, name)


def _lm_params(cfg, generator, dev, dtype):
    """``cfg``'s parameter tree on ``dev`` in ``dtype``: drawn by
    ``init_params``, or empty ``meta`` tensors of the same shapes."""
    if dev.type == "meta":
        return tf_mod.tree_map(lambda s: torch.empty(s, dtype=dtype, device=dev),
                               tf_mod.param_shapes(cfg))
    return tf_mod.init_params(cfg, generator, dev, dtype)


def _tokens(cfg, shape, generator, dev):
    if dev.type == "meta":
        return torch.empty(shape, dtype=torch.int32, device=dev)
    return torch.randint(0, cfg.vocab_size, shape, generator=generator, device=dev,
                         dtype=torch.int32)


def build_lm_cell(cfg, shape_name: str, layout=None, micro_per_device: int = 2,
                  batch: Optional[int] = None) -> Cell:
    """``batch`` (default: the shape's global batch) sets the batch of a cut
    cell (``one_rank_cut``)."""
    info = LM_SHAPES[shape_name]
    S, B = info["seq_len"], info["global_batch"] if batch is None else batch
    kind = info["kind"]
    multi_pod = layout is not None and layout.pods > 1
    param_specs = shd.lm_param_specs(cfg)
    batch_spec = shd.lm_batch_spec(multi_pod)

    sharded = layout is not None and layout.world_size > 1
    lay = layout if sharded else None        # the layout the model functions take

    if kind == "train":
        dp = _dp_size(layout)
        n_micro = max(1, B // (dp * micro_per_device))
        assert B % n_micro == 0
        opt = AdamW(lr=functools.partial(
            schedules.wsd, peak_lr=1e-3, warmup_steps=2000,
            stable_steps=100_000, decay_steps=10_000))

        def train_step(params, opt_state, tokens, labels):
            mb_tok, mb_lab = _microbatches(tokens, labels, n_micro, lay)
            grads, losses = None, []
            for i in range(n_micro):
                leaves = tf_mod.tree_map(lambda p: p.detach().requires_grad_(True), params)
                loss = tf_mod.lm_loss(cfg, tf_mod.tree_map(lambda p: p.to(cfg.dtype), leaves),
                                      mb_tok[i], mb_lab[i], layout=lay)
                g = torch.autograd.grad(loss, tf_mod.leaves(leaves))
                grads = list(g) if grads is None else [a.add_(b) for a, b in zip(grads, g)]
                losses.append(loss.detach())
            if sharded:
                _sum_replicated_grads_(grads, tf_mod.leaves(param_specs), layout)
            # in place: no second copy of the gradients (JAX's sum, then / n_micro)
            grads = tf_mod.tree_unflatten(params, [x.div_(n_micro) for x in grads])
            params, opt_state = opt.update(grads, opt_state, params, lay, param_specs)
            return params, opt_state, torch.stack(losses).mean()

        def make_args(generator, device="cuda", params=None):
            """(params f32, AdamW state {"step", "m", "v"} at step 0, tokens
            [B, S] int32, labels [B, S] int32), tokens and labels drawn in
            [0, vocab_size)."""
            dev = resolve_device(device)
            if params is None:
                params = _lm_params(cfg, generator, dev, torch.float32)
            else:
                params = tf_mod.tree_map(lambda p: p.to(torch.float32), params)
            zeros = lambda: tf_mod.tree_map(torch.zeros_like, params)
            opt_state = {"step": torch.zeros((), dtype=torch.int32, device=dev),
                         "m": zeros(), "v": zeros()}
            return (params, opt_state, _tokens(cfg, (B, S), generator, dev),
                    _tokens(cfg, (B, S), generator, dev))

        cut = None
        if batch is None and _dp_size(layout) == 1 and n_micro > 1:
            def cut():
                c = build_lm_cell(cfg, shape_name, None, micro_per_device, micro_per_device)
                c.reduced = (f"one microbatch ({micro_per_device} x {S} tokens) of the "
                             f"global batch's {n_micro} (B = {B})")
                return c

        return Cell(
            arch=cfg.name, shape=shape_name, step_kind="train",
            fn=train_step,
            make_args=make_args, model_flops=lm_train_flops(cfg, B, S), donate=(0, 1),
            # FSDP weight all-gathers (bf16, fwd+bwd per microbatch) + f32 grad
            # all-reduce + Megatron-TP activation all-reduces (2/layer, ~3x)
            model_coll_bytes=(2.0 * cfg.n_params * 2 * n_micro
                              + 4.0 * cfg.n_params
                              + 2 * 3 * cfg.n_layers * B * S * cfg.d_model * 2.0),
            note=f"n_micro={n_micro}",
            arg_specs=(param_specs, {"step": (), "m": param_specs, "v": param_specs},
                       batch_spec, batch_spec),
            arg_roles=("params", "opt_state", "tokens", "labels"),
            one_rank_cut=cut,
        )

    if kind in ("prefill", "decode"):
        # Unified serving step over a (sequence-sharded) KV cache: C=4096
        # chunks for prefill (Sarathi-style, S/C steps complete the prompt),
        # C=1 for decode. The step made is the prompt's last: the chunk is
        # written at [S - C, S), so it attends the whole cache.
        C = min(4096, S) if kind == "prefill" else 1

        def serve_step(params, tokens, cache, cache_len):
            return tf_mod.serve_step(cfg, params, tokens, cache, cache_len, lay)

        def make_args(generator, device="cuda", params=None):
            """(params in cfg.dtype, tokens [B, C] int32, the cache {"k", "v"}
            [L, B, S, KV, dh] zeros in cfg.dtype, cache_len 0-d int32 = S − C)."""
            dev = resolve_device(device)
            if params is None:
                params = _lm_params(cfg, generator, dev, cfg.dtype)
            else:
                params = tf_mod.tree_map(lambda p: p.to(cfg.dtype), params)
            shape = (cfg.n_layers, B, S, cfg.n_kv_heads, cfg.d_head)
            new = torch.empty if dev.type == "meta" else torch.zeros
            cache = {"k": new(shape, dtype=cfg.dtype, device=dev),
                     "v": new(shape, dtype=cfg.dtype, device=dev)}
            return (params, _tokens(cfg, (B, C), generator, dev), cache,
                    torch.tensor(S - C, dtype=torch.int32, device=dev))

        cache_spec = shd.lm_cache_spec(multi_pod)
        # per step: 2·N_active per token + QK/PV against the cached sequence
        flops = B * C * (2.0 * cfg.n_active_params
                         + 4.0 * cfg.n_layers * cfg.n_heads * cfg.d_head
                         * (S / 2.0 if kind == "prefill" else S))
        return Cell(
            arch=cfg.name, shape=shape_name, step_kind=kind,
            fn=serve_step,
            make_args=make_args, model_flops=flops,
            # param all-gather over "data" (FSDP at serve) + per-layer TP
            # activation all-reduce + LSE combine over the seq-sharded cache
            model_coll_bytes=(2.0 * cfg.n_params
                              + 2 * cfg.n_layers * B * C * cfg.d_model * 2.0
                              + cfg.n_layers * B * cfg.n_heads * C
                              * (cfg.d_head + 2) * 4.0),
            donate=(2,),
            note=f"C={C}" + (f" ({S//C} chunk steps/prompt)" if kind == "prefill" else ""),
            arg_specs=(param_specs, batch_spec, {"k": cache_spec, "v": cache_spec}, ()),
            arg_roles=("params", "tokens", "cache", "cache_len"),
        )

    raise ValueError(shape_name)


def make_lm_arch(cfg, skip_long: bool = True) -> ArchSpec:
    skip = {}
    if skip_long:
        skip["long_500k"] = "pure full-attention arch — sub-quadratic required (DESIGN.md §5)"
    # MoE dispatch buffers scale with the global microbatch → smaller micros
    mpd = 1 if cfg.moe is not None else 2
    return ArchSpec(
        arch_id=cfg.name, family="lm", shapes=LM_SHAPES,
        build=lambda shape, layout: build_lm_cell(cfg, shape, layout, micro_per_device=mpd),
        skip=skip,
    )


# ===========================================================================
# GNN family
# ===========================================================================

GNN_OPT = AdamW(lr=1e-3, weight_decay=0.0)


def _gnn_params(cfg, generator, dev):
    if dev.type == "meta":
        return {k: torch.empty(s, device=dev)
                for k, s in sorted(gnn_mod.param_shapes(cfg).items())}
    return gnn_mod.init_params(cfg, generator, dev)


def _gnn_train_step(loss_fn, layout=None):
    """A train step of ``loss_fn(params, *inputs)``: its gradient, then AdamW.
    Across ranks (``layout``) each rank's gradient is its rows' share: they
    are summed over "world" first, so every rank applies the same bits."""
    def train_step(params, opt_state, *inputs):
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        loss = loss_fn(leaves, *inputs)
        names = sorted(leaves)
        grads = dict(zip(names, torch.autograd.grad(loss, [leaves[k] for k in names])))
        if layout is not None:
            all_reduce_grads_(grads, layout, "world")
        params, opt_state = GNN_OPT.update(grads, opt_state, params)
        return params, opt_state, loss.detach()
    return train_step


def _graph_inputs(shape, N: int, E: int, d_in: int, n_classes: int, generator, dev,
                  graph_pool: bool):
    """Drawn inputs of a full-graph cell, padded as JAX's cell pads them: the
    real nodes first (n_nodes · batch), features N(0, 1) on every row, edges
    between real nodes (within one graph of the batch for ``molecule``),
    the padding edges from and to the last padded node (isolated and masked,
    or in no graph). Returns (feats, src, dst, labels [N], mask [N] f32) or,
    pooled, (feats, src, dst, graph_ids [N], labels [n_graphs])."""
    n_graphs = shape.get("batch", 1)
    per, per_e = shape["n_nodes"], shape["n_edges"]
    n_real, e_real = per * n_graphs, per_e * n_graphs
    if dev.type == "meta":
        e = lambda *s, dt=torch.int32: torch.empty(s, dtype=dt, device=dev)
        feats = e(N, d_in, dt=torch.float32)
        tail = (e(N), e(n_graphs)) if graph_pool else (e(N), e(N, dt=torch.float32))
        return (feats, e(E), e(E)) + tail
    ri = lambda hi, n: torch.randint(0, hi, (n,), generator=generator, device=dev)
    feats = torch.randn((N, d_in), generator=generator, device=dev)
    base = (torch.arange(e_real, device=dev) // per_e) * per if graph_pool else 0
    lo = per if graph_pool else n_real
    src = torch.full((E,), N - 1, dtype=torch.int64, device=dev)
    dst = torch.full((E,), N - 1, dtype=torch.int64, device=dev)
    src[:e_real] = base + ri(lo, e_real)
    dst[:e_real] = base + ri(lo, e_real)
    src, dst = src.to(torch.int32), dst.to(torch.int32)
    if graph_pool:
        gid = torch.full((N,), n_graphs, dtype=torch.int64, device=dev)
        gid[:n_real] = torch.arange(n_real, device=dev) // per
        return feats, src, dst, gid.to(torch.int32), ri(n_classes, n_graphs).to(torch.int32)
    mask = (torch.arange(N, device=dev) < n_real).to(torch.float32)
    return feats, src, dst, ri(n_classes, N).to(torch.int32), mask


def _block_inputs(cfg, sizes, generator, dev):
    """Drawn inputs of ``minibatch_lg``: features N(0, 1) per level, each
    level-l node's fanout row the indices of its own slots in level l+1
    (i · fanout + j, as a full sampler draw lays them out) with about one in
    ten −1 (padding), and labels."""
    fan = cfg.fanouts
    if dev.type == "meta":
        return ([torch.empty((n, cfg.d_in), device=dev) for n in sizes],
                [torch.empty((sizes[i], fan[i]), dtype=torch.int32, device=dev)
                 for i in range(len(fan))],
                torch.empty((sizes[0],), dtype=torch.int32, device=dev))
    feats = [torch.randn((n, cfg.d_in), generator=generator, device=dev) for n in sizes]
    neigh = []
    for i, f in enumerate(fan):
        nb = torch.arange(sizes[i] * f, device=dev, dtype=torch.int32).reshape(sizes[i], f)
        drop = torch.rand((sizes[i], f), generator=generator, device=dev) < 0.1
        neigh.append(torch.where(drop, torch.full_like(nb, -1), nb))
    labels = torch.randint(0, cfg.n_classes, (sizes[0],), generator=generator, device=dev,
                           dtype=torch.int32)
    return feats, neigh, labels


def build_gnn_cell(cfg, shape_name: str, shape: Dict[str, Any], layout=None) -> Cell:
    multi_pod = layout is not None and layout.pods > 1
    lay = None if layout is None or layout.world_size == 1 else layout
    pspecs = shd.gnn_param_specs(gnn_mod.param_shapes(cfg))
    opt_specs = {"step": (), "m": pspecs, "v": pspecs}
    rows = shd.gnn_rows_spec(multi_pod)
    d_in, d_h = cfg.d_in, cfg.d_hidden

    def state(generator, dev, params):
        params = _gnn_params(cfg, generator, dev) if params is None else params
        zeros = lambda: {k: torch.zeros_like(v) for k, v in params.items()}
        return params, {"step": torch.zeros((), dtype=torch.int32, device=dev),
                        "m": zeros(), "v": zeros()}

    if shape_name in ("full_graph_sm", "ogb_products", "molecule"):
        n_graphs = shape.get("batch", 1)
        # pad nodes/edges to divide both meshes (padding nodes are isolated and
        # masked; padding edges point src/dst at a padded node)
        N = shd.round_up(shape["n_nodes"] * n_graphs, 512)
        E = shd.round_up(shape["n_edges"] * n_graphs, 512)
        graph_pool = shape_name == "molecule"

        if graph_pool:
            # disjoint-union batching: graph_ids map nodes → graph for readout
            graph_spec = (shd.divisible_rows_spec(n_graphs, layout, multi_pod)
                          if layout is not None else (None,))

            def pool_loss(p, feats, src, dst, graph_ids, labels):
                if lay is not None:             # every rank's block of the labels
                    labels = coll.all_assemble(labels, graph_spec, lay)
                return gnn_mod.loss_graph_pool(cfg, p, feats, src, dst, graph_ids, n_graphs,
                                               labels, lay)

            train_step = _gnn_train_step(pool_loss, lay)
            in_specs = ((rows[0], None), rows, rows, rows, graph_spec)
            roles = ("feats", "edges", "edges", "graph_ids", "labels")
        else:
            train_step = _gnn_train_step(
                lambda p, feats, src, dst, labels, mask: gnn_mod.loss_full(
                    cfg, p, feats, src, dst, labels, mask, lay), lay)
            in_specs = ((rows[0], None), rows, rows, rows, rows)
            roles = ("feats", "edges", "edges", "labels", "mask")

        def make_args(generator, device="cuda", params=None):
            dev = resolve_device(device)
            return state(generator, dev, params) + _graph_inputs(
                shape, N, E, d_in, cfg.n_classes, generator, dev, graph_pool)

        flops = 3 * (2 * N * (d_in * d_h * 2) + 2 * N * d_h * d_h * 2 * (cfg.n_layers - 1)
                     + 2 * N * d_h * cfg.n_classes)
        return Cell(cfg.name, shape_name, "train",
                    train_step, make_args,
                    model_flops=float(flops), donate=(0, 1),
                    # cross-shard message halo: ~every edge crosses shards at
                    # random placement (fwd + bwd gather/scatter)
                    model_coll_bytes=3.0 * E * (d_in + d_h) * 4.0,
                    arg_specs=(pspecs, opt_specs) + in_specs,
                    arg_roles=("params", "opt_state") + roles)

    if shape_name == "minibatch_lg":
        Bn = shape["batch_nodes"]
        fan = cfg.fanouts
        sizes = [Bn]
        for f in fan:
            sizes.append(sizes[-1] * f)
        train_step = _gnn_train_step(
            lambda p, feats, neigh, labels: gnn_mod.loss_sampled(cfg, p, feats, neigh, labels,
                                                                 lay), lay)

        def make_args(generator, device="cuda", params=None):
            dev = resolve_device(device)
            return state(generator, dev, params) + _block_inputs(cfg, sizes, generator, dev)

        # layer 0 (d_in→d_h, self+neigh mats) over levels 0..L-1; deeper layers
        # (d_h→d_h) over shrinking level sets; classifier over the seeds
        tot = sum(sizes)
        flops = 3.0 * (
            2 * sum(sizes[:-1]) * cfg.d_in * d_h * 2
            + sum(2 * sum(sizes[: cfg.n_layers - l]) * d_h * d_h * 2
                  for l in range(1, cfg.n_layers))
            + 2 * sizes[0] * d_h * cfg.n_classes)
        level = (rows[0], None)
        return Cell(cfg.name, shape_name, "train",
                    train_step, make_args,
                    model_flops=float(flops), donate=(0, 1),
                    model_coll_bytes=3.0 * tot * cfg.d_in * 4.0,
                    note="padded bipartite blocks (real sampler feeds these)",
                    arg_specs=(pspecs, opt_specs, [level] * len(sizes), [level] * len(fan),
                               rows),
                    arg_roles=("params", "opt_state", "feats", "neigh", "labels"))

    raise ValueError(shape_name)
