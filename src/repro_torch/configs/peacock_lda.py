"""peacock-lda: the paper's own architecture as a config (port of
``repro.configs.peacock_lda``).

Production scale follows §4.1/§5.1: V = 2.1×10⁵ (SOSO vocabulary), K = 10⁵
topics, corpus of 10⁹ queries × 4.5 tokens processed in document-aligned
SEGMENTS (Fig. 3): one segment = 256 data shards × 4096 docs ≈ 1.05M queries.

Cells, each built for one rank of a ``RankLayout`` (``spec().cell``):
  train_segment     — one ring-Gibbs epoch over a resident segment (the
                      paper's SampleSegment, Fig. 4): this rank's epoch of
                      ``core/distributed.build_epoch_body``;
  train_segment_opt — the same with int8 Θ, column-scatter ¬ivd and Θ only
                      for the sampled docs;
  serve_rt          — RT-LDA batched query inference (Eq. 4) against the
                      full K = 10⁵ model: P̂ and the R cache row-sharded
                      over each pod's ring, pkd's columns over "model".
A layout with pods > 1 gives the pod-batched epoch (``core/hierarchy``).
``train_cell`` builds a train cell from any ``RingConfig`` and
``serve_cell`` a serving cell at any vocabulary and K, so the same steps run
at a small ring or a cut V while the production cells are recorded: at
V = 210,000 the Φ of a ring of one, and P̂, are 84 GB and fit no card.
"""
from __future__ import annotations

import math

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchSpec, Cell
from repro_torch.core import distributed as dist
from repro_torch.core import rtlda
from repro_torch.dist import analysis
from repro_torch.dist import sharding as shd

K_TOPICS = 100_000
VOCAB = 210_000
DOCS_PER_SHARD = 4096
TOKENS_PER_DOC = 4.5

# Coordinator-schedule defaults for a production session (§3.1/§4.1):
# aggregation every 3 epochs, Minka α optimization once the sampler has
# burned in, checkpoints at boundary cadence. ``TrainerConfig.from_peacock_lda``
# folds these into the typed session config.
TRAIN_DEFAULTS = dict(agg_every=3, alpha_opt_from=10, alpha_opt_iters=3,
                      ckpt_every=5, alpha0=50.0, beta=0.01)


LDA_SHAPES = {
    "train_segment": dict(n_topics=K_TOPICS, vocab=VOCAB,
                          docs_per_shard=DOCS_PER_SHARD, kind="train"),
    # §Perf hillclimbed variant: int8 Θ + column-scatter ¬ivd (EXPERIMENTS §Perf)
    "train_segment_opt": dict(n_topics=K_TOPICS, vocab=VOCAB,
                              docs_per_shard=DOCS_PER_SHARD, kind="train",
                              optimized=True),
    "serve_rt": dict(n_topics=K_TOPICS, vocab=VOCAB, batch=1024, query_len=8,
                     kind="serve"),
}


def ring_config(n_devices: int = 1, optimized: bool = False) -> dist.RingConfig:
    """The production ring's geometry for a ring of ``n_devices`` (the JAX
    version reads M from its mesh). ``optimized`` is the hill-climbed
    variant: int8 Θ, column-scatter ¬ivd and Θ only for the sampled docs."""
    M = int(n_devices)
    rows = math.ceil(VOCAB / M)
    cap = int(math.ceil(DOCS_PER_SHARD * TOKENS_PER_DOC / M / 8) * 8)
    cap = max(cap, 8)
    return dist.RingConfig(
        n_topics=K_TOPICS, vocab_size=VOCAB, rows_per_shard=rows,
        docs_per_shard=DOCS_PER_SHARD, cap=cap, package_len=cap,
        n_rounds=M, sampler="dense",
        theta_dtype=torch.int8 if optimized else torch.int32,
        column_exclusion=optimized,
        small_theta=optimized,
    )


def _ring_args(cfg: dist.RingConfig, n_pods: int, generator, device):
    """Global epoch arguments (phi, psi, wl, dl, uid, z, alpha, beta, seed)
    of the ring ``cfg`` (with a leading [pods] dim when ``n_pods > 1``). On
    ``meta``: empty stand-ins (beta and seed 0-dim). Else a synthetic
    segment with every slot a token: words uniform over each shard's rows,
    docs over the shard's docs, z uniform, uids counting up; Φ and Ψ its
    counts, the same in every pod."""
    dev = resolve_device(device)
    M, K, rows, cap = cfg.n_rounds, cfg.n_topics, cfg.rows_per_shard, cfg.cap
    lead = (n_pods,) if n_pods > 1 else ()
    stack = lead + (M, M, cap)
    if dev.type == "meta":
        i32 = lambda shape: torch.empty(shape, dtype=torch.int32, device=dev)
        return (i32(lead + (M, rows, K)), i32(lead + (K,)), i32(stack), i32(stack),
                torch.empty(stack, dtype=torch.int64, device=dev), i32(stack),
                torch.empty((K,), device=dev), torch.empty((), device=dev),
                torch.empty((), dtype=torch.int32, device=dev))
    draw = lambda hi: torch.randint(0, hi, (M, M, cap), generator=generator, device=dev,
                                    dtype=torch.int32)
    wl, dl, z = draw(rows), draw(cfg.docs_per_shard), draw(K)
    uid = torch.arange(M * M * cap, dtype=torch.int64, device=dev).reshape(M, M, cap)
    phi = torch.zeros((M, rows, K), dtype=torch.int32, device=dev)
    for m in range(M):          # sub-block m of every stack lives in vocab shard m
        phi[m].index_put_((wl[:, m].reshape(-1).long(), z[:, m].reshape(-1).long()),
                          torch.ones((), dtype=torch.int32, device=dev), accumulate=True)
    psi = torch.bincount(z.reshape(-1).long(), minlength=K).to(torch.int32)
    if n_pods > 1:
        rep = lambda t: t[None].repeat((n_pods,) + (1,) * t.dim())
        phi, psi, wl, dl, uid, z = (rep(t) for t in (phi, psi, wl, dl, uid, z))
    alpha = torch.full((K,), TRAIN_DEFAULTS["alpha0"] / K, device=dev)
    return phi, psi, wl, dl, uid, z, alpha, TRAIN_DEFAULTS["beta"], 7


def train_cell(cfg: dist.RingConfig, layout=None, n_pods: int = 1,
               shape: str = "train_segment") -> Cell:
    """The train cell of ring ``cfg`` for one rank of ``layout`` (None: a ring
    of one device): ``fn`` is that rank's epoch, its arguments the global
    arrays of JAX's cell (uid int64 holding uint32 values, where JAX's is
    uint32), ``arg_specs`` their layouts. The formulas are JAX's."""
    multi_pod = n_pods > 1
    lay = layout if layout is not None and layout.world_size > 1 else None
    fn = dist.build_epoch_body(cfg, lay, pod_axis=multi_pod)
    M, K, cap = cfg.n_rounds, cfg.n_topics, cfg.cap
    sp = dist.specs(cfg.model_shards, pod_axis=multi_pod)
    stk = sp["stack"]
    optimized = cfg.column_exclusion
    sampled_tokens = n_pods * M * M * cap
    # per (token, topic): 3 log-plane reads ≈ 3 log + 2 add + gumbel(≈6) + cmp
    flops = 12.0 * sampled_tokens * K
    # ring traffic: each device ships its 4 int32 [M, cap] stack arrays
    # (16·M·cap bytes) every round; M devices × M rounds → 16·M³·cap per
    # epoch, plus one Ψ psum per segment
    coll = n_pods * (16.0 * M ** 3 * cap + M * K * 4.0)
    # §9: dense plane-scan vs alias-MH HBM traffic, side by side
    traffic = analysis.sampler_epoch_bytes(
        n_tokens=sampled_tokens, n_topics=K, k_d=TOKENS_PER_DOC,
        n_mh=4, vocab=cfg.vocab_size, rebuild_epochs=TRAIN_DEFAULTS["agg_every"])
    return Cell(
        arch="peacock-lda", shape=shape, step_kind="lda_train", fn=fn,
        make_args=lambda generator=None, device="cuda", params=None:
            _ring_args(cfg, n_pods, generator, device),
        model_flops=flops, model_coll_bytes=coll, donate=(0, 2, 3, 4, 5),
        note=f"M={M} ring, cap={cap}, segment={M * cfg.docs_per_shard} docs"
             + (", int8-Θ+col-excl" if optimized else "")
             + (f", {n_pods} pods" if multi_pod else ""),
        extra={"sampler_traffic": traffic},
        arg_specs=(sp["phi"], sp["psi"], stk, stk, stk, stk, (), (), ()),
        arg_roles=("phi", "psi", "stacks", "stacks", "stacks", "stacks", "alpha", "beta",
                   "seed"))


def _train_cell(layout, optimized: bool = False) -> Cell:
    layout = layout if layout is not None else shd.RankLayout(1, 1, 1)
    cfg = ring_config(shd.ring_size(layout), optimized)
    return train_cell(cfg, layout, n_pods=layout.pods,
                      shape="train_segment_opt" if optimized else "train_segment")


def _serve_args(vocab: int, n_topics: int, batch: int, query_len: int, generator, device):
    """Global arguments (pvk, alpha, r_topic, r_value, word_ids) of a
    serving cell: V padded to a multiple of 512 (JAX's divisibility pad). On
    ``meta``: empty stand-ins. Else a serving model built
    (``rtlda.build_model``, β and α₀ of ``TRAIN_DEFAULTS``) from the counts
    of a synthetic corpus of max(batch, vocab) documents of 1 … query_len
    tokens, each document's tokens on one topic drawn uniformly, words
    uniform over the vocabulary; the queries are its first ``batch``
    documents, −1 padded to ``query_len``."""
    dev = resolve_device(device)
    vpad = shd.round_up(vocab, 512)
    if dev.type == "meta":
        e = lambda shape, dt=torch.float32: torch.empty(shape, dtype=dt, device=dev)
        return (e((vpad, n_topics)), e((n_topics,)), e((vpad,), torch.int32), e((vpad,)),
                e((batch, query_len), torch.int32))
    n_docs = max(batch, vocab)
    draw = lambda hi, shape: torch.randint(0, hi, shape, generator=generator, device=dev,
                                           dtype=torch.int64)
    lengths = draw(query_len, (n_docs,)) + 1
    topics = draw(n_topics, (n_docs, 1)).expand(n_docs, query_len)
    words = draw(vocab, (n_docs, query_len))
    slot = torch.arange(query_len, device=dev)[None, :] < lengths[:, None]
    phi = torch.zeros((vpad, n_topics), dtype=torch.int32, device=dev)
    phi.index_put_((words[slot], topics[slot]), torch.ones((), dtype=torch.int32, device=dev),
                   accumulate=True)
    alpha = torch.full((n_topics,), TRAIN_DEFAULTS["alpha0"] / n_topics, device=dev)
    model = rtlda.build_model(phi, torch.tensor(TRAIN_DEFAULTS["beta"]), alpha, dev)
    del phi
    queries = torch.where(slot, words, -1)[:batch].to(torch.int32)
    return model.pvk, model.alpha, model.r_topic, model.r_value, queries


def serve_cell(vocab: int, n_topics: int, layout=None, batch: int = 1024,
               query_len: int = 8) -> Cell:
    """The RT-LDA serving cell (JAX's ``_serve_cell``: seed 17, 2 trials × 5
    hill steps) at ``vocab`` words and ``n_topics`` topics, for one rank of
    ``layout`` (None: one rank). Its arguments are global, P̂ and the R cache
    row-sharded over the ring by ``arg_specs``; the step returns the rank's
    [batch, n_topics / model] columns of pkd (JAX's ``P(None, "model")``)."""
    B, Ld = batch, query_len

    def serve(pvk, alpha, r_topic, r_value, word_ids):
        model = rtlda.RTLDAModel(pvk=pvk, alpha=alpha, r_topic=r_topic, r_value=r_value)
        return rtlda.rtlda_infer_batch(model, word_ids, seed=17, n_iters=5, n_trials=2,
                                       layout=layout)

    return Cell(
        arch="peacock-lda", shape="serve_rt", step_kind="lda_serve", fn=serve,
        make_args=lambda generator=None, device="cuda", params=None:
            _serve_args(vocab, n_topics, B, Ld, generator, device),
        model_flops=2.0 * B * (5 * 2) * Ld * Ld * 8.0,
        model_coll_bytes=5 * 2 * B * Ld * Ld * 4.0,
        note="Eq.4 candidate-set hill climb, 2 trials × 5 iters",
        # word_ids replicated is fine (8k ints); pvk row-sharded over the ring
        arg_specs=(shd.ring_spec(None), (), shd.ring_spec(), shd.ring_spec(), ()),
        arg_roles=("pvk", "alpha", "r_cache", "r_cache", "word_ids"))


def _serve_cell(layout) -> Cell:
    info = LDA_SHAPES["serve_rt"]
    return serve_cell(VOCAB, K_TOPICS, layout, info["batch"], info["query_len"])


def spec() -> ArchSpec:
    def build(shape_name, layout):
        if shape_name == "train_segment":
            return _train_cell(layout)
        if shape_name == "train_segment_opt":
            return _train_cell(layout, optimized=True)
        return _serve_cell(layout)

    return ArchSpec(arch_id="peacock-lda", family="lda", shapes=LDA_SHAPES, build=build)
