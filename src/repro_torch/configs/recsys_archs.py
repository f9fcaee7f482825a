"""The four recsys architectures with their public configs (the port's copy of
the constants of ``repro.configs.recsys_archs``).

dlrm-mlperf uses the public MLPerf Criteo-1TB per-table vocab sizes
(40M row cap, 26 tables, ≈188M rows total). xdeepfm/autoint use the standard
Criteo-39-field setup (13 bucketized dense + 26 categorical, hashed to ≤1e6
buckets per field — the practice in the xDeepFM/AutoInt papers). din uses an
industrial-scale 1M-item catalog with a 100-interaction history.

The ``_*_flops(B, train)`` functions count the useful operations of a batch
(a train step: 3× the forward), for achieved FLOP/s. The input makers draw
a batch of real inputs on a device, and ``specs()`` gives each arch's
``ArchSpec``, whose cells (``serve_*``, ``train_batch``,
``retrieval_cand``) come from ``configs.base.build_recsys_cell``.
"""
from __future__ import annotations

import functools
from typing import Tuple

import torch

from repro_torch.configs.base import RECSYS_SHAPES, ArchSpec, build_recsys_cell
from repro_torch.models import recsys as rec

# public MLPerf DLRM (Criteo 1TB, day 0-23, 40M cap) table sizes
MLPERF_TABLE_SIZES = (
    39884406, 39043, 17289, 7420, 20263, 3, 7120, 1543, 63, 38532951,
    2953546, 403346, 10, 2208, 11938, 155, 4, 976, 14, 39979771,
    25641295, 39664984, 585935, 12972, 108, 36,
)

# Criteo-39: 13 bucketized dense (100 buckets) + 26 categorical (hashed ≤1e6)
CRITEO39_SIZES = tuple([100] * 13 + [
    1000000, 1000000, 1000000, 1000000, 1000000,
    100000, 100000, 100000, 100000, 100000, 100000, 100000, 100000,
    10000, 10000, 10000, 10000, 10000, 10000,
    1000, 1000, 1000, 1000, 100, 100, 100,
])

DLRM = rec.DLRMConfig(
    name="dlrm-mlperf",
    embedding=rec.EmbeddingSpec(vocab_sizes=MLPERF_TABLE_SIZES, dim=128),
    n_dense=13, bot_mlp=(13, 512, 256, 128), top_mlp=(1024, 1024, 512, 256, 1),
)
XDEEPFM = rec.XDeepFMConfig(
    name="xdeepfm",
    embedding=rec.EmbeddingSpec(vocab_sizes=CRITEO39_SIZES, dim=10),
    cin_layers=(200, 200, 200), mlp=(400, 400),
)
DIN = rec.DINConfig(
    name="din", n_items=1_000_000, embed_dim=18, seq_len=100,
    attn_mlp=(80, 40), mlp=(200, 80), n_context=4, context_vocab=10_000,
)
AUTOINT = rec.AutoIntConfig(
    name="autoint",
    embedding=rec.EmbeddingSpec(vocab_sizes=CRITEO39_SIZES, dim=16),
    n_attn_layers=3, n_heads=2, d_attn=32,
)


def _mlp_flops(dims: Tuple[int, ...]) -> float:
    return float(sum(2 * dims[i] * dims[i + 1] for i in range(len(dims) - 1)))


def _dlrm_flops(B: int, train: bool) -> float:
    F, D = DLRM.embedding.n_fields, DLRM.embedding.dim
    fwd = (_mlp_flops(DLRM.bot_mlp)
           + 2 * (F + 1) * (F + 1) * D
           + _mlp_flops((D + (F + 1) * F // 2,) + DLRM.top_mlp))
    return B * fwd * (3.0 if train else 1.0)


def _xdeepfm_flops(B: int, train: bool) -> float:
    F, D = XDEEPFM.embedding.n_fields, XDEEPFM.embedding.dim
    h_prev, cin = F, 0.0
    for h in XDEEPFM.cin_layers:
        cin += 2.0 * h * h_prev * F * D
        h_prev = h
    fwd = cin + _mlp_flops((F * D,) + XDEEPFM.mlp + (1,))
    return B * fwd * (3.0 if train else 1.0)


def _din_flops(B: int, train: bool) -> float:
    D, S = DIN.embed_dim, DIN.seq_len
    attn = S * _mlp_flops((4 * D,) + DIN.attn_mlp + (1,))
    fwd = attn + _mlp_flops((D * (2 + DIN.n_context),) + DIN.mlp + (1,))
    return B * fwd * (3.0 if train else 1.0)


def _autoint_flops(B: int, train: bool) -> float:
    F, D = AUTOINT.embedding.n_fields, AUTOINT.embedding.dim
    d_in, fwd = D, 0.0
    for _ in range(AUTOINT.n_attn_layers):
        fwd += 2.0 * F * d_in * AUTOINT.d_attn * 4        # q,k,v,res proj
        fwd += 2.0 * F * F * AUTOINT.d_attn * 2           # scores + mix
        d_in = AUTOINT.d_attn
    fwd += 2.0 * F * d_in
    return B * fwd * (3.0 if train else 1.0)


def _empty(shape, dtype, device):
    return torch.empty(shape, dtype=dtype, device=device)


def _field_ids(sizes, B, g, device):
    """[B, len(sizes)] int32: field f's ids uniform in [0, sizes[f])."""
    dev = torch.device(device)
    if dev.type == "meta":
        return _empty((B, len(sizes)), torch.int32, dev)
    u = torch.rand((B, len(sizes)), generator=g, device=dev, dtype=torch.float64)
    v = torch.tensor(sizes, dtype=torch.float64, device=dev)
    return (u * v).floor().to(torch.int32)


def _sparse_inputs(vocab_sizes):
    """Maker of xdeepfm's and autoint's input: (ids [B, F] int32,)."""
    def maker(B, g, device):
        return (_field_ids(vocab_sizes, B, g, device),)
    return maker


def _dlrm_inputs(B, g, device, cfg=DLRM):
    """(dense [B, 13] f32 N(0, 1), ids [B, 26] int32)."""
    dev = torch.device(device)
    dense = _empty((B, cfg.n_dense), torch.float32, dev) if dev.type == "meta" else \
        torch.randn((B, cfg.n_dense), generator=g, device=dev)
    return dense, _field_ids(cfg.embedding.vocab_sizes, B, g, dev)


def _din_inputs(B, g, device, cfg=DIN):
    """(target [B] int32, history [B, S] int32 with a uniform length in
    [1, S] and −1 after it, context [B, n_context] int32)."""
    dev = torch.device(device)
    S = cfg.seq_len
    if dev.type == "meta":
        return (_empty((B,), torch.int32, dev), _empty((B, S), torch.int32, dev),
                _empty((B, cfg.n_context), torch.int32, dev))
    target = torch.randint(0, cfg.n_items, (B,), generator=g, device=dev, dtype=torch.int32)
    hist = torch.randint(0, cfg.n_items, (B, S), generator=g, device=dev, dtype=torch.int32)
    length = torch.randint(1, S + 1, (B, 1), generator=g, device=dev)
    hist[torch.arange(S, device=dev)[None, :] >= length] = -1
    ctx = torch.randint(0, cfg.context_vocab, (B, cfg.n_context), generator=g, device=dev,
                        dtype=torch.int32)
    return target, hist, ctx


def specs() -> dict:
    table = {
        "dlrm-mlperf": (DLRM, rec.dlrm_forward, _dlrm_inputs, _dlrm_flops),
        "xdeepfm": (XDEEPFM, rec.xdeepfm_forward,
                    _sparse_inputs(CRITEO39_SIZES), _xdeepfm_flops),
        "din": (DIN, rec.din_forward, _din_inputs, _din_flops),
        "autoint": (AUTOINT, rec.autoint_forward,
                    _sparse_inputs(CRITEO39_SIZES), _autoint_flops),
    }
    out = {}
    for name, (cfg, fwd, maker, flops) in table.items():
        out[name] = ArchSpec(
            arch_id=name, family="recsys", shapes=RECSYS_SHAPES,
            build=functools.partial(build_recsys_cell, cfg, fwd, maker, flops),
        )
    return out


def small_recsys():
    """Reduced same-family configs for smoke tests."""
    spec8 = rec.EmbeddingSpec(vocab_sizes=tuple([50] * 8), dim=8)
    return {
        "dlrm-mlperf": rec.DLRMConfig(
            name="dlrm-small", embedding=rec.EmbeddingSpec(tuple([50] * 6), 8),
            n_dense=5, bot_mlp=(5, 16, 8), top_mlp=(32, 16, 1)),
        "xdeepfm": rec.XDeepFMConfig(
            name="xdeepfm-small", embedding=spec8, cin_layers=(10, 10), mlp=(16, 8)),
        "din": rec.DINConfig(
            name="din-small", n_items=200, embed_dim=8, seq_len=12,
            attn_mlp=(16, 8), mlp=(16, 8), n_context=2, context_vocab=50),
        "autoint": rec.AutoIntConfig(
            name="autoint-small", embedding=spec8, n_attn_layers=2, n_heads=2,
            d_attn=8),
    }
