"""The five assigned LM architectures (exact public configs; port of
``repro.configs.lm_archs``).

d_head notes: minicpm/smollm use d_model/n_heads; qwen3 and the MoE archs use
head_dim=128 per their HF configs.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchSpec, make_lm_arch
from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import LMConfig

# [arXiv:2404.06395; hf] — WSD schedule (wired in the train cell builder)
MINICPM_2B = LMConfig(
    name="minicpm-2b", n_layers=40, d_model=2304, n_heads=36, n_kv_heads=36,
    d_head=64, d_ff=5760, vocab_size=122753, tie_embeddings=True,
)

# [hf:HuggingFaceTB/SmolLM-135M]
SMOLLM_135M = LMConfig(
    name="smollm-135m", n_layers=30, d_model=576, n_heads=9, n_kv_heads=3,
    d_head=64, d_ff=1536, vocab_size=49152, tie_embeddings=True,
)

# [hf:Qwen/Qwen3-0.6B] — qk_norm, GQA, head_dim 128
QWEN3_0_6B = LMConfig(
    name="qwen3-0.6b", n_layers=28, d_model=1024, n_heads=16, n_kv_heads=8,
    d_head=128, d_ff=3072, vocab_size=151936, qk_norm=True, rope_theta=1e6,
)

# [hf:microsoft/Phi-3.5-MoE-instruct] — 16 experts top-2, expert-parallel over
# "model" (16 experts / 16 devices)
PHI35_MOE = LMConfig(
    name="phi3.5-moe-42b-a6.6b", n_layers=32, d_model=4096, n_heads=32,
    n_kv_heads=8, d_head=128, d_ff=6400, vocab_size=32064,
    moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=6400, moe_shard="expert"),
)

# [hf:Qwen/Qwen1.5-MoE-A2.7B] — 60 routed top-4 + 4 shared experts; per-expert
# TP over d_ff (1408/16 = 88) since 60 ∤ 16
QWEN2_MOE = LMConfig(
    name="qwen2-moe-a2.7b", n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16,
    d_head=128, d_ff=1408, vocab_size=151936,
    moe=MoEConfig(n_experts=60, top_k=4, d_ff_expert=1408, n_shared_experts=4,
                  d_ff_shared=5632, moe_shard="ffn"),
)

LM_CONFIGS = {c.name: c for c in
              [MINICPM_2B, SMOLLM_135M, QWEN3_0_6B, PHI35_MOE, QWEN2_MOE]}


def specs() -> dict[str, ArchSpec]:
    # all five are pure full-attention → long_500k skipped per assignment rule
    return {name: make_lm_arch(cfg, skip_long=True)
            for name, cfg in LM_CONFIGS.items()}


def small_lm(moe: bool = False) -> LMConfig:
    """Reduced config of the same family for CPU smoke tests."""
    return LMConfig(
        name="small-moe" if moe else "small-dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16, d_ff=128,
        vocab_size=251, qk_norm=moe, tie_embeddings=not moe,
        dtype=torch.float32, remat=False, q_chunk=32, kv_chunk=32, loss_chunk=32,
        moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=32, n_shared_experts=1,
                      d_ff_shared=32) if moe else None,
    )
