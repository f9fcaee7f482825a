"""peacock-lda: the paper's own architecture as a config (port of the
constants and the ring geometry of ``repro.configs.peacock_lda``).

Production scale follows §4.1/§5.1: V = 2.1×10⁵ (SOSO vocabulary), K = 10⁵
topics, document-aligned segments of 4,096-doc data shards. The dry-run
``ArchSpec``/``Cell`` machinery of the JAX module is not ported.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import distributed as dist

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
