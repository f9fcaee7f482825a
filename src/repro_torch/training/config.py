"""``TrainerConfig`` — the typed, validated description of one training
session (port of ``repro.training.config``).

The same fields and checks as the JAX package's, with ``device`` (``"cuda"``
by default, ``"cpu"`` on request) in place of ``kernel_mode``: the device of
the tensors picks each kernel's route. ``from_peacock_lda`` derives the
production-scale session from ``configs/peacock_lda.py``. A session of
several ranks (``n_pods × data_shards × model_shards > 1``, word-sharded
with ``n_model_shards > 1``) runs one ``Trainer`` per rank. Streamed
sessions (``n_segments > 1`` or a ``corpus_dir`` written by
``save_segments``, with ``prefetch`` double-buffering the segment loads) run
on one device or on the ranks of one pod; with ``n_pods > 1`` they are
refused here, as in the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    # ----------------------------------------------------------- corpus ----
    n_docs: int = 3000
    vocab_size: int = 800
    n_topics: int = 32
    true_topics: int = 20          # synthetic generator only
    doc_len_mean: int = 8
    # ------------------------------------------------- data streaming ------
    n_segments: int = 1            # out-of-core segment count (Fig. 3/4 swaps)
    corpus_dir: Optional[str] = None   # a saved segment directory
    prefetch: bool = True          # double-buffer segment host→device loads
    # ------------------------------------------------- mesh / sharding -----
    n_pods: int = 1
    data_shards: int = 1
    model_shards: int = 1
    n_model_shards: int = 1        # word-sharded model parallelism (§10)
    # ---------------------------------------------------------- sampler ----
    sampler: str = "dense"         # "dense" = exact [T, K] plane scan,
                                   # "alias" = sparsity-aware alias-table MH
    n_mh: int = 4                  # MH steps per token (alias sampler)
    device: str = "cuda"           # where the session's tensors live
    # --------------------------------------------------------- schedule ----
    n_epochs: int = 20
    agg_every: int = 3             # aggregation boundary cadence (multi-pod);
                                   # the alias tables' rebuild cadence
    alpha_opt_from: int = 10       # first epoch of the Minka fixed point
    alpha_opt_iters: int = 3
    package_len: int = 0           # pipeline package L; 0 → cap (one package)
    seed: int = 0                  # corpus + sampler seed
    shard_seed: int = 1
    # ------------------------------------------------------------ priors ---
    alpha0: float = 50.0           # α_k init = alpha0 / K (symmetric start)
    beta: float = 0.01
    # ----------------------------------------------------- checkpointing ---
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 5
    ckpt_keep: int = 3
    ckpt_async: bool = False
    resume: bool = False
    # ------------------------------------------------------ dedup/export ---
    dedup_merge_l1: float = 0.3    # cluster-merge threshold (Fig. 7B)
    dedup_dup_l1: float = 0.5      # duplicate-fraction threshold
    # ------------------------------------------------------------- bench ---
    bench_out: Optional[str] = None

    def __post_init__(self) -> None:
        positive = {
            "n_docs": self.n_docs, "vocab_size": self.vocab_size,
            "n_topics": self.n_topics, "true_topics": self.true_topics,
            "doc_len_mean": self.doc_len_mean, "n_pods": self.n_pods,
            "data_shards": self.data_shards, "model_shards": self.model_shards,
            "n_epochs": self.n_epochs, "agg_every": self.agg_every,
            "ckpt_every": self.ckpt_every, "ckpt_keep": self.ckpt_keep,
            "n_segments": self.n_segments,
        }
        for name, v in positive.items():
            if int(v) <= 0:
                raise ValueError(f"TrainerConfig.{name} must be > 0, got {v}")
        if self.n_topics < 2:
            raise ValueError("TrainerConfig.n_topics must be >= 2")
        if self.package_len < 0:
            raise ValueError("TrainerConfig.package_len must be >= 0")
        if not (0.0 < self.beta):
            raise ValueError("TrainerConfig.beta must be > 0")
        if self.alpha0 <= 0.0:
            raise ValueError("TrainerConfig.alpha0 must be > 0")
        if self.sampler not in ("dense", "alias"):
            raise ValueError(
                f"TrainerConfig.sampler must be 'dense' or 'alias', got "
                f"{self.sampler!r}")
        if self.n_mh < 1:
            raise ValueError("TrainerConfig.n_mh must be >= 1")
        if self.device not in ("cuda", "cpu") and not self.device.startswith("cuda:"):
            raise ValueError(
                f"TrainerConfig.device must be 'cuda', 'cuda:N' or 'cpu', got "
                f"{self.device!r}")
        if self.resume and self.ckpt_dir is None:
            raise ValueError("TrainerConfig.resume requires ckpt_dir")
        if self.n_model_shards < 1:
            raise ValueError("TrainerConfig.n_model_shards must be >= 1")
        if self.n_model_shards > 1:
            if self.model_shards != self.n_model_shards:
                raise ValueError(
                    "word-sharded sessions put the model slices on the "
                    f"'model' mesh axis: model_shards ({self.model_shards}) "
                    f"must equal n_model_shards ({self.n_model_shards})")
            if self.package_len != 0:
                raise ValueError(
                    "n_model_shards > 1 samples one package per round "
                    "(bitwise conformance with the replicated path); "
                    "package_len must stay 0 (= cap)")
        if self.n_pods > 1 and (self.n_segments > 1 or self.corpus_dir):
            raise ValueError(
                "segment streaming is single-configuration: n_segments > 1 "
                "or corpus_dir cannot combine with n_pods > 1 (pods already "
                "partition documents; segment a pod's own corpus instead)")

    # ------------------------------------------------------ derived --------
    @property
    def ring_size(self) -> int:
        """M — ring length (= coarse vocab shards = rotation rounds)."""
        if self.n_model_shards > 1:
            return self.data_shards
        return self.data_shards * self.model_shards

    @property
    def n_devices(self) -> int:
        return self.n_pods * self.data_shards * self.model_shards

    @property
    def multi_pod(self) -> bool:
        return self.n_pods > 1

    def replace(self, **kw: Any) -> "TrainerConfig":
        return dataclasses.replace(self, **kw)

    # -------------------------------------------------- derivations --------
    @classmethod
    def from_peacock_lda(cls, n_pods: int = 1, data_shards: int = 16,
                         model_shards: int = 16, **overrides: Any
                         ) -> "TrainerConfig":
        """The paper's production session (configs/peacock_lda.py scale):
        V = 2.1e5 SOSO vocabulary, K = 1e5 topics, 4096-doc data shards on a
        16×16 ring per pod. Anything not pinned by the paper config can be
        overridden (n_epochs, ckpt_dir, device, ...)."""
        from repro_torch.configs import peacock_lda as pl

        base: Dict[str, Any] = dict(
            n_docs=data_shards * model_shards * pl.DOCS_PER_SHARD,
            vocab_size=pl.VOCAB,
            n_topics=pl.K_TOPICS,
            doc_len_mean=max(1, int(round(pl.TOKENS_PER_DOC))),
            n_pods=n_pods, data_shards=data_shards,
            model_shards=model_shards,
            **pl.TRAIN_DEFAULTS,
        )
        base.update(overrides)
        return cls(**base)
