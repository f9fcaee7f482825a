"""``repro_torch.training`` — the typed Trainer/Publisher API (port of
``repro.training``, on one device).

    TrainerConfig  — validated session description (schedule, ckpts, device)
    Trainer        — owns sharding, state init, the epoch loop
    callbacks      — Checkpointing, AlphaOptimizer, KillSwitch,
                     ElasticLiveness, Metrics
    ModelPublisher — versioned RT-LDA snapshots for the serving fleet
"""
from repro_torch.training.callbacks import (AlphaOptimizer, Checkpointing,
                                            ElasticLiveness, KillSwitch, Metrics,
                                            TrainerCallback)
from repro_torch.training.config import TrainerConfig
from repro_torch.training.publisher import ModelPublisher
from repro_torch.training.trainer import Trainer, TrainResult

__all__ = [
    "TrainerConfig", "Trainer", "TrainResult", "TrainerCallback",
    "Checkpointing", "AlphaOptimizer", "KillSwitch", "ElasticLiveness",
    "Metrics", "ModelPublisher",
]
