"""RT-LDA serving: async deadline-aware engine + fleet front + sync facade
(port of ``repro.serving``; the same classes, on PyTorch).

DESIGN.md §3.5: queue → bucketer → eager batches on the engine's stream →
futures.
The SnapshotWatcher closes the publish pipeline (DESIGN.md §4): it feeds
``ModelPublisher`` snapshots into ``TopicEngine.swap_model`` live.
DESIGN.md §13: ``TopicFleet`` fronts N engine replicas with routing,
admission control and a version-tagged hot-query ``ResultCache``.
DESIGN.md §14: per-replica ``CircuitBreaker`` + hedged retries make the
fleet self-healing under the ``repro_torch.reliability`` fault plane.
"""
from repro_torch.serving.cache import ResultCache
from repro_torch.serving.engine import TopicEngine
from repro_torch.serving.fleet import TopicFleet
from repro_torch.serving.health import CircuitBreaker
from repro_torch.serving.protocol import (EngineStats, FleetStats, Request,
                                          Response, ShedResponse)
from repro_torch.serving.server import BatchingServer
from repro_torch.serving.watcher import SnapshotWatcher

__all__ = ["TopicEngine", "TopicFleet", "ResultCache", "CircuitBreaker",
           "EngineStats", "FleetStats", "Request", "Response",
           "ShedResponse", "BatchingServer", "SnapshotWatcher"]
