"""``SegmentStream`` — double-buffered LoadShard/SaveShard over a source (port
of ``repro.data.stream``).

The Fig. 3/4 swap loop: while segment *g* trains on the device, a background
thread loads segment *g+1* (mmap read + z gather + host→device copy), so the
sampler does not wait on I/O. ``commit`` is SaveShard: the updated z comes
back to the host and is scattered into the trainer's global z store by uid.

**LoadShard on the card.** The loading thread stages each stack in pinned
host memory (one copy out of the mmap, which also leaves the read-only mmap
alone), then copies it to the device on a side CUDA stream and records an
event there. Before the consumer uses the segment, its own (compute) stream
waits on that event, and each device tensor is marked as used by the
compute stream (``record_stream``): the tensors were allocated on the side
stream, and without the mark the caching allocator could hand their memory
to the next segment's copy while queued compute work still reads it. The
pinned buffers ride on the :class:`LoadedSegment` until it is committed,
past the copy's completion. On the CPU nothing is pinned and there is no
side stream: the stacks are plain host copies.

**On a ring of several ranks** every rank runs its own stream over the same
source (each rank visits the segments in the same seeded order) with its
:class:`repro_torch.dist.sharding.RankLayout`: LoadShard reads and copies
only the rank's block of each stack (``sources.segment_block``), and
SaveShard scatters only the rank's valid uids into its z store. The blocks
of a segment partition its tokens, so a rank's store is exact for the uids
it owns and stale (their z0) elsewhere.

Prefetch is safe by construction: documents are partitioned across segments,
so segment *g*'s SaveShard scatter and segment *g+1*'s LoadShard gather touch
disjoint indices of the shared z array — the only concurrent host-side access
the stream performs. Prefetch on/off is therefore bit-for-bit invisible: the
same arrays reach the device in the same order either way.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Any, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.data.sources import CorpusSource, segment_block

# the dtypes of the stacks (torch, numpy), as ``core.distributed.device_arrays``
# builds them: word_local, doc_local, uid, z
_STACK_DTYPES = ((torch.int32, np.int32), (torch.int32, np.int32),
                 (torch.int64, np.int64), (torch.int32, np.int32))


@dataclasses.dataclass
class LoadedSegment:
    """One segment resident on the device, plus the host refs SaveShard needs."""

    pos: int                    # index in this epoch's visit order
    gid: int                    # segment id (stable across epochs)
    wl: torch.Tensor            # [S, M, cap] int32 on the session's device
    dl: torch.Tensor            # [S, M, cap] int32      (a rank: its blocks)
    uid: torch.Tensor           # [S, M, cap] int64
    z: torch.Tensor             # [S, M, cap] int32
    host_uid: np.ndarray        # host views for the commit scatter and the
    host_valid: np.ndarray      # trainer's Ω fold (mmap refs — no copies)
    host_dl: np.ndarray
    ready: Optional[Any] = None  # CUDA event recorded after the copies
    pinned: Tuple[torch.Tensor, ...] = ()   # the copies' pinned sources
    load_s: float = 0.0         # host seconds of LoadShard (read, gather, copy)
    wait_s: float = 0.0         # host seconds the consumer waited for it
    commit_s: float = 0.0       # host seconds of SaveShard


class SegmentStream:
    """Iterate one epoch's segments with optional background prefetch.

    ``z_host`` is the global [n_tokens] topic-assignment array the stream
    gathers LoadShard z from and scatters SaveShard z into — the trainer owns
    it (``sources.initial_z`` builds it; checkpoints carry it). ``device`` is
    where the segments land (``"cuda"`` by default; ``"cpu"`` on request).
    ``layout`` is the rank's layout on a ring of several ranks (``None``: one
    device, whole stacks).
    """

    # no lock-guarded state: the worker/consumer handoff is entirely the
    # epoch()-local queue + event + semaphore; z is the one field both sides
    # touch and its contract is the disjoint-index partition below
    _GUARDED_BY = {}

    def __init__(self, source: CorpusSource, z_host: np.ndarray,
                 prefetch: bool = True, device="cuda", layout=None):
        self.source = source
        self.layout = layout
        self.z = z_host  # atomic: segments partition documents — the worker's LoadShard gather (z[host_uid]) and the consumer's SaveShard scatter touch disjoint uid index sets, and the depth-1 queue + slots semaphore order each segment's load strictly before its own commit
        self.prefetch = prefetch
        self.n_segments = source.n_segments
        self.device = resolve_device(device)
        self._side = (torch.cuda.Stream(self.device)
                      if self.device.type == "cuda" else None)

    # ------------------------------------------------------------ load -----
    def _load(self, pos: int, gid: int, sc) -> LoadedSegment:
        t0 = time.perf_counter()
        wl, dl, host_uid, _ = segment_block(sc, self.layout)
        host_valid = wl >= 0
        # pad slots carry uid 0 → they read z[0]; the sampler masks them out
        # and commit never scatters them, so the value is numerically inert
        host = (wl, dl, host_uid, self.z[host_uid])
        ready, pinned = None, ()
        if self._side is None:
            dev = tuple(torch.from_numpy(np.array(a, dtype=nd))
                        for a, (_, nd) in zip(host, _STACK_DTYPES))
        else:
            pinned = tuple(torch.empty(np.shape(a), dtype=td, pin_memory=True)
                           for a, (td, _) in zip(host, _STACK_DTYPES))
            for buf, a in zip(pinned, host):
                buf.numpy()[...] = a            # one copy out of the mmap
            with torch.cuda.stream(self._side):
                dev = tuple(buf.to(self.device, non_blocking=True) for buf in pinned)
                ready = torch.cuda.Event()
                ready.record(self._side)
        return LoadedSegment(
            pos=pos, gid=gid, wl=dev[0], dl=dev[1], uid=dev[2], z=dev[3],
            host_uid=host_uid, host_valid=host_valid, host_dl=dl,
            ready=ready, pinned=pinned, load_s=time.perf_counter() - t0)

    def _hand_over(self, seg: LoadedSegment, wait_s: float) -> LoadedSegment:
        """Make a loaded segment safe to use on the consumer's current stream
        (called on the consumer's thread)."""
        seg.wait_s = wait_s
        if seg.ready is not None:
            compute = torch.cuda.current_stream(self.device)
            compute.wait_event(seg.ready)
            for t in (seg.wl, seg.dl, seg.uid, seg.z):
                t.record_stream(compute)
        return seg

    # ---------------------------------------------------------- commit -----
    def commit(self, seg: LoadedSegment, z_dev) -> None:
        """SaveShard: scatter the segment's sampled z into the global store."""
        t0 = time.perf_counter()
        z_host = z_dev.cpu().numpy()        # waits for the compute stream
        self.z[seg.host_uid[seg.host_valid]] = z_host[seg.host_valid]
        seg.pinned = ()       # the copies finished before the compute read z
        seg.commit_s = time.perf_counter() - t0

    # ----------------------------------------------------------- epoch -----
    def epoch(self, epoch: int, start: int = 0) -> Iterator[LoadedSegment]:
        """Yield this epoch's segments from visit-position ``start`` on.

        The traversal IS the source's ``iter_segments(epoch)`` — one
        implementation of the seeded per-epoch visit order. With prefetch, a
        daemon worker keeps exactly one segment in flight (queue depth 1 =
        double buffering): the device trains g while the host loads g+1.
        """
        todo = ((pos, gid, sc)
                for pos, (gid, sc) in enumerate(self.source.iter_segments(epoch))
                if pos >= start)
        if not self.prefetch or self.n_segments - start <= 1:
            for pos, gid, sc in todo:
                t0 = time.perf_counter()
                seg = self._load(pos, gid, sc)
                yield self._hand_over(seg, time.perf_counter() - t0)
            return

        q: "queue.Queue[Tuple[str, Any]]" = queue.Queue(maxsize=1)
        stop = threading.Event()
        # one free-buffer token, released by the consumer as it takes a
        # segment: the worker may only LOAD once a buffer is free, so at
        # most two segments are ever resident (training + prefetched) —
        # without it the worker would run a third load and park in put()
        slots = threading.Semaphore(1)

        def _put(item: Tuple[str, Any]) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker() -> None:
            try:
                for pos, gid, sc in todo:
                    while not slots.acquire(timeout=0.1):
                        if stop.is_set():
                            return
                    if not _put(("seg", self._load(pos, gid, sc))):
                        return
                _put(("end", None))
            except BaseException as exc:  # noqa: BLE001 — forwarded to consumer
                _put(("err", exc))

        t = threading.Thread(target=worker, daemon=True,
                             name="segment-prefetch")
        t.start()
        try:
            while True:
                t0 = time.perf_counter()
                kind, item = q.get()
                waited = time.perf_counter() - t0
                slots.release()
                if kind == "end":
                    break
                if kind == "err":
                    raise item
                yield self._hand_over(item, waited)
        finally:
            stop.set()
            t.join(timeout=5)

