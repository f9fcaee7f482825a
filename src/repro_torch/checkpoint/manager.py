"""Checkpoint manager: rotation, per-pod (per-configuration) checkpoints,
restore-latest, and the Peacock fault-recovery protocol (§3.1.4); port of
``repro.checkpoint.manager``.

Layout:
    <root>/step_<n>/            — global (merged) checkpoints
    <root>/pod_<p>/step_<n>/    — per-configuration checkpoints

Fault recovery contract (mirrors the paper): configurations checkpoint
independently; on failure, the failed configuration alone restores its latest
complete checkpoint and replays its inner epochs (deterministic counter-based
RNG ⇒ the replay reproduces the lost samples bit for bit), then rejoins at
the next aggregation. ``restart_pod`` implements the restore; the replay is
the normal epoch loop.
"""
from __future__ import annotations

import os
import re
import shutil
import threading
from typing import Any, List, Optional, Tuple

from repro_torch.checkpoint import io


class CheckpointManager:
    # no lock: the manager is single-owner (the trainer thread). The writer
    # thread only touches its own host copy of the tree + the filesystem,
    # never manager state; _thread is the one shared handle and save()/wait()
    # are only ever called from the owning thread (see # atomic: below)
    _GUARDED_BY = {}

    def __init__(self, root: str, keep: int = 3, async_save: bool = False):
        self.root = root
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None  # atomic: single-owner handle — only the trainer thread calls save()/wait(); save() joins the previous writer (self.wait()) before spawning the next, so at most one writer exists and no concurrent access to the handle is possible
        os.makedirs(root, exist_ok=True)

    # ------------------------------------------------------------- paths ----
    def step_dir(self, step: int, pod: Optional[int] = None) -> str:
        """Directory a given (step, pod) checkpoint lives in."""
        base = self.root if pod is None else os.path.join(self.root, f"pod_{pod}")
        return os.path.join(base, f"step_{step:08d}")

    def steps(self, pod: Optional[int] = None) -> List[int]:
        base = self.root if pod is None else os.path.join(self.root, f"pod_{pod}")
        if not os.path.isdir(base):
            return []
        out = []
        for name in os.listdir(base):
            m = re.fullmatch(r"step_(\d+)", name)
            if m and io.is_complete(os.path.join(base, name)):
                out.append(int(m.group(1)))
        return sorted(out)

    # -------------------------------------------------------------- save ----
    def save(self, step: int, tree, meta: dict | None = None,
             pod: Optional[int] = None) -> None:
        meta = dict(meta or {})
        meta["step"] = step
        path = self.step_dir(step, pod)
        if self.async_save:
            self.wait()
            # copy to host before handing to the writer thread: the epoch
            # loop updates the device tensors in place right after this
            host_tree = io.host_copy(tree)

            def _async():
                io.save(path, host_tree, meta)
                self._rotate(pod)

            self._thread = threading.Thread(target=_async, daemon=True)
            self._thread.start()
        else:
            io.save(path, tree, meta)
            self._rotate(pod)

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _rotate(self, pod: Optional[int]) -> None:
        steps = self.steps(pod)
        for s in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(self.step_dir(s, pod), ignore_errors=True)

    # ------------------------------------------------------------ restore ---
    def restore_latest(self, like, pod: Optional[int] = None) -> Tuple[Any, dict] | None:
        """Restore the newest complete checkpoint, with last-good fallback: a
        checkpoint whose payload fails its manifest SHA-256 is quarantined on
        disk (renamed ``step_N.corrupt`` so ``steps`` never lists it again)
        and the next-newest is tried. Returns ``None`` only when no readable
        checkpoint remains."""
        for step in reversed(self.steps(pod)):
            path = self.step_dir(step, pod)
            try:
                return io.load(path, like)
            except io.IntegrityError:
                try:
                    os.rename(path, path + ".corrupt")
                except OSError:
                    pass           # raced another restorer; already retired
        return None

    def restart_pod(self, pod: int, like) -> Tuple[Any, dict] | None:
        """Peacock §3.1.4: restore one failed configuration from its own latest
        checkpoint; other configurations are untouched."""
        return self.restore_latest(like, pod=pod)
