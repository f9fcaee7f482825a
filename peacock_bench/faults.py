"""Faults planted under a run's timed path, to show that the comparison
fails them. Used by ``readings.py`` (on the card, for the limits' upper
readings) and by the tests; a benchmark run never plants one.

Each ``plant(name, target)`` wraps a method of the program object that the
driver built, in place, before the window:

- ``unchanged``: the step returns its state as it got it;
- ``half``: only the first half of the tokens (or of a batch's rows) is
  served: the rest keep their old topics (their counts moved back), or get
  no answer of their own;
- ``token``: one token's topic (or one answer) is altered where it is made;
- ``stale_tables``: the alias sampler's word tables are never rebuilt.
"""
from __future__ import annotations

TRAIN = ("unchanged", "half", "token", "stale_tables")
SERVE = ("half", "token")


def plant(name: str, target) -> None:
    if hasattr(target, "_epoch_fn"):
        _plant_train(name, target)
    else:
        _plant_serve(name, target)


def _plant_train(name: str, tr) -> None:
    import torch

    from repro_torch.core import sparse

    real = tr._epoch_fn
    K = tr.config.n_topics
    if name == "unchanged":
        tr._epoch_fn = lambda *a: a[:6]
    elif name == "half":
        def half(*a):
            phi, psi, wl, z = a[0], a[1], a[2], a[5]
            before = z.clone()
            out = real(*a)
            flat_w, flat_z, flat_b = wl.reshape(-1), z.view(-1), before.reshape(-1)
            back = torch.zeros_like(flat_w, dtype=torch.bool)
            back[flat_w.numel() // 2:] = True
            back &= flat_w >= 0
            sparse.move_counts(phi.reshape(-1, K), psi, torch.where(back, flat_w, 0), flat_z,
                               flat_b, back.to(torch.int32))
            flat_z.copy_(torch.where(back, flat_b, flat_z))
            return out
        tr._epoch_fn = half
    elif name == "token":
        def token(*a):
            out = real(*a)
            flat_w, flat_z = a[2].reshape(-1), a[5].view(-1)
            i = int(torch.nonzero(flat_w >= 0)[0])
            flat_z[i] = (flat_z[i] + 1) % K
            return out
        tr._epoch_fn = token
    elif name == "stale_tables":
        rebuild = tr._rebuild_tables
        tr._rebuild_tables = lambda word=True: rebuild(word=tr._tables is None)
    else:
        raise ValueError(f"no training fault {name!r}")


def _plant_serve(name: str, engine) -> None:
    """Wrap an engine's inference so its answers are wrong."""
    real = engine._infer

    def infer(model, q, seed):
        pkd, ids, w = real(model, q, seed)
        if name == "half":
            n = pkd.shape[0] // 2
            pkd[n:] = pkd[:1]
            ids[n:], w[n:] = ids[:1], w[:1]
        elif name == "token":
            pkd[0] = pkd[0].roll(1)
        else:
            raise ValueError(f"no serving fault {name!r}")
        return pkd, ids, w
    engine._infer = infer
