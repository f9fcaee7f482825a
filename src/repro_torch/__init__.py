"""PyTorch/CUDA port of the Peacock LDA system.

The JAX package ``repro`` is the reference: every module here mirrors the
module of the same name there and is tested against it on the same seeded
inputs. This package never imports ``jax`` or ``repro``.

Entry points (``init_state``, ``quick_train``, ``build_model``,
``make_serving_fn``) run on the CUDA card by default and raise when there is
none, unless the caller passes ``device="cpu"``; nothing falls back quietly.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``torch.device`` for ``device``; raises if it names CUDA and there is none."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev
