"""PyTorch/CUDA port of the Peacock LDA system.

The JAX package ``repro`` is the reference: every module here mirrors the
module of the same name there and is tested against it on the same seeded
inputs. This package never imports ``jax`` or ``repro``.

Entry points (``init_state``, ``quick_train``, ``build_model``,
``make_serving_fn``) run on the CUDA card by default and raise when there is
none, unless the caller passes ``device="cpu"``; nothing falls back quietly.
"""
from __future__ import annotations

# torch is imported where it is used, so that the AST-only gates
# (``python -m repro_torch.analysis.preflight --passes concurrency,lint``) run
# without it


def has_card() -> bool:
    """Whether a CUDA card is there: the port's one device probe (the
    ``repro_torch.analysis`` lint holds every other module to asking here)."""
    import torch

    return torch.cuda.is_available()


def resolve_device(device="cuda") -> "torch.device":   # noqa: F821
    """``torch.device`` for ``device``; raises if it names CUDA and there is none."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda" and not has_card():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev
