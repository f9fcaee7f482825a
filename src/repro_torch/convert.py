"""Carry weights and sampler state into the port from plain numpy arrays.

The tests build the JAX package's objects, take ``np.asarray`` of their
leaves and hand them here; the port never sees a JAX array.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.lda import LDAState
from repro_torch.core.rtlda import RTLDAModel
from repro_torch.core.sparse import AliasTables
from repro_torch.optim.l1_loglinear import CTRState


def _t(x, dtype, dev) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=dtype)).to(dev)


def lda_state_from_numpy(phi, psi, z, alpha, beta, device) -> LDAState:
    dev = resolve_device(device)
    return LDAState(phi=_t(phi, np.int32, dev), psi=_t(psi, np.int32, dev),
                    z=_t(z, np.int32, dev), alpha=_t(alpha, np.float32, dev),
                    beta=_t(beta, np.float32, dev))


def rtlda_model_from_numpy(pvk, alpha, r_topic, r_value, device) -> RTLDAModel:
    dev = resolve_device(device)
    return RTLDAModel(pvk=_t(pvk, np.float32, dev), alpha=_t(alpha, np.float32, dev),
                      r_topic=_t(r_topic, np.int32, dev),
                      r_value=_t(r_value, np.float32, dev))


def alias_tables_from_numpy(wq, wp, wa, ap, aa, device) -> AliasTables:
    """Alias tables (e.g. the JAX package's ``sparse.AliasTables`` leaves)."""
    dev = resolve_device(device)
    return AliasTables(wq=_t(wq, np.float32, dev), wp=_t(wp, np.float32, dev),
                       wa=_t(wa, np.int32, dev), ap=_t(ap, np.float32, dev),
                       aa=_t(aa, np.int32, dev))


def ring_state_from_numpy(phi, psi, word_local, doc_local, uid, z, device):
    """The ring epoch's (phi, psi, word_local, doc_local, uid, z), e.g. from
    the JAX package's ``distributed.device_arrays``; uid becomes int64."""
    dev = resolve_device(device)
    return (_t(phi, np.int32, dev), _t(psi, np.int32, dev), _t(word_local, np.int32, dev),
            _t(doc_local, np.int32, dev), _t(uid, np.int64, dev), _t(z, np.int32, dev))


def ctr_state_from_numpy(w_sparse, w_dense, bias, device) -> CTRState:
    """A pCTR model's weights (e.g. the JAX package's ``l1_loglinear.CTRState``
    leaves), all f32."""
    dev = resolve_device(device)
    return CTRState(w_sparse=_t(w_sparse, np.float32, dev), w_dense=_t(w_dense, np.float32, dev),
                    bias=_t(bias, np.float32, dev))


def recsys_params_from_numpy(params, device, table_dtype=torch.float32) -> dict:
    """A recsys parameter dict (e.g. the JAX package's ``init_params``, as
    numpy) with the tables (names ending in ``table``) in ``table_dtype`` and
    every other parameter in f32. The f32 → bf16 cast rounds to nearest even,
    as JAX's ``astype``."""
    dev = resolve_device(device)
    return {k: _t(v, np.float32, dev).to(table_dtype if k.endswith("table") else torch.float32)
            for k, v in params.items()}
