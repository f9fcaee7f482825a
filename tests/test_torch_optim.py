"""Port conformance of the optimizers' schedules and AdamW
(``repro_torch.optim.schedules``, ``repro_torch.optim.adamw``).

The three LR schedules are held against the JAX package's at every step 0–200
over all their branches, and AdamW over 10 steps from the same parameters,
state and gradients (seeded numpy, carried across with ``convert``): clipping
active and inactive, a float and a ``wsd`` lr, weight decay 0 and 0.1, the
NamedTuple and the dict state. Both run the same f32 operations in the same
order; the sums of the global norm and the pow/cos of the schedules may
round differently, so the tolerance is rtol 1e-6. The schedules hold with
atol 1e-12; AdamW adds atol 1e-8: where clipping is active the two global
norms differ in their last bit, every step's update (≈ 3e-3) with it, and a
parameter that passes near 0 keeps the absolute error of its ~3e-2 of
updates (seen: 7.5e-9, two f32 ulps at 3e-2).
"""
import functools

import numpy as np
import pytest
import torch

from _torch_port import one_torch_thread as _one_torch_thread  # noqa: F401  (autouse)
from repro_torch import convert
from repro_torch.optim import adamw as tadamw
from repro_torch.optim import schedules as tsched

pytestmark = pytest.mark.port

TOL = dict(rtol=1e-6, atol=1e-12)
ADAM_TOL = dict(rtol=1e-6, atol=1e-8)
STEPS = np.arange(201)
# (name, kwargs): warmup, plateau and decay all fall inside steps 0–200
SCHEDULES = [
    ("wsd", dict(peak_lr=1e-3, warmup_steps=40, stable_steps=60, decay_steps=70)),
    ("wsd", dict(peak_lr=3e-4, warmup_steps=0, stable_steps=10, decay_steps=1,
                 final_ratio=0.25)),
    ("cosine", dict(peak_lr=1e-3, warmup_steps=30, total_steps=150)),
    ("cosine", dict(peak_lr=2e-3, warmup_steps=0, total_steps=0, final_ratio=0.0)),
    ("constant", dict(peak_lr=5e-4)),
]


@pytest.fixture(scope="module")
def jax_optim():
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.optim import adamw as jadamw
    from repro.optim import schedules as jsched
    return jnp, jadamw, jsched


@pytest.mark.parametrize("name,kw", SCHEDULES,
                         ids=[f"{n}{i}" for i, (n, _) in enumerate(SCHEDULES)])
def test_schedule_matches_jax(jax_optim, name, kw):
    jnp, _, jsched = jax_optim
    expect = np.array([np.asarray(getattr(jsched, name)(jnp.int32(s), **kw)) for s in STEPS])
    got = np.array([getattr(tsched, name)(int(s), **kw).numpy() for s in STEPS])
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, expect, **TOL)
    # a tensor step (the optimizer passes its int32 step) gives the same
    t = getattr(tsched, name)(torch.tensor(STEPS, dtype=torch.int32), **kw)
    np.testing.assert_array_equal(t.numpy(), got)


SHAPES = {"a/w": (7, 5), "a/b": (5,), "emb": (11, 3), "scale": ()}


def _tree(rng, scale=1.0):
    return {k: np.asarray(rng.normal(size=s) * scale, dtype=np.float32)
            for k, s in SHAPES.items()}


def _np(tree):
    """A JAX state (a NamedTuple, dicts, arrays) with numpy leaves."""
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_np(v) for v in tree)
    return np.asarray(tree)


CASES = [  # (clip_norm, lr, weight_decay, dict_state, grad scale)
    (1.0, "float", 0.0, True, 1.0),        # clip active (‖g‖ ≈ 5)
    (1.0, "float", 0.1, False, 0.01),      # clip inactive
    (None, "float", 0.1, True, 1.0),       # no clipping
    (1.0, "wsd", 0.0, False, 1.0),
    (10.0, "wsd", 0.1, True, 1.0),         # clip inactive, schedule lr
]


@pytest.mark.parametrize("clip,lr,wd,as_dict,gscale", CASES)
def test_adamw_matches_jax(jax_optim, clip, lr, wd, as_dict, gscale):
    jnp, jadamw, jsched = jax_optim
    rng = np.random.default_rng(7)
    params = _tree(rng)
    grads = [_tree(rng, gscale) for _ in range(10)]
    lr_kw = dict(peak_lr=1e-2, warmup_steps=3, stable_steps=3, decay_steps=3)
    jopt = jadamw.AdamW(lr=functools.partial(jsched.wsd, **lr_kw) if lr == "wsd" else 3e-3,
                        weight_decay=wd, clip_norm=clip)
    topt = tadamw.AdamW(lr=functools.partial(tsched.wsd, **lr_kw) if lr == "wsd" else 3e-3,
                        weight_decay=wd, clip_norm=clip)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = jopt.init(jp)
    if as_dict:
        js = {"step": js.step, "m": js.m, "v": js.v}
    ts = convert.adamw_state_from_numpy(_np(js), "cpu")
    assert isinstance(ts, dict) == as_dict
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    for g in grads:
        jp, js = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        tp, ts = topt.update({k: torch.from_numpy(v) for k, v in g.items()}, ts, tp)
        assert isinstance(ts, dict) == as_dict
    jstate = js if as_dict else js._asdict()
    tstate = ts if as_dict else ts._asdict()
    assert int(tstate["step"]) == int(jstate["step"]) == 10
    assert tstate["step"].dtype == torch.int32
    for k in SHAPES:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), **ADAM_TOL)
        np.testing.assert_allclose(tstate["m"][k].numpy(), np.asarray(jstate["m"][k]),
                                   **ADAM_TOL)
        np.testing.assert_allclose(tstate["v"][k].numpy(), np.asarray(jstate["v"][k]),
                                   **ADAM_TOL)


def test_adamw_init_and_global_norm(jax_optim):
    jnp, jadamw, _ = jax_optim
    rng = np.random.default_rng(8)
    tree = {"x": _tree(rng), "y": {"z": rng.normal(size=(4,)).astype(np.float32)}}
    jtree = {"x": {k: jnp.asarray(v) for k, v in tree["x"].items()},
             "y": {"z": jnp.asarray(tree["y"]["z"])}}
    ttree = {"x": {k: torch.from_numpy(v) for k, v in tree["x"].items()},
             "y": {"z": torch.from_numpy(tree["y"]["z"])}}
    np.testing.assert_allclose(tadamw.global_norm(ttree).numpy(),
                               np.asarray(jadamw.global_norm(jtree)), **TOL)
    st = tadamw.AdamW().init(ttree)
    assert isinstance(st, tadamw.AdamWState) and st.step.dtype == torch.int32
    assert int(st.step) == 0 and float(st.m["y"]["z"].abs().sum()) == 0.0
    assert st.v["x"]["a/w"].shape == (7, 5)


@pytest.mark.parametrize("clip,lr,wd,as_dict,gscale", CASES)
def test_adamw_in_place_gives_the_functional_bits(clip, lr, wd, as_dict, gscale):
    """``update(..., inplace=True)`` (a step that donates its parameters and
    state) writes the functional update's bits into the given tensors, over
    10 steps."""
    rng = np.random.default_rng(9)
    params = {k: torch.from_numpy(v) for k, v in _tree(rng).items()}
    grads = [{k: torch.from_numpy(v) for k, v in _tree(rng, gscale).items()}
             for _ in range(10)]
    lr_kw = dict(peak_lr=1e-2, warmup_steps=3, stable_steps=3, decay_steps=3)
    opt = tadamw.AdamW(lr=functools.partial(tsched.wsd, **lr_kw) if lr == "wsd" else 3e-3,
                       weight_decay=wd, clip_norm=clip)
    fp, fs = params, opt.init(params)
    ip = {k: v.clone() for k, v in params.items()}
    st = opt.init(ip)
    ist = {"step": st.step, "m": st.m, "v": st.v} if as_dict else st
    for g in grads:
        fp, fs = opt.update(g, fs, fp)
        bufs = (dict(ip), dict(ist["m"] if as_dict else ist.m))
        ip, ist = opt.update(g, ist, ip, inplace=True)
        assert all(ip[k] is bufs[0][k] for k in SHAPES)
        assert all((ist["m"] if as_dict else ist.m)[k] is bufs[1][k] for k in SHAPES)
    got = ist if as_dict else ist._asdict()
    assert int(got["step"]) == 10
    for k in SHAPES:
        assert torch.equal(ip[k], fp[k]), k
        assert torch.equal(got["m"][k], fs.m[k]) and torch.equal(got["v"][k], fs.v[k]), k
