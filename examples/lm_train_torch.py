"""LM example on the PyTorch/CUDA port: train a small llama-family model with
the port's substrate, on one card.

    PYTHONPATH=src python examples/lm_train_torch.py            # on the card
    PYTHONPATH=src python examples/lm_train_torch.py --device cpu

Twin of ``examples/lm_train.py``: the same transformer, optimizer and
checkpoint stack the assigned LM architectures run on, at toy scale: the WSD
schedule (MiniCPM's), AdamW, a checkpoint every 40 steps and a resume from
the newest one, and greedy decoding from the trained model through the
chunked-prefill + decode serving path. The embedding's gradient is the
row-gradient kernel's (``gather_rows``) on the card. The weights are a
``torch.Generator`` draw, so the numbers differ from the JAX example's.
"""
import argparse
import functools
import json
import os
import tempfile

import numpy as np
import torch

from repro_torch import kernels, resolve_device
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.lm_archs import small_lm
from repro_torch.models import transformer as tf
from repro_torch.optim import schedules
from repro_torch.optim.adamw import AdamW

STEPS, BATCH, SAVE_EVERY = 200, 16, 40


def make_data(cfg, n=256, S=64, seed=0):
    """Synthetic 'language': arithmetic-progression sequences (learnable)."""
    rng = np.random.default_rng(seed)
    start = rng.integers(0, cfg.vocab_size, n)
    step = rng.integers(1, 7, n)
    toks = (start[:, None] + step[:, None] * np.arange(S)) % cfg.vocab_size
    return torch.from_numpy(toks.astype(np.int32))


def main(device="cuda", ckpt_dir=None):
    dev = resolve_device(device)
    kernels.reset_launch_counts()
    cfg = small_lm()
    params = tf.init_params(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    print(f"model: {cfg.n_layers}L d={cfg.d_model} → {cfg.n_params:,} params; device {dev}")

    lr = functools.partial(schedules.wsd, peak_lr=3e-3, warmup_steps=20, stable_steps=150,
                           decay_steps=50)
    opt = AdamW(lr=lr)
    ost = opt.init(params)
    data = make_data(cfg).to(dev)
    ckpt_dir = ckpt_dir or tempfile.mkdtemp(prefix="lm_ckpt_")
    mgr = CheckpointManager(ckpt_dir, keep=2)

    def step(params, ost, batch):
        toks, labels = batch[:, :-1], batch[:, 1:]
        leaves = tf.tree_map(lambda p: p.detach().requires_grad_(True), params)
        loss = tf.lm_loss(cfg, leaves, toks, labels)
        grads = tf.tree_unflatten(leaves, torch.autograd.grad(loss, tf.leaves(leaves)))
        params, ost = opt.update(grads, ost, params)
        return params, ost, loss.detach()

    losses = []
    for it in range(STEPS):
        batch = data[(it * BATCH) % 240:(it * BATCH) % 240 + BATCH]
        params, ost, loss = step(params, ost, batch)
        losses.append(float(loss))
        if (it + 1) % SAVE_EVERY == 0:
            print(f"step {it+1:4d}  loss {losses[-1]:.4f}  lr {float(lr(it + 1)):.2e}")
            mgr.save(it + 1, {"params": params, "opt": ost._asdict()})

    # resume: the newest checkpoint holds the trained model, bit for bit
    tree, meta = mgr.restore_latest({"params": params, "opt": ost._asdict()})
    restored = tf.tree_map(lambda a: torch.from_numpy(np.array(a)).to(dev), tree["params"])
    same = all(torch.equal(a, b) for a, b in zip(tf.leaves(restored), tf.leaves(params)))
    print(f"resumed from step {meta['step']} of {mgr.steps()}: "
          f"{'bit-equal' if same else 'DIFFERENT'} parameters")
    assert meta["step"] == STEPS and same
    params = restored

    # greedy decode with the serving path: the model should continue the
    # arithmetic progression (a training sequence — memorization at toy scale)
    prompt = data[100:101, :16]
    cache = tf.init_kv_cache(cfg, 1, 64, dtype=torch.float32, device=dev)
    nxt, _, cache = tf.serve_step(cfg, params, prompt, cache, 0)
    decoded = [int(nxt[0, 0])]
    pos = 16
    for _ in range(8):
        nxt, _, cache = tf.serve_step(cfg, params, nxt, cache, pos)
        decoded.append(int(nxt[0, 0]))
        pos += 1
    truth = [int(x) for x in data[100, 16:16 + 9]]
    hits = sum(a == b for a, b in zip(decoded, truth))
    print(f"prompt continuation: {decoded}")
    print(f"ground truth:        {truth}   ({hits}/9 correct)")
    launches = kernels.launch_counts()
    print(f"[launches] {json.dumps(launches)}")
    return {"launches": launches, "losses": losses, "decoded": decoded, "truth": truth,
            "hits": hits, "resumed_step": meta["step"], "checkpoints": mgr.steps(),
            "ckpt_dir": os.path.abspath(ckpt_dir)}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    main(ap.parse_args().device)
