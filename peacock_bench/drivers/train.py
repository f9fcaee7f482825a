"""Training traffic: the port's ``Trainer`` over a corpus drawn from the seed,
epoch after epoch, as a session runs it.

Set-up builds one ``Trainer``, and its ``fit()`` runs the warm-up epochs
(every shape of the cell, the first α step and table rebuilds) and then the
measured window, in one call: a callback opens the window after the last
warm-up epoch and closes it at the end of the first epoch that finishes past
``--seconds``, with ``torch.cuda.synchronize()``. Table rebuilds, α steps
and callbacks run inside the window as the session runs them.

The comparison follows the program step by step where only its own state
can say what it should have drawn: the reference takes the assignments
before the window's last epoch (kept by a callback, a device copy an epoch)
and works out that epoch's draws again, and it checks the state the epoch
left (Φ, Ψ, the doc-topic histogram, α, the LL) against the corpus.
"""
from __future__ import annotations

import gc
import time

import numpy as np

M32 = 0xFFFF_FFFF


def epoch_seed(seed: int, epoch: int) -> int:
    """The sampler's seed of an epoch: ``Trainer`` gives ``run_hierarchical``
    seed0 = seed·131 + 7, and epoch e draws with (seed0 + e) mod 2³²."""
    return (seed * 131 + 7 + epoch) & M32


def run(ctx) -> dict:
    import torch

    from repro_torch.data.corpus import Corpus
    from repro_torch.training import AlphaOptimizer, Trainer, TrainerCallback, TrainerConfig

    import gen
    from harness import StopWindow
    from reference import lda as ref

    cfg = ctx.config
    K, V = cfg["n_topics"], cfg["vocab_size"]
    n_docs, agg = cfg["n_docs"], cfg["agg_every"]
    alias = cfg["sampler"] == "alias"
    dev = torch.device(ctx.device)
    spans, trace = ctx.spans, ctx.trace
    words, docs = gen.lda_corpus([ctx.seed, 1], n_docs, cfg["gen_topics"], V, cfg["tokens_per_doc"])
    N = int(words.shape[0])
    tcfg = TrainerConfig(
        n_docs=n_docs, vocab_size=V, n_topics=K, sampler=cfg["sampler"], n_mh=cfg["n_mh"],
        device=ctx.device, n_epochs=1 << 30, agg_every=agg,
        alpha_opt_from=cfg["alpha_opt_from"], alpha_opt_iters=cfg["alpha_opt_iters"],
        package_len=0, seed=ctx.seed, shard_seed=ctx.seed, alpha0=cfg["alpha0"],
        beta=cfg["beta"])
    sync = (lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda" else (lambda: None)
    # warm-up: every epoch up to and including the first α step, and for the
    # alias sampler two table rebuilds
    warm = max(2, cfg["alpha_opt_from"] + 1 if cfg["alpha_opt"] else 0,
               2 * agg + 1 if alias else 0)
    ends = []          # (epoch, host time at its end)

    class Follow(TrainerCallback):
        """Keeps, on the device, z before and after each epoch, z where the
        word tables were last built, and the α each epoch drew with."""

        def on_train_start(self, tr):
            z = tr.state[5]
            self.z = [z.clone(), z.clone()]
            self.z_build = z.clone()
            self.alpha_in = {}

        def on_epoch_end(self, tr, e):
            t = time.perf_counter()
            ends.append((e, t))
            if alias and e % agg == 0:
                self.z_build.copy_(self.z[(e - 1) % 2])   # the state its tables saw
            self.z[e % 2].copy_(tr.state[5])
            self.alpha_in[e % 2] = tr.alpha
            spans.add("callback", t, time.perf_counter())

    class TimedAlpha(AlphaOptimizer):
        def on_epoch_end(self, tr, e):
            with spans.span("alpha_step"):
                super().on_epoch_end(tr, e)

    class Window(TrainerCallback):
        t0 = t1 = None
        first = last = None

        def on_epoch_end(self, tr, e):
            if e + 1 == warm:
                trace.start()
                sync()
                self.first, self.t0 = e + 1, time.perf_counter()
            elif self.t0 is not None and time.perf_counter() - self.t0 >= ctx.seconds:
                sync()
                self.last, self.t1 = e, time.perf_counter()
                trace.stop()
                raise StopWindow

    follow, window = Follow(), Window()
    callbacks = [follow] + ([TimedAlpha()] if cfg["alpha_opt"] else []) + [window]
    tr = Trainer(tcfg, callbacks=callbacks,
                 corpus=Corpus(words, docs, n_docs, V))
    tr.setup()
    trace.prepare()
    if ctx.mode.startswith("fault:"):
        import faults
        faults.plant(ctx.mode[6:], tr)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    try:
        tr.fit()
    except StopWindow:
        pass
    sync()
    t0, t1, first, last = window.t0, window.t1, window.first, window.last
    n_ep = last - first + 1
    e2e = {"train_tokens_per_s": n_ep * N / (t1 - t0), "setup_s": t0 - ctx.t_start}
    peak = int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else 0

    # ---- the record the per-layer metrics read --------------------------
    ep_s = tr.metrics["epoch_s"][first:last + 1]
    rc = tr.ring_cfg
    prev = dict(ends)
    for e in range(first, last + 1):
        end = prev[e]
        spans.add("epoch", end - tr.metrics["epoch_s"][e], end)
        start = prev.get(e - 1)
        if start is not None:
            spans.add("table_rebuild" if alias and e % agg == 0 else "loop", start,
                      end - tr.metrics["epoch_s"][e])
    record = {
        "cell": ctx.cell, "sampler": cfg["sampler"], "K": K, "V": V, "n_docs": n_docs,
        "tokens": N, "epochs": n_ep, "window_s": t1 - t0, "epoch_s": ep_s,
        "package_len": rc.package_len, "packages": rc.cap // rc.package_len,
        "rows": rc.rows_per_shard, "n_words": int(np.unique(words).size),
        "doc_cap": rc.doc_topic_cap, "n_mh": cfg["n_mh"],
        "word_builds": sum(1 for e in range(first, last + 1) if e % agg == 0) if alias else 0,
        "alpha_builds": n_ep if alias and cfg["alpha_opt"] else 0,
        "trace": trace.reduce(t0, t1, spans, ("table_rebuild", "alpha_step", "callback",
                                                "epoch", "loop")),
    }

    # ---- the comparison ---------------------------------------------------
    phi, psi, wl, dl, uid, z = tr.state
    alpha_in = follow.alpha_in[last % 2]
    alpha_out = tr.alpha
    z_pre_slots = follow.z[(last - 1) % 2].reshape(-1)
    tables = tuple(t.reshape(-1, K) if t.dim() > 1 else t for t in tr._tables) if alias else None
    ll_prog = tr.log_likelihood()
    omega_prog = tr.alpha_statistics()[0] if cfg["alpha_opt"] else None
    w_t = torch.from_numpy(words).to(dev)
    d_t = torch.from_numpy(docs).to(dev)
    slot_of, row_of, layout_faults = ref.token_layout(w_t, wl.reshape(-1), uid.reshape(-1),
                                                      rc.rows_per_shard, V)
    slot_of = slot_of.clamp(min=0)
    row_tok = row_of[w_t.long()]
    z_post = z.reshape(-1)[slot_of].long()
    z_pre = z_pre_slots[slot_of].long()
    uid_tok = uid.reshape(-1)[slot_of]
    z_build = follow.z_build.reshape(-1)[slot_of].long()
    faults_n = layout_faults + ref.state_faults(phi.reshape(-1, K), psi, row_tok, z_post, K)
    del tr
    gc.collect()
    seed_e = epoch_seed(ctx.seed, last)
    beta = cfg["beta"]
    control = ctx.mode == "control"
    low = torch.bfloat16
    checks = {}
    if alias:
        draws, sectors = ref.mh_chain(row_tok, d_t, z_pre, uid_tok, alpha_in, beta, V, seed_e,
                                      K, cfg["n_mh"], tables, n_docs, rc.doc_topic_cap,
                                      sectors=ctx.trace.on)
        record["mh_sector_bytes"] = sectors
        got = z_post
        if control:
            got, _ = ref.mh_chain(row_tok, d_t, z_pre, uid_tok, alpha_in, beta, V, seed_e, K,
                                  cfg["n_mh"], tables, n_docs, rc.doc_topic_cap, dtype=low)
        checks["mh_mismatch_share"] = float((got.long() != draws.long()).double().mean())
        wq_err, l1 = ref.table_error(*tables, row_of, row_tok, z_build, alpha_in, beta, V, K)
        checks["table_wq_rel_err"] = wq_err
        checks["table_l1"] = l1
    else:
        if control:
            z_post = ref.gibbs_gap(row_tok, d_t, z_pre, z_post, uid_tok, alpha_in, beta, V,
                                   seed_e, K, dtype=low)[1].long()
        checks["draw_gap"] = ref.gibbs_gap(row_tok, d_t, z_pre, z_post, uid_tok, alpha_in,
                                           beta, V, seed_e, K)[0]
    ll_ref = ref.word_ll(row_tok, z_post, K, V, beta)
    if control:
        ll_prog = ref.word_ll(row_tok, z_post, K, V, beta, dtype=low)
    checks["ll_rel_err"] = abs(ll_prog - ll_ref) / abs(ll_ref)
    if cfg["alpha_opt"]:
        # the window's last α step, and the one before it, which made the α
        # that the last epoch drew with: each from the α it was given and
        # Ω of the assignments it saw
        om = ref.omega(d_t, z_post, K)
        if not control:
            faults_n += int((omega_prog.long() != om).sum())
        lengths = torch.bincount(d_t.long(), minlength=n_docs)
        steps = ((alpha_in, om, alpha_out),
                 (follow.alpha_in[(last - 1) % 2], ref.omega(d_t, z_pre, K), alpha_in))
        err = 0.0
        for a_given, om_seen, a_prog in steps:
            a_ref = ref.minka_alpha(a_given, om_seen, lengths, cfg["alpha_opt_iters"])
            if control:
                a_prog = ref.minka_alpha(a_given, om_seen, lengths, cfg["alpha_opt_iters"],
                                         dtype=low)
            err = max(err, float(((a_prog - a_ref).abs() / a_ref).max()))
        checks["alpha_rel_err"] = err
    checks["state_faults"] = float(faults_n)
    limits = ctx.workload["limits"]
    return {"attempted": n_ep * N, "failed": 0, "e2e": e2e, "record": record,
            "memory_peak_bytes": peak,
            "checks": {k: (v, limits[k]) for k, v in checks.items()}}
