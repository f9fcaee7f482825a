"""Train a model past the single-device replicated ceiling on the PyTorch
port (DESIGN.md §10).

    PYTHONPATH=src python examples/big_model_torch.py               # on the card
    PYTHONPATH=src python examples/big_model_torch.py --device cpu

Twin of ``examples/big_model.py``: the same session (a (data=2) × (model=4)
mesh, the alias sampler, 4 epochs) as 8 ranks started by
``repro_torch.launch.mesh.spawn`` — on the card they share it over gloo
(``ranks_per_device``), on the CPU they are CPU processes. An artificial
per-device model-state budget is set that the replicated layout cannot
meet; with ``n_model_shards=4`` Φ, the word-proposal tables and the alias
tables split into 4 resident vocabulary slices, and the assertions measure
each rank's REAL resident bytes (its Φ view and its wq/wp/wa views), not
the analytic model. The paper-scale extrapolation (10⁵ topics × 10⁶ words)
is printed from ``dist.analysis.model_shard_report`` against the H100's
80 GB.
"""
import argparse
import json

D, P = 2, 4
CFG = dict(n_docs=600, vocab_size=2400, n_topics=64, true_topics=24, doc_len_mean=10,
           data_shards=D, model_shards=P, n_model_shards=P, sampler="alias", n_epochs=4,
           alpha_opt_from=100)


def rank_main(layout):
    """One rank's session: its budget check, its resident Φ + wq/wp/wa bytes
    and the pod's LL (a collective); returns them with its kernel launches."""
    import torch

    from repro_torch import kernels
    from repro_torch.training import Metrics, Trainer, TrainerConfig

    kernels.reset_launch_counts()
    cfg = TrainerConfig(device=torch.device(layout.device).type, **CFG)
    trainer = Trainer(cfg, callbacks=[Metrics(printer=lambda m: None)],
                      layout=layout).setup()
    trainer.log = lambda m: None

    # the ceiling: per-device model state (Φ int32 + wq/wp f32 + wa int32
    # row slices) a replicated layout would need for this (K, V, D)
    rows_replicated = trainer.sc0.rows_per_shard        # all rows resident
    replicated_need = rows_replicated * cfg.n_topics * 16
    budget = int(0.5 * replicated_need)                 # replicated can't fit
    assert replicated_need > budget

    trainer.fit()

    model_state = [trainer.state[0]]                    # this rank's Φ view
    if trainer._tables is not None:
        model_state += [trainer._tables.wq, trainer._tables.wp, trainer._tables.wa]
    used = sum(t.numel() * t.element_size() for t in model_state)
    assert used <= budget, (used, budget)
    assert used * P >= replicated_need                  # it IS the same model
    ll = trainer.log_likelihood()
    return dict(rank=layout.rank, used=int(used), budget=budget,
                replicated_need=int(replicated_need), ll=float(ll),
                launches=kernels.launch_counts())


def main(device="cuda"):
    from repro_torch import resolve_device
    from repro_torch.dist import analysis
    from repro_torch.launch import mesh

    dev = resolve_device(device)
    ranks = mesh.spawn(rank_main, data=D, model=P, device=dev.type,
                       ranks_per_device=D * P if dev.type == "cuda" else 1,
                       threads=1 if dev.type == "cpu" else None)
    r0 = ranks[0]
    print(f"[budget] per-device model-state budget {r0['budget']/1e3:.0f} kB; "
          f"replicated layout needs {r0['replicated_need']/1e3:.0f} kB -> "
          f"does not fit; P={P} slices need "
          f"{r0['replicated_need']/P/1e3:.0f} kB -> fits")
    for r in ranks:
        print(f"[measure] rank {r['rank']}: Φ+tables actually resident: "
              f"{r['used']/1e3:.0f} kB (budget {r['budget']/1e3:.0f} kB)")
    print(f"[train] K={CFG['n_topics']} on a {D}x{P} mesh ({len(ranks)} ranks on {dev.type}): "
          f"final log-likelihood {r0['ll']:.0f}")

    # where this matters: the paper's 10^5-topic x 10^6-word regime
    print("[paper scale] K=100k V=1M on a 16-ring, against the H100's 80 GB:")
    for p in (1, 2, 8):
        r = analysis.model_shard_report(100_000, 1_000_000, 16, p, 4.5e9,
                                        docs_per_shard=4096, doc_topic_cap=64)
        hbm = r["hbm_bytes_per_device"]
        print(f"  P={p}: {hbm/1e9:6.1f} GB/device "
              f"{'(fits 80 GB)' if hbm < 80e9 else '(exceeds 80 GB)'}")
    launches = {k: sum(r["launches"][k] for r in ranks) for k in ranks[0]["launches"]}
    print(f"[launches] {json.dumps(launches)}")
    return ranks


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    main(ap.parse_args().device)
