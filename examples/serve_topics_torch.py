"""Serving example on the PyTorch port: async RT-LDA topic features via the
TopicEngine.

    PYTHONPATH=src python examples/serve_topics_torch.py               # on the card
    PYTHONPATH=src python examples/serve_topics_torch.py --device cpu

Twin of ``examples/serve_topics.py``: trains a small model (through the
CUDA ``gibbs_argmax`` kernel on the card), builds the RT-LDA serving model
(R cache, Eq. 3), then drives the async engine the way a backend would
(paper §3.2 / §5.1):

  * ``submit()`` returns a future immediately — the background loop batches
    queries into shape buckets and flushes on fill or deadline slack;
  * responses carry P(k|d) + the top-30 Eq.-5 topic features Peacock injects
    at the head of Weak-AND posting lists, plus serving metadata (bucket,
    truncation, latency, deadline);
  * ``swap_model()`` publishes a refreshed Φ mid-traffic, no downtime;
  * ``stats()`` reports QPS / p50 / p99 / occupancy / deadline-miss rate.

The initial z is a ``torch.Generator`` draw, so the numbers differ from the
JAX example's.
"""
import argparse
import json

import numpy as np


def main(device="cuda"):
    from repro_torch import kernels, resolve_device
    from repro_torch.core import rtlda
    from repro_torch.data import synthetic
    from repro_torch.data.fixtures import quick_train
    from repro_torch.serving import TopicEngine

    dev = resolve_device(device)
    kernels.reset_launch_counts()
    _, state = quick_train(topics=24, vocab=500, train_iters=30, gen_topics=16, device=dev)
    model = rtlda.build_model(state.phi, state.beta, state.alpha, device=dev)
    V = state.vocab_size
    print(f"serving model: V={V} K={state.n_topics}; "
          f"R cache = {model.r_topic.shape[0]} entries (1 per word); device {dev}")

    with TopicEngine(model, buckets=(4, 8, 16, 32), max_batch=128,
                     n_trials=2, max_delay_ms=3.0) as engine:
        # "incoming" query traffic: variable lengths, submitted async
        test_c, _ = synthetic.lda_corpus(seed=100, n_docs=256, n_topics=16,
                                         vocab_size=V, query_like=True)
        queries = [test_c.word_ids[test_c.doc_ids == d]
                   for d in range(test_c.n_docs)]
        futures = [engine.submit(q, deadline_ms=50.0) for q in queries]

        # mid-traffic model refresh (what the train→aggregate loop would push)
        engine.swap_model(rtlda.build_model(state.phi, state.beta, state.alpha, device=dev))
        responses = [f.result(timeout=60) for f in futures]
        assert len(responses) == len(queries)

        s = engine.stats()
        assert s.completed == len(queries), (s.completed, len(queries))
        print(f"{s.completed} queries | {s.qps:,.0f} QPS | "
              f"p50 {s.p50_ms:.1f} ms  p99 {s.p99_ms:.1f} ms | "
              f"occupancy {s.mean_batch_occupancy:.2f} | "
              f"miss rate {s.deadline_miss_rate:.1%} | "
              f"per-bucket {s.per_bucket}")

        print("\nsample query → top topic features (word ids, Eq. 5 weights):")
        for r, q in list(zip(responses, queries))[:3]:
            print(f"  query {[int(t) for t in q]} [bucket {r.bucket}] → "
                  f"top topics {np.argsort(-r.pkd)[:3]}, "
                  f"features {r.feature_ids[:6]}")
    launches = kernels.launch_counts()
    print(f"[launches] {json.dumps(launches)}")
    return dict(responses=responses, stats=s, launches=launches)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    main(ap.parse_args().device)
