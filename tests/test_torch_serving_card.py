"""The port's serving engine on a CUDA card: its own stream, the model's
publish event, and the hot swap. Imports no jax, so it runs on a machine
without it; skips without a card (``kernels`` marker)."""
import numpy as np
import pytest
import torch

from repro_torch import serving as tserving
from repro_torch.core import rtlda as trtlda

pytestmark = [pytest.mark.port, pytest.mark.serve]


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.kernels
def test_engine_on_card_equals_the_function_and_swaps_atomically():
    """On the card: each batch of a ``start=False`` engine equals a direct
    ``make_serving_fn`` call on the same padded batch and seed, bit for bit,
    though the engine runs on its own stream; a model whose copy to the card
    is still queued on a side stream at the swap serves the next batch, bit
    for bit, at version 1."""
    _card()
    from repro_torch.core.features import make_serving_fn
    torch.backends.cuda.matmul.allow_tf32 = False
    Kc, Vc = 512, 2048
    g = torch.Generator(device="cuda").manual_seed(0)
    phi = torch.randint(0, 20, (Vc, Kc), generator=g, device="cuda", dtype=torch.int32)
    alpha = torch.full((Kc,), 0.5, device="cuda")
    beta = torch.tensor(0.01, device="cuda")
    model_a = trtlda.build_model(phi, beta, alpha, device="cuda")
    eng = tserving.TopicEngine(model_a, buckets=(8, 16), max_batch=64,
                               clock=FakeClock(), start=False)
    calls = []
    real = eng._infer
    eng._infer = lambda m, q, seed: calls.append((q.copy(), seed)) or real(m, q, seed)
    rng = np.random.default_rng(0)
    qs = [rng.integers(0, Vc, size=int(n)) for n in rng.integers(1, 17, size=40)]
    futs = [eng.submit(q) for q in qs]
    eng.flush_all()
    fn = make_serving_fn(device="cuda")
    direct = {q.shape[1]: (q, [x.cpu().numpy() for x in fn(model_a, q, seed)])
              for q, seed in calls}
    rows = {8: 0, 16: 0}
    for f in futs:
        r = f.result(timeout=30)
        q, (pkd, ids, w) = direct[r.bucket]
        i = rows[r.bucket]
        rows[r.bucket] += 1
        assert (r.pkd == pkd[i]).all() and (r.feature_ids == ids[i]).all()
        assert (r.feature_weights == w[i]).all() and r.model_version == 0
    # the new model arrives as a snapshot load does: host tensors copied to
    # the card on the producer's stream. Its device tensors start as NaN, and
    # the copies queue behind ~0.5 s of spinning and a 1 GiB copy, so a batch
    # that does not wait for the swap's event reads NaN. (Copies, not kernels:
    # on some machines a kernel on one stream waits for every kernel launched
    # before it on any stream.)
    host = trtlda.build_model(phi.cpu() + 1, beta.cpu(), alpha.cpu(), device="cpu")
    fields = ("pvk", "alpha", "r_topic", "r_value")
    model_b = trtlda.RTLDAModel(*(torch.full_like(getattr(host, f), -1 if f == "r_topic"
                                                  else float("nan"), device="cuda")
                                  for f in fields))
    pinned = [getattr(host, f).pin_memory() for f in fields]
    ballast = torch.empty(1 << 28, pin_memory=True)
    ballast_dev = torch.empty(1 << 28, device="cuda")
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):                 # the new model's producer
        torch.cuda._sleep(1_000_000_000)
        ballast_dev.copy_(ballast, non_blocking=True)
        for f, src in zip(fields, pinned):
            getattr(model_b, f).copy_(src, non_blocking=True)
        eng.swap_model(model_b)                   # event on the side stream
    assert not side.query()                       # model_b is still on its way
    calls.clear()
    fut = eng.submit(qs[0])
    eng.flush_all()
    r = fut.result(timeout=30)
    (q, seed), = calls
    side.synchronize()
    pkd, ids, w = (x.cpu().numpy() for x in fn(model_b, q, seed))
    assert r.model_version == 1
    assert (r.pkd == pkd[0]).all() and (r.feature_ids == ids[0]).all()
    assert (r.feature_weights == w[0]).all()


@pytest.mark.kernels
def test_fleet_replicas_on_their_own_streams_serve_the_function():
    """Two replicas with batching threads and a stream each, sharing one model
    on the card, under concurrent submits: with one trial pkd does not depend
    on the seed, so every response equals the function on the query alone
    (pkd within rtol 1e-6, atol 1e-7: its row sum may reduce in another order
    at another batch size; ids equal but at tied weights)."""
    _card()
    from repro_torch.core.features import make_serving_fn
    Kc, Vc = 256, 1024
    g = torch.Generator(device="cuda").manual_seed(1)
    phi = torch.randint(0, 20, (Vc, Kc), generator=g, device="cuda", dtype=torch.int32)
    model = trtlda.build_model(phi, torch.tensor(0.01, device="cuda"),
                               torch.full((Kc,), 0.5, device="cuda"), device="cuda")
    fleet = tserving.TopicFleet(model, n_replicas=2, buckets=(8, 16), max_batch=16,
                                n_trials=1, cache_mb=0.0, shed=False, max_delay_ms=1.0)
    streams = {e._stream for e in fleet.engines}
    assert len(streams) == 2 and torch.cuda.current_stream() not in streams
    rng = np.random.default_rng(2)
    qs = [rng.integers(0, Vc, size=int(n)) for n in rng.integers(1, 17, size=200)]
    try:
        futs = [fleet.submit(q) for q in qs]
        out = [f.result(timeout=60) for f in futs]
    finally:
        fleet.close()
    assert sum(fleet.stats().routed) == len(qs)
    fn = make_serving_fn(n_trials=1, device="cuda")
    for q, r in zip(qs, out):
        row = np.full((1, r.bucket), -1, np.int32)
        row[0, :len(q)] = q
        pkd, ids, w = (x.cpu().numpy()[0] for x in fn(model, row, 0))
        np.testing.assert_allclose(r.pkd, pkd, rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(r.feature_weights, w, rtol=1e-6)
        at = dict(zip(ids.tolist(), w.tolist()))
        for i in np.flatnonzero(r.feature_ids != ids):
            assert np.isclose(w[i], at.get(int(r.feature_ids[i]), float(w[-1])), rtol=1e-6)
