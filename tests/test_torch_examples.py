"""The torch twins of the examples (``examples/*_torch.py``) on the CPU.

Each twin's ``main(device="cpu")`` runs and its own assertions hold (they
are the JAX originals'); ``out_of_core_torch``'s model equals the JAX
example's session bit for bit (the same z0: the sources draw it with
numpy), and ``big_model_torch``'s ranks each hold exactly the bytes of Φ and
the word tables that the JAX example measures on each of its 8 devices.
"""
import json
import os
import sys

import numpy as np
import pytest

from _torch_port import one_torch_thread as _one_torch_thread  # noqa: F401  (autouse)

pytestmark = pytest.mark.port

EXAMPLES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples")


@pytest.fixture(scope="module", autouse=True)
def examples_on_path():
    sys.path.insert(0, EXAMPLES)
    yield
    sys.path.remove(EXAMPLES)


def test_serve_topics_twin():
    import serve_topics_torch

    out = serve_topics_torch.main(device="cpu")
    assert len(out["responses"]) == 256 and out["stats"].completed == 256
    for r in out["responses"]:
        assert np.isclose(r.pkd.sum(), 1.0, atol=1e-5) and len(r.feature_ids) == 30
    assert set(out["launches"].values()) == {0}          # the plain versions


def test_live_refresh_twin():
    import live_refresh_torch

    out = live_refresh_torch.main(device="cpu")
    assert out["resolved"] == out["in_flight"] > 0
    assert out["version"] == out["last_version"] == max(out["versions"])
    assert out["swaps"] >= 1


def test_fleet_demo_twin():
    import fleet_demo_torch

    out = fleet_demo_torch.main(device="cpu")
    assert out["resolved"] == out["in_flight"] > 0
    assert out["version"] == 2 and out["versions"][-1] == 2
    assert len(out["routed"]) == fleet_demo_torch.REPLICAS and sum(out["routed"]) > 0
    assert out["hits"] > 0


def test_out_of_core_twin_equals_the_jax_example():
    import out_of_core_torch
    from repro.training import Metrics, Trainer, TrainerConfig

    out = out_of_core_torch.main(device="cpu")
    np.testing.assert_array_equal(out["disk_phi"], out["phi"])
    gold = Trainer(TrainerConfig(n_segments=4, **out_of_core_torch.BASE), callbacks=[Metrics()])
    gold.log = lambda m: None
    gold.fit()
    np.testing.assert_array_equal(out["phi"], np.asarray(gold.state[0]))
    np.testing.assert_array_equal(out["psi"], np.asarray(gold.state[1]))
    np.testing.assert_array_equal(out["z"], gold._z)
    np.testing.assert_array_equal(out["alpha"], np.asarray(gold.alpha))


JAX_BIG = r"""
import json, sys
sys.path.insert(0, %(examples)r)
from big_model import per_device_bytes
from repro.training import Metrics, Trainer, TrainerConfig
import big_model_torch as twin
cfg = TrainerConfig(**twin.CFG)
trainer = Trainer(cfg, callbacks=[Metrics()]).setup()
trainer.log = lambda m: None
trainer.fit()
state = [trainer.state[0]]
if trainer._tables is not None:
    state += [trainer._tables.wq, trainer._tables.wp, trainer._tables.wa]
print("RESULT" + json.dumps(dict(used=sum(per_device_bytes(a) for a in state),
                                 rows=trainer.sc0.rows_per_shard)))
"""


def test_big_model_twin_holds_the_jax_examples_bytes():
    import big_model_torch
    from conftest import run_with_devices

    ranks = big_model_torch.main(device="cpu")
    assert len(ranks) == big_model_torch.D * big_model_torch.P == 8
    out = run_with_devices(JAX_BIG % dict(examples=EXAMPLES), n_devices=8, timeout=600)
    want = json.loads(next(ln for ln in out.splitlines() if ln.startswith("RESULT"))[6:])
    K = big_model_torch.CFG["n_topics"]
    for r in ranks:
        assert r["used"] == want["used"], r
        assert r["replicated_need"] == want["rows"] * K * 16
        assert r["used"] <= r["budget"] and r["used"] * big_model_torch.P >= r["replicated_need"]
    assert len({r["ll"] for r in ranks}) == 1              # one pod, one LL
