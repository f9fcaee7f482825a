"""Shared pieces of the port's conformance tests (``tests/test_torch_*.py``)."""
import pytest
import torch


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Run torch's CPU ops on one thread.

    On some virtualized x86 hosts under heavy load (a full ``-n 6`` suite),
    one of torch's CPU worker threads now and then computes its whole chunk
    of a large elementwise op wrong by up to ~1e-4 (e.g. 441,240 of the
    524,288 ``prng.gumbel`` values in rows 1536-2047 of the 4096x1024 grid of
    ``test_torch_prng.py``, 8 threads). The same call repeated in the same
    process is exact, and the JAX side is unaffected. It was seen in about 1
    of 60 fresh 8-thread processes and in none of 60 one-thread ones. The
    port's tests compare argmaxes of logs bit for bit, so they pin one thread.
    """
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

