"""The benchmark's own tests: CPU tests of its generator, reference,
yardstick and harness, and tests marked ``cuda`` that need the card (run
them there with ``python3 -m pytest portbench/tests -m cuda``)."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips where none is present")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.fixture(autouse=True)
def few_threads():
    """Two intra-op threads: the tests run the model at its widths on the
    CPU beside other test processes."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)
