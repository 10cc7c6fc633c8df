import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skipped without one")


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided when the test runs, never at import."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return "cuda"


@pytest.fixture
def toy(tmp_path):
    from annbench.tests.toy import toy_base
    return toy_base(str(tmp_path))
