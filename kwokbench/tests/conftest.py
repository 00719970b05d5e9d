"""Fixtures of the benchmark's own tests (``python -m pytest kwokbench/tests``)."""

import pytest


@pytest.fixture
def card():
    """Skips unless PyTorch sees a CUDA card: decided here, when the test
    runs, never while a module is imported."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the benchmark's chip runs cover it")
    return torch.device("cuda")
