import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (skips without one)")


@pytest.fixture
def repo_root():
    import os
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
