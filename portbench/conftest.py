"""pytest settings of the benchmark's own tests (``python -m pytest
portbench/tests``): the ``cuda`` marker for tests that need an NVIDIA card;
each such test decides inside itself whether there is one, and skips
without it."""


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU (skips without one)")
