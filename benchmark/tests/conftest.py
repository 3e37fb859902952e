"""The benchmark's tests run on the CPU; those marked ``cuda`` need the
card and skip without one (each decides inside the test)."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips without one")
