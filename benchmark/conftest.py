"""pytest settings of the benchmark's own tests (``python -m pytest benchmark``)."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card; skips with a reason where there is none")
