"""pytest settings of the benchmark's own tests (servebench/tests)."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA card; skipped, with its reason, elsewhere")
