import os
import sys

# tests run on the single real CPU device (the 512-device override is
# exclusively dryrun.py's)
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
# make tests/_hyp.py (guarded hypothesis import) importable from test modules
sys.path.insert(0, os.path.dirname(__file__))


def pytest_configure(config):
    # tests that need an NVIDIA card; each skips inside its ``cuda`` fixture
    # when there is none (run them on the card with ``-m cuda``)
    config.addinivalue_line("markers", "cuda: needs an NVIDIA card (skips without one)")
