"""Settings of the benchmark's own tests (``python -m pytest
gpubench/tests``): the ``card`` marker for tests that need a CUDA card,
which skip on a machine without one."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips without one")
