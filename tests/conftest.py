import os

# Tests run on the single host CPU device (the dry-run, and ONLY the
# dry-run, forces 512 placeholder devices in its own process).
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import sys
from pathlib import Path

SRC = Path(__file__).resolve().parents[1] / "src"
ROOT = Path(__file__).resolve().parents[1]
for p in (str(SRC), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card (the port's hand-written "
        "kernels); skips without one")
