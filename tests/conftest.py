import os
import sys

# smoke tests and benches must see the plain 1-device CPU backend (the 512-way
# device-count override belongs ONLY to launch/dryrun.py)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
# make sibling test helpers (_hypothesis_compat) importable under any
# pytest import mode
sys.path.insert(0, os.path.dirname(__file__))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card (a CUDA kernel has no CPU "
        "mode); skips elsewhere")
