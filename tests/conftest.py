"""Test env: a handful of host devices for the distributed-path tests.

NOTE: this deliberately requests 4 (not 512) devices -- the 512-device
production mesh exists only inside ``repro.launch.dryrun`` (per assignment).
"""

import importlib.util
import os
import sys
from pathlib import Path

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=4")

# repo root on sys.path so `import benchmarks` works under pytest
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

# Offline fallback: when the real hypothesis isn't installed (this container
# cannot pip install), alias the deterministic shim in before collection so
# `from hypothesis import given, settings` in the test modules keeps working.
if importlib.util.find_spec("hypothesis") is None:
    from tests import _hypothesis_compat

    sys.modules["hypothesis"] = _hypothesis_compat
    sys.modules["hypothesis.strategies"] = _hypothesis_compat.strategies


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and nvcc; skipped where there is none"
    )
