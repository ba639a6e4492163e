"""Shared helpers of the simulator tests: the port and ``repro`` side by side.

``REF`` and ``PORT`` hold the same modules of each package under the same
names, so one scenario, written once against a side, runs on both; ``plain``
turns what it returns (dataclasses, enums, numpy values, exceptions) into
plain Python, and ``assert_same`` compares two such values: integers and
strings exactly, floats within a relative 1e-12.
"""

from __future__ import annotations

import dataclasses
import enum
import importlib
import math
import types

import numpy as np

MODULES = {
    "scu": "core.scu",
    "engine": "core.scu.engine",
    "faults": "core.scu.faults",
    "extensions": "core.scu.extensions",
    "scu_unit": "core.scu.scu_unit",
    "trace": "core.scu.trace",
    "programs": "core.scu.programs",
    "checkpoint": "core.scu.checkpoint",
    "energy": "core.scu.energy",
    "apps": "core.scu.apps",
    "arrivals": "serve.arrivals",
    "serve_energy": "serve.energy",
    "fleet_service": "serve.fleet_service",
    "fleet_pool": "serve.fleet_pool",
    "sync": "sync",
}

POLICIES = ("scu", "tas", "sw", "tree", "tree4", "tree_ew", "fifo")
REL = 1e-12


def side(package: str) -> types.SimpleNamespace:
    return types.SimpleNamespace(**{key: importlib.import_module(f"{package}.{path}") for key, path in MODULES.items()})


REF = side("repro")
PORT = side("repro_torch")


def plain(obj):
    """``obj`` as plain Python values, with every class name dropped."""
    if isinstance(obj, BaseException):
        return {"raised": type(obj).__name__, "message": str(obj), "graph": plain(getattr(obj, "graph", None))}
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: plain(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, enum.Enum):
        return obj.name
    if isinstance(obj, dict):
        return {plain(k): plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [plain(v) for v in obj]
    if isinstance(obj, (set, frozenset)):
        return sorted(plain(v) for v in obj)
    if isinstance(obj, np.ndarray):
        return plain(obj.tolist())
    if isinstance(obj, np.generic):
        return obj.item()
    return obj


def assert_same(a, b, path: str = "") -> None:
    """``a`` equals ``b`` (both ``plain``): numbers of the same kind, floats within ``REL``."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), f"{path}: keys {sorted(a)} != {sorted(b)}"
        for k in a:
            assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b), f"{path}: {len(a)} items != {b!r:.200}"
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, float) or isinstance(b, float):
        assert isinstance(a, float) and isinstance(b, float), f"{path}: {a!r} and {b!r} are not both floats"
        assert a == b or math.isclose(a, b, rel_tol=REL, abs_tol=0.0), f"{path}: {a!r} != {b!r}"
    else:
        assert type(a) is type(b) and a == b, f"{path}: {a!r} != {b!r}"


def same_on_both(scenario, *args, **kwargs):
    """Runs ``scenario(side, ...)`` on ``repro`` and on the port; asserts the
    two results are the same and returns the port's (plain)."""
    ref = plain(scenario(REF, *args, **kwargs))
    got = plain(scenario(PORT, *args, **kwargs))
    assert_same(got, ref)
    return got
