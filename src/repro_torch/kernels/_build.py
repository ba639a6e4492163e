"""Builds the CUDA sources of this package at first use and loads them.

``nvcc`` compiles a source with a plain C interface into a shared library
under ``build/repro_torch_kernels/`` at the root of the checkout; ``ctypes``
loads it.  The file name carries a hash of the source and the flags, so an
edited kernel is rebuilt and an unchanged one is not.  No PyTorch header is
included anywhere: that keeps a build at seconds.

A failed build raises with the compiler's output.  Nothing here catches it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence

import torch
from torch._subclasses.fake_tensor import is_fake

__all__ = ["NVCC_FLAGS", "build_dir", "load_library", "rows_aligned"]

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)  # fmt: skip

_LOADED: Dict[Path, ctypes.CDLL] = {}


def build_dir() -> Path:
    """``build/repro_torch_kernels`` at the root of the checkout."""
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch build only where the "
                       "CUDA toolkit is installed")


def load_library(name: str, sources: Sequence[Path]) -> ctypes.CDLL:
    """Compile ``sources`` into ``lib<name>-<hash>.so`` (unless it is there) and load it."""
    sources = [Path(s) for s in sources]
    digest = hashlib.sha256()
    for flag in NVCC_FLAGS:
        digest.update(flag.encode())
    for src in sources:
        digest.update(src.read_bytes())
    out = build_dir() / f"lib{name}-{digest.hexdigest()[:16]}.so"
    if out in _LOADED:
        return _LOADED[out]
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stdout}\n{proc.stderr}"
            )
        if proc.stderr.strip():
            # ptxas statistics (-Xptxas -v) and warnings come on stderr
            print(proc.stderr.strip())
        os.replace(tmp, out)  # atomic: a concurrent process never loads half a file
    lib = ctypes.CDLL(str(out))
    _LOADED[out] = lib
    return lib


def rows_aligned(x: torch.Tensor) -> bool:
    """Last dim contiguous and every row on a 16-byte boundary, as the kernels'
    16-byte copies need; a wrapper hands any other tensor over as a contiguous copy.
    A fake tensor (the dry run's) has no address and is taken as the
    allocator's, which aligns every block to far more than 16 bytes."""
    per16 = 16 // x.element_size()
    return (
        x.stride(-1) == 1
        and (is_fake(x) or x.data_ptr() % 16 == 0)
        and all(s % per16 == 0 for s in x.stride()[:-1])
    )
