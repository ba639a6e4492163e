"""Device selection and the card's identity.

Counterpart of ``repro/compat.py``: there the question is which jax is
installed, here it is whether there is a card.  Entry points of this package
run on the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import contextlib
import subprocess
from typing import Iterator, Union

import torch
from torch._subclasses.fake_tensor import is_fake

__all__ = ["card_stand_in", "on_card", "resolve_device", "card_name_and_power_limit", "torch_dtype", "synchronize"]

_stand_in = False


def on_card(x: torch.Tensor) -> bool:
    """Whether ``x`` takes the card's route (the kernels): a CUDA tensor, or,
    inside ``card_stand_in()``, a fake tensor on any device."""
    return x.is_cuda or (_stand_in and is_fake(x))


@contextlib.contextmanager
def card_stand_in() -> Iterator[None]:
    """Fake tensors stand for the card's inside this block: they take the
    kernels' route (the kernels' fake ops: checks and allocations, no
    launch).  The dry run's use on a build of PyTorch without CUDA, where a
    fake CUDA tensor cannot enter autograd (its metadata asks the CUDA
    device guard, which such a build lacks, and the process aborts), so the
    fake tensors lie on the CPU there."""
    global _stand_in
    before, _stand_in = _stand_in, True
    try:
        yield
    finally:
        _stand_in = before


def resolve_device(device: Union[str, torch.device, None] = "cuda") -> torch.device:
    """The device to run on.  Raises without a card unless ``"cpu"`` was asked for."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: repro_torch runs on an NVIDIA GPU; pass device='cpu' "
                "(--device cpu) to run its plain PyTorch path on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def card_name_and_power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them, e.g. ``NVIDIA H100 80GB HBM3, 700.00 W``."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )  # fmt: skip
    return out.stdout.strip().splitlines()[0]


def torch_dtype(name: str) -> torch.dtype:
    """``ModelConfig.dtype`` (a numpy-style name) as a torch dtype."""
    return {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}[name]


def synchronize(device: torch.device) -> None:
    """Wait for the card before reading a host clock; nothing to wait for on the CPU."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
