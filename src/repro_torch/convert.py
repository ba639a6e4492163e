"""Parameter bridge: the JAX package's parameter tree, as numpy, to this package's.

Both packages keep parameters as the same nested dict with the same leaf
names and the same stacked leading group axis, so a converted tree compares
leaf by leaf.  This module imports no jax: the caller turns the JAX arrays
into numpy arrays first (``jax.tree.map(np.asarray, params)``).
"""

from __future__ import annotations

from typing import Any, Optional, Union

import numpy as np
import torch

__all__ = ["from_jax_params"]


def _leaf(x: Any, dtype: Optional[torch.dtype], device: Union[str, torch.device]) -> torch.Tensor:
    arr = np.asarray(x)
    target = dtype
    if arr.dtype.name == "bfloat16":
        # numpy has no bfloat16 of its own (it arrives as ml_dtypes.bfloat16) and
        # torch reads none from numpy: go through float32, which holds every
        # bfloat16 value exactly
        arr = arr.astype(np.float32)
        target = dtype if dtype is not None else torch.bfloat16
    t = torch.from_numpy(np.array(arr, order="C"))  # a copy: the tensor owns writable memory
    if target is not None and t.is_floating_point():
        t = t.to(target)
    return t.to(device)


def from_jax_params(
    tree: Any, dtype: Optional[torch.dtype] = None, device: Union[str, torch.device] = "cpu"
) -> Any:
    """Nested dict of numpy arrays -> the same nested dict of tensors on ``device``.

    With ``dtype=None`` every leaf keeps its own type (bfloat16 stays bfloat16,
    float32 norms stay float32); a given ``dtype`` is applied to every
    floating-point leaf.
    """
    if isinstance(tree, dict):
        return {k: from_jax_params(v, dtype, device) for k, v in tree.items()}
    return _leaf(tree, dtype, device)
