"""Helpers shared by the ``test_torch_*`` parity tests.

Inputs are made with numpy from a seed and handed to both frameworks: JAX and
PyTorch draw different numbers from one seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro_torch.convert import from_jax_params

JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# float32: the same arithmetic in another summation order.  bfloat16: 8 bits
# of mantissa, and the two frameworks round intermediates at different places.
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def normal(rng, *shape):
    return rng.standard_normal(shape, dtype=np.float32)


def both(x, dtype="float32"):
    """One numpy array as (jax array, torch tensor) of ``dtype``."""
    return jnp.asarray(x, JNP[dtype]), torch.from_numpy(np.ascontiguousarray(x)).to(TORCH[dtype])


def f32(x):
    """A jax array or a torch tensor as a float32 numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x, dtype=np.float32)


def close(a, b, tol):
    np.testing.assert_allclose(f32(a), f32(b), rtol=tol, atol=tol)


def jax_to_torch_params(params, device="cpu"):
    """A JAX parameter tree as the port's: the jax -> numpy step, then ``convert``."""
    return from_jax_params(jax.tree.map(np.asarray, params), device=device)


def tree_close(a, b, tol):
    """Every leaf of a torch tree equals the leaf of a jax tree at the same path."""
    if isinstance(a, dict):
        assert set(a) == set(b), (sorted(a), sorted(b))
        for key in a:
            tree_close(a[key], b[key], tol)
        return
    assert tuple(a.shape) == tuple(b.shape)
    close(a, b, tol)
