"""PyTorch/CUDA port of the ``repro`` language-model path, for one NVIDIA H100.

The package mirrors the directory layout and the function names of the JAX
package ``repro``, so the counterpart of a module sits at the same relative
path.  It imports ``torch`` and numpy, never ``jax`` and nothing of ``repro``.
Entry points run on the card unless the caller passes ``device="cpu"``.
"""
