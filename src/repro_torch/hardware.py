"""The peak rates of one NVIDIA H100 SXM, the card the port runs on.

NVIDIA H100 SXM data sheet, dense rates, at the full 700 W power limit.  This
module is their one home in the port: the kernels' bounds
(``kernels/costs.py``), the step's roofline (``launch/roofline.py``),
``chip_smoke.py`` and ``scripts/bench_flash_attention.py`` read them here.
"""

from __future__ import annotations

__all__ = ["HBM_BW", "LINK_BW", "PEAK_FLOPS"]

PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}  # dense tensor-core bf16; float32 on the CUDA cores
HBM_BW = 3.35e12  # bytes/s of HBM3
LINK_BW = 450e9  # bytes/s of NVLink, each way
