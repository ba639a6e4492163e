"""The dry run's count holds the JAX package's: for each of the ten smoke
configs, the FLOPs that the port's ``lm_forward`` dispatches on the CPU (its
plain versions, which compute the whole s x s attention product as the
reference's oracle does), counted by ``launch.dispatch_analysis``, equal the
dot FLOPs of ``repro.launch.hlo_analysis.analyze_hlo`` over the reference's
jitted ``lm_forward``, on the same params and tokens, within 2 %.

512 tokens make two SSD chunks: at one chunk XLA folds the carried state's
product away (the state entering the first chunk is the zero it starts
from), which the port computes, eagerly (PERF.md, Findings of the dry
run)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke_config as jax_smoke_config
from repro.configs.registry import list_archs
from repro.launch.hlo_analysis import analyze_hlo
from repro.models.lm import init_lm as jax_init_lm
from repro.models.lm import lm_forward as jax_lm_forward
from repro_torch.configs.registry import get_smoke_config
from repro_torch.launch.dispatch_analysis import analyze
from repro_torch.models.lm import lm_forward

from _torch_parity import jax_to_torch_params

B, S = 1, 512


@pytest.mark.parametrize("arch", list_archs())
def test_lm_forward_flops_hold_the_references_hlo(arch):
    jcfg, cfg = jax_smoke_config(arch), get_smoke_config(arch)
    params = jax_init_lm(jax.random.PRNGKey(0), jcfg, jnp.float32)
    rng = np.random.default_rng(0)
    if jcfg.frontend is not None:
        x = rng.standard_normal((B, S, jcfg.d_model), dtype=np.float32)
        key = "embeddings"
    else:
        x = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
        key = "tokens"
    hlo = jax.jit(lambda p, a: jax_lm_forward(p, jcfg, **{key: a})).lower(params, jnp.asarray(x)).compile().as_text()
    want = analyze_hlo(hlo).dot_flops
    with torch.no_grad():
        _, rec = analyze(lambda p, a: lm_forward(p, cfg, **{key: a}), jax_to_torch_params(params), torch.from_numpy(x))
    got = rec["dispatch_analysis"]["flops_per_device"]
    assert want > 0 and abs(got / want - 1) <= 0.02, (got, want)
    # bf16 products (the config's compute type) and float32 ones (the SSD scan's, the router's) make the whole
    d = rec["dispatch_analysis"]
    assert d["bf16_flops_per_device"] > 0 and d["bf16_flops_per_device"] + d["f32_flops_per_device"] == got
