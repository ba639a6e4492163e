"""Training over the ``model`` axis across processes, against the JAX
package's ``train`` on the same 2 x 2 mesh: MLA with its whole latents, the
MoE layer with its whole router, experts over ``model``, shared experts and
a dense first layer (deepseek, an expert overflowing), under remat "full"
so that the recomputed groups issue their collectives again in the
backward.

The group job, tolerances and checks of
``tests/test_torch_dist_model_train.py`` (``tests/_torch_model_train.py``),
with a group of its own.
"""

import pytest
import torch

from repro_torch.models.layers import moe as tmoe
from repro_torch.models.lm import lm_loss
from repro_torch.train.checkpoint import restore_checkpoint
from repro_torch.train.data import SyntheticLM, make_batch_fn
from repro_torch.train.step import abstract_params
from tests import _torch_model_train as mt
from tests._torch_dist import float32_smoke

ARCH = "deepseek-v2-lite-16b"
RUNS = ((ARCH, "scu", "full"),)


@pytest.fixture(scope="module")
def got(tmp_path_factory):
    root = tmp_path_factory.mktemp("dist_model_train_moe")
    return mt.finish(root, mt.start(root, RUNS), RUNS)


def test_losses_and_grad_norms_equal_the_jax_train_on_2x2(got):
    mt.check_losses(got, ARCH, "scu")


def test_each_rank_gradient_is_its_block_of_the_one_process_gradient(got):
    mt.check_gradient_blocks(got, ARCH)


def test_parameter_blocks_after_three_steps_equal_jax(got):
    mt.check_parameter_blocks(got, ARCH)


def test_every_copy_of_a_block_holds_the_same_bits(got):
    mt.check_copies_agree(got, ARCH)


def test_an_expert_overflows_in_the_moe_run(got, monkeypatch):
    """The run drops slots past an expert's capacity (1.25 of the mean load)
    at step 0: the dispatch's scratch row is reached."""
    cfg = float32_smoke(ARCH)
    dropped = []
    real = tmoe.dispatch_indices

    def counted(idx, n_experts, capacity):
        dest, token, order = real(idx, n_experts, capacity)
        dropped.append(int((dest == n_experts * capacity).sum()))
        return dest, token, order

    monkeypatch.setattr(tmoe, "dispatch_indices", counted)
    params = restore_checkpoint(str(got["root"] / f"step0_{ARCH}"), 0, {"params": abstract_params(cfg, torch.float32)},
                                device="cpu")["params"]  # fmt: skip
    batch = make_batch_fn(SyntheticLM(vocab_size=cfg.vocab_size, seq_len=mt.SEQ, seed=0), mt.BATCH)(0)
    with torch.no_grad():
        lm_loss(params, cfg, {k: torch.from_numpy(v).long() for k, v in batch.items()})
    assert len(dropped) == cfg.n_layers - cfg.moe.first_k_dense and sum(dropped) > 0, dropped
