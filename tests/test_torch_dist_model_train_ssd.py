"""Training over the ``model`` axis across processes, against the JAX
package's ``train`` on the same 2 x 2 mesh: the SSD mixer with its heads
split, its whole ``in_B``/``in_C`` projections and conv, the whole
``in_dt``, ``A_log``, ``D`` and ``dt_bias`` sliced to a process's heads, and
the gated norm's mean of squares summed over ``model`` both ways (mamba2).

The group job, tolerances and checks of
``tests/test_torch_dist_model_train.py`` (``tests/_torch_model_train.py``),
with a group of its own.
"""

import pytest

from tests import _torch_model_train as mt

ARCH = "mamba2-1.3b"
RUNS = ((ARCH, "scu", "none"),)


@pytest.fixture(scope="module")
def got(tmp_path_factory):
    root = tmp_path_factory.mktemp("dist_model_train_ssd")
    return mt.finish(root, mt.start(root, RUNS), RUNS)


def test_losses_and_grad_norms_equal_the_jax_train_on_2x2(got):
    mt.check_losses(got, ARCH, "scu")


def test_each_rank_gradient_is_its_block_of_the_one_process_gradient(got):
    mt.check_gradient_blocks(got, ARCH)


def test_parameter_blocks_after_three_steps_equal_jax(got):
    mt.check_parameter_blocks(got, ARCH)


def test_every_copy_of_a_block_holds_the_same_bits(got):
    mt.check_copies_agree(got, ARCH)
