"""The launch path of the port's SCU kernels (K3-K5), without a card.

``barrier_form`` picks K3's form from the shapes alone; the wrappers refuse
what their kernels do not take before anything is built.  The kernels'
results on CPU tensors against the JAX package are in
``test_torch_sync_chip.py``.
"""

import pytest
import torch

from repro_torch.kernels.scu_barrier import kernel as scu_kernel
from repro_torch.kernels.scu_barrier.kernel import barrier_form

ROW_CAP = 12_288  # the cluster form's words a party: 48 KB of shared memory


@pytest.mark.parametrize("cluster_parties", [0, 8, 16])
@pytest.mark.parametrize("n", [1, 8, 9, 16, 17, 4224])
@pytest.mark.parametrize("m", [1, ROW_CAP, ROW_CAP + 1])
def test_barrier_form_takes_the_cluster_exactly_where_one_holds_the_parties(cluster_parties, n, m):
    want = "cluster" if n <= cluster_parties and m <= ROW_CAP else "dissemination"
    assert barrier_form(n, m, cluster_parties, ROW_CAP) == want


@pytest.mark.parametrize("n,m", [(0, 1), (1, 0), (-1, 4)])
def test_barrier_form_refuses_no_parties_or_no_words(n, m):
    with pytest.raises(ValueError, match="at least one party"):
        barrier_form(n, m, 8, ROW_CAP)


def _no_build():
    raise AssertionError("a wrapper reached the build before it refused its input")


WRAPPERS = {
    "scu_barrier": lambda t: scu_kernel.scu_barrier(t),
    "scu_notifier": lambda t: scu_kernel.scu_notifier(t, 0),
    "scu_self_signal": lambda t: scu_kernel.scu_self_signal(t),
}
BAD = {
    "cpu": torch.ones(4, 2),
    "float64": torch.ones(4, 2, dtype=torch.float64),
    "empty": torch.ones(0, 2),
}


@pytest.mark.parametrize("wrapper", sorted(WRAPPERS))
@pytest.mark.parametrize("bad", sorted(BAD))
def test_wrappers_refuse_before_any_build(monkeypatch, wrapper, bad):
    monkeypatch.setattr(scu_kernel, "build", _no_build)
    launches = getattr(scu_kernel, wrapper).launches
    with pytest.raises(ValueError, match="on the card"):
        WRAPPERS[wrapper](BAD[bad])
    assert getattr(scu_kernel, wrapper).launches == launches
