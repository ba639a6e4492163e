"""The bf16 forward's schedule (``kernel.fwd_band``, ``fwd_items``,
``fwd_deal``: the twins of the CUDA source's ``band_of``, ``item`` and
``number_of``), held on the CPU at the ten archs' prefill head layouts, a
model = 2 rank's and the edges of the rule.  ``tests/test_torch_cuda_kernels.py``
holds the source's band to ``fwd_band`` on the card."""

from collections import Counter

import pytest

from repro_torch.configs.registry import ARCHS, get_config
from repro_torch.kernels.flash_attention import kernel as flash_kernel
from repro_torch.kernels.flash_attention.kernel import fwd_band, fwd_deal, fwd_items

# (h, kvh) of every arch that runs attention, and a model = 2 rank's of phi4 and deepseek
PREFILL_HEADS = sorted({(c.n_heads, c.n_kv_heads) for c in map(get_config, ARCHS) if c.n_heads > 1}
                       | {(12, 4), (8, 8)})  # fmt: skip
# the serving length, one past a tile, ragged lengths, one q tile, one query
LENGTHS = [4096, 4097, 333, 200, 128, 77, 1]
SMS = 132  # the H100's: the grid is min(items, SMs) CTAs


def test_the_archs_layouts_are_covered():
    # stablelm / deepseek / codeqwen / musicgen 1, phi4 3, jamba 4, llava 7, qwen3-moe 8, command-r 12
    assert {h // kvh for h, kvh in PREFILL_HEADS} >= {1, 3, 4, 7, 8, 12}


@pytest.mark.parametrize("h,kvh", PREFILL_HEADS)
@pytest.mark.parametrize("s", LENGTHS)
def test_band_makes_about_eight_ctas_share_a_kv_head(h, kvh, s):
    g, n_qt = h // kvh, -(-s // 128)
    band = fwd_band(h, kvh, s)
    assert 1 <= band <= n_qt
    # a band's items of one kv head: at least eight, or every q tile there is
    assert band * g >= 8 or band == n_qt
    # and no more than needed: one q tile fewer would fall short of eight
    assert band == 1 or (band - 1) * g < 8


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b", [1, 4])
@pytest.mark.parametrize("h,kvh", PREFILL_HEADS)
@pytest.mark.parametrize("s", LENGTHS)
def test_items_deal_every_q_tile_of_every_head_once(b, h, kvh, s, causal):
    """Each (batch, q head, q tile) is one item, whose key tiles are those its
    q tile needs; the CTAs of the grid take every item exactly once."""
    n_qt = -(-s // 128)
    items = fwd_items(b, h, kvh, s, s, causal)
    assert Counter((bt, hd, qt) for bt, hd, qt, _ in items) == Counter(
        (bt, hd, qt) for bt in range(b) for hd in range(h) for qt in range(n_qt))
    assert all(tiles == (qt + 1 if causal else n_qt) for _, _, qt, tiles in items)
    dealt = fwd_deal(len(items), min(len(items), SMS))
    assert sorted(w for cta in dealt for w in cta) == list(range(len(items)))


@pytest.mark.parametrize("h,kvh", PREFILL_HEADS)
@pytest.mark.parametrize("s", [4096, 333, 1000])
def test_items_go_heavy_first_band_by_band_with_a_kv_heads_q_heads_together(h, kvh, s):
    """A band's items come before the next band's and carry at least as many
    key tiles; within a band the q heads of one kv head are next to each
    other, so the CTAs that take them at once read the same K and V tiles."""
    b, g = 4, h // kvh
    band = fwd_band(h, kvh, s)
    items = fwd_items(b, h, kvh, s, s, True)
    per_band = band * b * h
    bands = [items[i:i + per_band] for i in range(0, len(items), per_band)]
    for earlier, later in zip(bands, bands[1:]):
        assert min(t for *_, t in earlier) >= max(t for *_, t in later)
    for chunk in bands:
        kv_heads = [(bt, hd // g) for bt, hd, _, _ in chunk]
        runs = sum(1 for i, key in enumerate(kv_heads) if i == 0 or key != kv_heads[i - 1])
        assert runs == len(set(kv_heads))  # each kv head's items form one run


@pytest.mark.parametrize("n_items,n_units", [(1, 1), (7, 7), (132, 132), (133, 132), (3072, 132), (5, 3)])
def test_deal_gives_every_item_to_one_cta_and_evens_them_out(n_items, n_units):
    dealt = fwd_deal(n_items, n_units)
    assert sorted(w for cta in dealt for w in cta) == list(range(n_items))
    counts = [len(cta) for cta in dealt]
    assert max(counts) - min(counts) <= 1


@pytest.mark.parametrize("h,kvh", [(24, 8), (56, 8), (96, 8), (32, 32), (12, 4)])
def test_ctas_get_about_the_same_work(h, kvh):
    """Heavy first, dealt in rounds that alternate their order: at the serving
    length no CTA's key tiles exceed the mean by more than 5 %."""
    items = fwd_items(4, h, kvh, 4096, 4096, True)
    work = [sum(items[w][3] for w in cta) for cta in fwd_deal(len(items), SMS)]
    assert max(work) <= 1.05 * sum(work) / len(work)


def test_fewer_items_than_sms_take_one_cta_each():
    items = fwd_items(1, 2, 1, 200, 200, True)  # 2 heads x 2 q tiles
    assert len(items) == 4
    assert fwd_deal(len(items), min(len(items), SMS)) == [[0], [1], [2], [3]]


def test_twin_builds_nothing(monkeypatch):
    def refuse(*_):
        raise AssertionError("the CUDA source was built")

    monkeypatch.setattr(flash_kernel, "build", refuse)
    assert [fwd_band(h, 8, 4096) for h in (24, 56, 96)] == [3, 2, 1]
    assert fwd_band(32, 32, 4096) == 8 and fwd_band(32, 32, 333) == 3
