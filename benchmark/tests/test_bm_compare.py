"""The rules that pick what ``change_gap`` compares, and the serving mix's
arrivals."""

import torch

import tiny  # noqa: F401  (puts the checkout on the path)

from benchmark.harness import compare
from benchmark.traffic import pages


def test_an_entry_a_later_step_first_moves_is_compared():
    step1 = [torch.tensor([1.0, 0.0, 1e-9, 1.0])]
    step2 = [torch.tensor([1.0, 0.5, 1e-9, 1.0])]
    kept = compare.moved_entries(step2, compare.moved_entries(step1))
    assert kept[0].tolist() == [True, True, False, True]


def test_entries_are_judged_by_their_own_leaf():
    small, large = torch.full((4,), 1e-6), torch.full((4,), 1.0)
    kept = compare.moved_entries([small, large, torch.zeros(3)])
    assert kept[0].all() and kept[1].all()
    assert not kept[2].any()  # a leaf with no gradient moves nothing


def test_a_leaf_a_later_step_first_moves_is_compared():
    first = compare.moved([1.0, 1.0, 0.0])
    assert first == [True, True, False]
    assert compare.moved([1.0, 1.0, 0.5], first) == [True, True, True]


def test_what_is_left_out_is_counted():
    grads = [torch.tensor([1.0, 1e-9, 0.0]), torch.zeros(2)]
    text = compare.left_out(compare.moved([1.0, 0.0]), compare.moved_entries(grads),
                            compare.touched(grads))
    assert text.startswith("1 of 2 leaves, 4 of 5 entries (80.0000%), 3 of them")


def test_arrivals_are_fixed_by_the_rate_and_pages_by_the_seed():
    mix = dict(pages=5, rate_per_s=4.0)
    a, b = pages.Arrivals(mix, 7), pages.Arrivals(mix, 7)
    assert [a.page(k) for k in range(12)] == [b.page(k) for k in range(12)]
    assert sorted(a.page(k) for k in range(5)) == list(range(5))
    assert a.at(3) == 0.75 and a.arrived(0.0) == 1 and a.arrived(1.0) == 5
    assert [pages.Arrivals(mix, 8).page(k) for k in range(12)] != [a.page(k) for k in range(12)]
