"""K1 and K2 counts on small hand-worked shapes."""

import pytest

from harness import roofline as R


def test_transform_and_tree_costs():
    # 1 column of 4: 2 stages of 2 butterflies (12 operations each),
    # then 4 scalings (6); 16 bytes read, 16 written
    assert R.interpolate_cost(1, 2) == (32, 72)
    # 4 coefficients on 8 points: 2 stages of 4 butterflies
    assert R.evaluate_cost(1, 2, 3) == (48, 96)
    assert R.evaluate_cost(3, 2, 3) == (144, 288)
    # 2 leaves of 1 word, 1 parent
    assert R.tree_cost(1, 1) == (4 * 2 + 32 * 2 + 96, 968 * 3)
    # 17 words a leaf take 2 compressions
    assert R.tree_cost(17, 3)[1] == 968 * (8 * 2 + 7)


def test_least_time_is_the_larger_bound():
    assert R.least_s(3.35e12, 0) == pytest.approx(1.0)
    assert R.least_s(0, 33.5e12) == pytest.approx(1.0)
    assert R.least_s(3.35e12, 67e12) == pytest.approx(2.0)


SHAPES = [(3, 1, 2, 1), (2, 0, 1, 0)]   # (n, pre, main, LogUp batches)


def test_trees():
    assert R.trees(SHAPES, 1) == {("pre", 3): 2, ("pre", 2): 1,
                                  ("main", 3): 2, ("main", 2): 1,
                                  ("inter", 3): 4, ("comp", 5): 4}


def test_k1_and_k2_work_by_hand():
    ls = R.least_s
    k1 = (ls(*R.interpolate_cost(2, 3)) + ls(*R.evaluate_cost(2, 3, 4))
          + ls(*R.interpolate_cost(1, 2)) + ls(*R.evaluate_cost(1, 2, 3))
          + ls(*R.interpolate_cost(2, 3)) + ls(*R.evaluate_cost(2, 3, 4))
          + ls(*R.interpolate_cost(1, 2)) + ls(*R.evaluate_cost(1, 2, 3))
          + ls(*R.interpolate_cost(4, 3)) + ls(*R.evaluate_cost(4, 3, 4))
          + ls(*R.evaluate_cost(4, 5, 6))
          # composition: n = 3: is_first + 1 + 2 + 4; n = 2: is_first + 1
          + ls(*R.evaluate_cost(8, 3, 5)) + ls(*R.interpolate_cost(4, 5))
          + ls(*R.evaluate_cost(2, 2, 4)) + ls(*R.interpolate_cost(4, 4)))
    assert R.k1_work(SHAPES, 1) == pytest.approx(k1)
    k2 = sum(ls(*R.tree_cost(c, s)) for c, s in
             [(2, 4), (1, 3), (2, 4), (1, 3), (4, 4), (4, 6)])
    assert R.k2_work(SHAPES, 1) == pytest.approx(k2)


def test_work_grows_with_the_trace():
    small = [(20, 0, 193, 61)]
    big = [(23, 0, 193, 61)]
    assert 7 < R.k1_work(big, 1) / R.k1_work(small, 1) < 10
    assert 7 < R.k2_work(big, 1) / R.k2_work(small, 1) < 9
