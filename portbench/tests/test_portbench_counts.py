"""The frozen work counts against hand counts on tiny shapes."""

import pytest

from portbench.reference import counts


def test_peaks():
    assert counts.ISSUE_OPS_PER_S == pytest.approx(132 * 4 * 32 * 1.98e9)
    assert counts.least_s(3.35e12, 0) == pytest.approx(1.0)
    assert counts.least_s(0, counts.ISSUE_OPS_PER_S) == pytest.approx(1.0)


def test_hash_ops_follow_the_rule():
    # a and b: one multiply-add each; three multiplies, five shifts and five logic operations
    assert counts.HASH_OPS == 2 + 3 + 5 + 5
    assert counts.SQ2D_OPS_PER_UPDATE == 16


def test_sq2d_need_by_hand():
    # 2 replicas of a 4 x 4 torus, 3 sweeps, 2 calls: 32 spins read and written and 2 seeds a call
    nbytes, ops = counts.sq2d_need(2, 4, 3, 2)
    assert nbytes == 2 * (2 * 32 + 8)
    assert ops == 2 * 2 * 16 * 3 * 16


def test_ladder_need_by_hand():
    # 2 rungs of 4 sites and 4 slices, 1 sweep, 5 heads
    nbytes, ops = counts.ladder_need(2, 4, 4, 1, 5)
    spins = 32
    assert nbytes == 2 * spins + 4 * 2 * 2 * 4 + 16 * 2
    assert ops == spins * (37 + 29) + 5 * 21
    assert counts.ladder_need(2, 4, 4, 3, 5) == (3 * nbytes, 3 * ops)


def test_ladder_phase_counts():
    h, lg = counts.HASH_OPS, counts.LOG_OPS
    assert counts.LADDER_SITE_OPS == h + 3 + 2 + 2 * lg + 4 + 2 + 5 + 2
    assert counts.LADDER_CLUSTER_OPS == h + 3 + 2 + 4 + 3 + 2
    assert counts.LADDER_HEAD_OPS == h + 3 + lg + 1
