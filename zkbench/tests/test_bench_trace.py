"""The profiler arithmetic on synthetic intervals: the union of device
intervals, the idle share and the gaps by what the host was doing."""

import pytest

from zkbench import trace as tr


def test_union_merges_overlaps_and_touching():
    assert tr.union([(5, 6), (0, 2), (1, 3), (3, 4)]) == [(0, 4), (5, 6)]
    assert tr.busy([(0, 2), (1, 3), (10, 11)]) == 4


def test_idle_share_of_a_window():
    ops = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0)]
    assert tr.idle_share(ops, 0.0, 5.0) == pytest.approx(40.0)
    # only the part inside the window counts
    assert tr.idle_share([(-1.0, 1.0)], 0.0, 2.0) == pytest.approx(50.0)


def test_gaps_and_labels():
    ops = [("k_a", 1.0, 2.0), ("k_b", 2.0, 3.0), ("k_a", 4.0, 4.5)]
    s = tr.Summary(ops, 0.0, 5.0,
                   lambda t: "assemble" if t < 3.6 else "plan_z")
    assert tr.gaps(s.intervals, 0.0, 5.0) == [(0.0, 1.0), (3.0, 4.0),
                                              (4.5, 5.0)]
    assert s.busy_s == pytest.approx(2.5)
    assert s.window_s == 5.0
    assert s.idle_percent() == pytest.approx(50.0)
    gaps = dict(s.idle_gaps())
    assert gaps == {"assemble": pytest.approx(2.0), "plan_z": pytest.approx(0.5)}
    assert s.device_ops()[0] == ["k_a", 1.5]
    assert s.seconds_of(["k_b"]) == pytest.approx(1.0)


def test_ops_outside_the_window_are_dropped():
    s = tr.Summary([("k", -3.0, -2.0), ("k", 1.0, 2.0)], 0.0, 4.0)
    assert s.busy_s == pytest.approx(1.0)
