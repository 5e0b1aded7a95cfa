"""The window and the per-step arithmetic: the last step that starts
inside the window runs to its end and the window ends with it; a rate is
all the work over all the window's time."""

import pytest

from zkbench import harness
from zkbench.runners import prove, tree
from zkbench.reference import tree_check


class Ticks:
    """A cell whose steps each take `dt` of a fake clock."""

    def __init__(self, clock, dt):
        self.clock, self.dt, self.n = clock, dt, 0

    def step(self):
        self.clock[0] += self.dt
        self.n += 1


def test_window_runs_the_last_step_to_its_end(monkeypatch):
    clock = [0.0]
    monkeypatch.setattr(harness.time, "perf_counter", lambda: clock[0])
    cell = Ticks(clock, 0.7)
    assert harness.window(cell, 2.0) == pytest.approx(2.1)
    assert cell.n == 3
    cell = Ticks([0.0], 1.0)
    clock2 = cell.clock
    monkeypatch.setattr(harness.time, "perf_counter", lambda: clock2[0])
    assert harness.window(cell, 0.0) == pytest.approx(1.0)


def test_prove_seconds_per_proof():
    cell = prove.Cell.__new__(prove.Cell)
    cell.proofs = [object()] * 16
    assert cell.end_to_end(24.0) == {"prove_s": 1.5}


def test_tree_hashes_per_second():
    cell = tree.Cell.__new__(tree.Cell)
    cell.n, cell.depth = 1 << 27, 28
    cell.builds = [(0, 1)] * 12
    # 2^27 - 1 hashes on the populated levels and one above them
    assert tree_check.hashes_a_build(1 << 27, 28) == 1 << 27
    assert cell.end_to_end(30.0) == {"tree_hashes_per_s": 12 * 2 ** 27 / 30}
    assert tree_check.level_sizes(5, 4) == [5, 3, 2, 1, 1]
    assert tree_check.hashes_a_build(5, 4) == 7


def test_span_mean_over_traced_steps():
    ctx = harness.Context(None, [{"a": 1.0, "b": 2.0}, {"a": 3.0, "b": 0.5}],
                          {})
    assert ctx.span_mean("a") == 2.0
    assert ctx.span_mean(["a", "b"]) == pytest.approx(3.25)
    assert ctx.span_mean("zz") is None
