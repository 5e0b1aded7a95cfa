"""The result line: its keys and their order (the compared numbers
last), and no result without a card."""

import json

import pytest
import torch

import tinycells as T
from zkbench import harness


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_no_card_no_result(no_card, capsys):
    rc = harness.main(["--workload", "tree.tree28", "--seed", "3",
                       "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc == 2 and out.out == ""
    assert "no CUDA device" in out.err


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_format(trace):
    torch.set_num_threads(2)

    class Small(T.TinyBench):
        def config(self, name):
            cfg = super().config(name)
            cfg.update({"leaves": 32, "tree_depth": 6})
            return cfg
    out = harness.run("tree.tree28", 2 ** 31 + 3, 0.0, trace, bench=Small(),
                      device="cpu", require_card=False, log=lambda s: None)
    keys = list(out)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                        "device"]
    assert keys[-1] == "checks"
    assert ("breakdown" in out) == trace
    assert set(out["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    if trace:
        assert {"busy_s", "window_s"} <= set(out["device"])
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
        assert out["metrics"] == {}          # no device trace on the CPU
    else:
        assert set(out["metrics"]) == {"tree_hashes_per_s", "setup_s"}
        assert out["metrics"]["setup_s"]["unit"] == "s"
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}
    json.loads(json.dumps(out))


@pytest.mark.card
def test_card_run_prints_a_result(card):
    """On the card: the cell's whole run (python3 -m zkbench) prints one
    result line last."""
    import subprocess
    import sys
    from zkbench import manifest
    p = subprocess.run([sys.executable, "-m", "zkbench", "--workload",
                        "tree.tree28", "--seed", "2147483999", "--seconds",
                        "2", "--trace", "0"], cwd=manifest.ROOT,
                       capture_output=True, text=True, timeout=900)
    assert p.returncode == 0, p.stderr[-2000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the chip")
