"""Run one cell once and print its result line.

  python3 -m zkbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell's configuration, traffic mix and runner are found by name
(manifest.py).  A run: set-up (timed from the start of the process to
the first timed step: `setup_s`), a window of `--seconds` of back-to-back
steps (the last step that starts inside it runs to its end, and the window
ends with it), the device's peak read, the program's state freed, then the
check of what the window produced against the reference.  With --trace 1
the window runs under torch.profiler and the line carries the cell's
per-layer metrics instead of its end-to-end ones.

No card, or fewer than the cell asks for: exit 2, no result.  A module
whose top-level name is jax, jaxlib, flax or zkpos_tpu loaded by the end:
exit 3, no result.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time
from typing import Callable, Dict, List, Optional

from . import manifest

BANNED = ("jax", "jaxlib", "flax", "zkpos_tpu")
CACHE = os.path.join(manifest.HERE, "_cache")
MARK = "zkbench.window"


class NoCard(RuntimeError):
    pass


def banned_modules(modules=None) -> List[str]:
    """Loaded modules whose top-level name is one of BANNED, compared
    whole (zkpos_tpu_torch is not zkpos_tpu)."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in list(names) if m.split(".")[0] in BANNED)


def process_start() -> float:
    """The process's start on the perf_counter clock (Linux /proc)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - ticks / os.sysconf("SC_CLK_TCK")
        return time.perf_counter() - max(age, 0.0)
    except (OSError, ValueError, IndexError):
        return time.perf_counter()


def card_line() -> str:
    """The card's name, power limit, clocks and temperature (nvidia-smi)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm,"
             "clocks.sm,temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"
    return out.splitlines()[0] if out else "nvidia-smi gave nothing"


class Context:
    """What a per-layer metric's reader reads."""

    def __init__(self, trace, spans: List[dict], work: dict):
        self.trace, self.spans, self.work = trace, spans, work

    def span_mean(self, names) -> Optional[float]:
        """Mean over the traced steps of the summed seconds of `names`."""
        names = [names] if isinstance(names, str) else list(names)
        vals = [sum(sp[n] for n in names) for sp in self.spans
                if all(n in sp for n in names)]
        return sum(vals) / len(vals) if vals else None


def window(cell, seconds: float) -> float:
    t0 = time.perf_counter()
    while True:
        cell.step()
        if time.perf_counter() - t0 >= seconds:
            return time.perf_counter() - t0


def run(workload: str, seed: int, seconds: float, trace: bool,
        bench: Optional[manifest.Bench] = None, device=None,
        require_card: bool = True, start: Optional[float] = None,
        patch: Optional[Callable] = None, log=None,
        runner_of: Callable = manifest.runner) -> Dict[str, object]:
    """One run of a cell; returns the result line's object.  `patch(cell)`
    changes the cell before its set-up (a control, a planted fault);
    `runner_of(name)` gives a traffic mix's runner module."""
    import torch
    start = process_start() if start is None else start
    log = log or (lambda s: print(s, file=sys.stderr, flush=True))
    bench = bench or manifest.Bench()
    spec = bench.workload(workload)
    if require_card:
        if not torch.cuda.is_available():
            raise NoCard("no CUDA device: this benchmark runs on the card "
                         "only")
        if torch.cuda.device_count() < spec["chips"]:
            raise NoCard(f"{spec['chips']} cards wanted, "
                         f"{torch.cuda.device_count()} found")
    dev = torch.device(device or "cuda")
    on_card = dev.type == "cuda"
    traffic = bench.traffic(spec["traffic"])
    run_mod = runner_of(traffic["runner"])
    cell = run_mod.Cell(bench.config(spec["config"]), traffic, seed, dev,
                    cache_dir=CACHE, traced=trace)
    if patch is not None:
        patch(cell)
    card = card_line() if on_card else "cpu"
    log(json.dumps({"card": card, "workload": workload, "seed": seed}))
    parts = cell.setup()
    gc.collect()
    setup_s = time.perf_counter() - start
    log(json.dumps({"setup_parts_s": parts, "setup_s": setup_s}))

    def device_peak():
        return (max(torch.cuda.max_memory_allocated(i)
                    for i in range(torch.cuda.device_count()))
                if on_card else 0)
    peak_setup = device_peak()
    prof = summary = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if on_card else [])
        with profile(activities=acts) as prof:
            t_mark = time.perf_counter()
            with record_function(MARK):
                pass
            w0 = time.perf_counter()
            window_s = window(cell, seconds)
    else:
        w0 = time.perf_counter()
        window_s = window(cell, seconds)
    # a traced prove resets the peak at each of its stages and keeps each
    # stage's own (cell.stage_peak)
    peak = max(peak_setup, device_peak(), cell.stage_peak())
    log(json.dumps({"window_s": window_s, "memory_peak_bytes": peak}))
    if trace:
        from . import trace as tr
        offset = tr.marker_offset(prof, MARK, t_mark)
        ops = tr.device_ops_of(prof, offset) if offset is not None else []
        summary = tr.Summary(ops, w0, w0 + window_s, cell.host_label)
        del prof
    cell.release()
    t = time.perf_counter()
    checked = cell.check()
    log(json.dumps({"check_s": time.perf_counter() - t,
                    "check_notes": checked["notes"]}))

    if not trace:
        metrics = cell.end_to_end(window_s)
        metrics["setup_s"] = setup_s
        units = manifest.units(bench.end_to_end(workload))
    else:
        ctx = Context(summary, cell.spans(), cell.work())
        metrics, units = {}, {}
        for m in bench.per_layer(workload):
            v = manifest.reader(m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = v
                units[m["name"]] = m["unit"]
                if m["unit"] == "%" and "roofline" in m["name"]:
                    log(f"{m['name']} {v} % on {card}")
    numbers = checked["numbers"]
    out = {"correct": (checked["attempted"] > 0
                       and all(v <= lim for _, v, lim in numbers)),
           "attempted": checked["attempted"], "failed": checked["failed"],
           "metrics": {k: {"value": v, "unit": units[k]}
                       for k, v in metrics.items()},
           "device": {"platform": "gpu" if on_card else "cpu",
                      "kind": (torch.cuda.get_device_name(dev) if on_card
                               else "cpu"),
                      "count": spec["chips"], "memory_peak_bytes": peak}}
    if trace:
        out["device"]["busy_s"] = summary.busy_s
        out["device"]["window_s"] = summary.window_s
        out["breakdown"] = {"device_ops": summary.device_ops(),
                            "idle_gaps": summary.idle_gaps()}
    out["checks"] = {name: {"value": v, "limit": lim}
                     for name, v, lim in numbers}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m zkbench")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        out = run(args.workload, args.seed, args.seconds, bool(args.trace))
    except NoCard as e:
        print(f"zkbench: {e}", file=sys.stderr)
        return 2
    bad = banned_modules()
    if bad:
        print("zkbench: modules of JAX or the JAX package were loaded: "
              + ", ".join(bad), file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} = {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0
