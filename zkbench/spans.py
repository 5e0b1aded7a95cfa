"""The program's own spans (zkpos_tpu_torch/utils/trace.py), as the
per-layer readers read them: each root of one name that started inside the
traced window, with its spans.  A program without the tracer, or a window
without such a root, gives none, and the reader then reports nothing."""

from __future__ import annotations

import importlib
from typing import Dict, List


def program_records() -> List[Dict]:
    """Every record the program's tracer keeps ([] without a tracer)."""
    try:
        trace = importlib.import_module("zkpos_tpu_torch.utils.trace")
    except ImportError:
        return []
    return trace.records()


def roots(ctx, name: str) -> List[List[Dict]]:
    """Each root span `name` whose start falls inside ctx.trace's window,
    as a list: the root, then its spans in the order they opened."""
    if ctx.trace is None:
        return []
    recs = program_records()
    found = {r["id"]: [r] for r in recs
             if r["parent"] is None and r["name"] == name
             and ctx.trace.start <= r["start"] <= ctx.trace.end}
    for r in recs:
        if r["parent"] is not None and r["root"] in found:
            found[r["root"]].append(r)
    return list(found.values())


# the stages of a prove that plan and run its MSMs
MSM_STAGES = ("plan_z", "msm_a", "msm_b1", "msm_b2", "msm_k", "msm_z")


def under(group: List[Dict], stages) -> List[Dict]:
    """The records of one root's group inside its child spans named in
    `stages`, those spans included (a parent opens before its children)."""
    inside = set()
    for r in group[1:]:
        if (r["parent"] == group[0]["id"] and r["name"] in stages) \
                or r["parent"] in inside:
            inside.add(r["id"])
    return [r for r in group if r["id"] in inside]


def named(groups: List[List[Dict]], name: str) -> List[Dict]:
    """The spans called `name` in all the groups."""
    return [r for g in groups for r in g if r["name"] == name]


def host_seconds(spans: List[Dict]) -> float:
    return sum(r["end"] - r["start"] for r in spans)


def device_seconds(spans: List[Dict]):
    """The spans' summed device seconds; None when any has none (no
    card) or there are none."""
    secs = [r["device_s"] for r in spans]
    return sum(secs) if secs and None not in secs else None
