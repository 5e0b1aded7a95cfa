"""msm_idle_s.prove: seconds a prove in which the card ran nothing while
the host was in the scalar plan or an MSM (the stage spans `plan_z`,
`msm_a`, `msm_b1`, `msm_b2`, `msm_k`, `msm_z` of the program's tracer,
each ending in a synchronize in a traced prove), from the profiler's
device intervals on the same clock; mean over the proves that start in
the traced window."""

from zkbench import spans
from zkbench import trace as tr


def read(ctx):
    proves = spans.roots(ctx, "prove")
    if not proves or not ctx.trace.ops:
        return None
    busy = tr.union(ctx.trace.intervals)
    idle = sum(b - a for g in proves for r in g
               if r["name"] in spans.MSM_STAGES and r["parent"] == g[0]["id"]
               for a, b in tr.gaps(busy, r["start"], r["end"]))
    return idle / len(proves)
