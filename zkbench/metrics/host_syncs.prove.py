"""host_syncs.prove: the host reads of the card in a prove's scalar plan
and MSMs (trace.wait in ops/msm_device.py and ops/ec.py, under the stage
spans plan_z and msm_*; the site `trace`, the stage synchronizes a traced
prove adds, excluded), mean count a prove over the proves that start in
the traced window."""

from zkbench import spans

OWN = "trace"


def read(ctx):
    proves = spans.roots(ctx, "prove")
    if not proves:
        return None
    return sum(len(waits(g)) for g in proves) / len(proves)


def waits(group):
    """The program's own waits in one prove's MSM stages."""
    return [w for r in spans.under(group, spans.MSM_STAGES)
            for w in r["waits"] if w[0] != OWN]
