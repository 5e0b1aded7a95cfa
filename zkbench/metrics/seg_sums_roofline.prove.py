"""seg_sums_roofline.prove: the MSMs' segment sums (kernels k_seg_sums_g1
and k_seg_sums_g2, csrc/seg_scan.cu and seg_scan_g2.cu), percent of their
device time that the work the window's scalars need would take at the
card's published peaks (counts.py: a complete add for each non-zero digit
that is not the first in its bucket)."""

from zkbench import counts

KERNELS = ("k_seg_sums_g1", "k_seg_sums_g2")


def read(ctx):
    work = ctx.work.get("seg_sums")
    if ctx.trace is None or not work:
        return None
    seconds = ctx.trace.seconds_of(KERNELS)
    if seconds <= 0:
        return None
    return 100.0 * counts.least_seconds(work["muls"], work["bytes"]) / seconds
