"""gather_s.prove: the MSMs' gather of base points into sorted order
(ops/msm_device.sorted_stream's index_select; device spans `gather` of
the program's tracer, one a chunk), mean device seconds a prove over the
proves that start in the traced window."""

from zkbench import spans


def read(ctx):
    proves = spans.roots(ctx, "prove")
    secs = spans.device_seconds(spans.named(proves, "gather"))
    return None if secs is None else secs / len(proves)
