"""upload_s.prove: the witness's way to the card (groth16.prove's span
`upload` around msm_device.scalars_tensor: its host conversion and its
pageable copy), mean host seconds a prove over the proves that start in
the traced window."""

from zkbench import spans


def read(ctx):
    proves = spans.roots(ctx, "prove")
    ups = spans.named(proves, "upload")
    return spans.host_seconds(ups) / len(proves) if ups else None
