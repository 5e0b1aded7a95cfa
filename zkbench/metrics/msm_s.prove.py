"""msm_s.prove: the five MSMs and the witness's scalar plan
(groth16.prove's spans `plan_z`, `msm_a`, `msm_b1`, `msm_b2`, `msm_k`,
`msm_z`: ops/msm_device.py and ops/ec.py), mean seconds a prove over the
traced window."""

STAGES = ("plan_z", "msm_a", "msm_b1", "msm_b2", "msm_k", "msm_z")


def read(ctx):
    return ctx.span_mean(STAGES)
