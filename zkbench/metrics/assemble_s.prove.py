"""assemble_s.prove: the host assembly of a proof (groth16.prove's
`assemble` span: the proof's points from the MSM sums, on the host), mean
seconds a prove over the traced window."""


def read(ctx):
    return ctx.span_mean("assemble")
