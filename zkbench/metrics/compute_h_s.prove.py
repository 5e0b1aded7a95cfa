"""compute_h_s.prove: H(X) on the card (groth16.prove's `compute_h` span:
qap_device's row evaluation and ntt_device's seven NTTs), mean seconds a
prove over the traced window."""


def read(ctx):
    return ctx.span_mean("compute_h")
