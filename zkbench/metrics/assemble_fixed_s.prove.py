"""assemble_fixed_s.prove: the host scalar products of the assembly that
need only r, s and the key (delta r, delta s and delta rs in G1, delta s
in G2: groth16.prove's spans `fixed`), mean host seconds a prove over the
proves that start in the traced window: what could run beside the card's
MSMs."""

from zkbench import spans


def read(ctx):
    proves = spans.roots(ctx, "prove")
    fixed = spans.named(proves, "fixed")
    return spans.host_seconds(fixed) / len(proves) if fixed else None
