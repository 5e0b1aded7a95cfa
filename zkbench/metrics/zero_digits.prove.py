"""zero_digits.prove: percent of the stream entries the five MSMs of a
prove walk (W x Np each, the padding's included; counter `entries` of the
tracer's `msm` spans) whose digit is 0 (counter `zero_entries`): each is
gathered and summed into bucket 0, whose weight is 0.  Over the proves
that start in the traced window; a plan shared by two MSMs counts in
both."""

from zkbench import spans


def read(ctx):
    msms = spans.named(spans.roots(ctx, "prove"), "msm")
    entries = sum(r["counts"].get("entries", 0) for r in msms)
    if not entries:
        return None
    zero = sum(r["counts"].get("zero_entries", 0) for r in msms)
    return 100.0 * zero / entries
