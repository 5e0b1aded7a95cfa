"""device_idle.prove: percent of the traced window of proves in which no
operation ran on the card (1 - the union of the device's operation
intervals over the window)."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.ops:
        return None
    return ctx.trace.idle_percent()
