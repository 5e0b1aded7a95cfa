"""device_idle.tree: percent of the traced window of tree builds in which no
operation ran on the card (1 - the union of the device's operation
intervals over the window)."""


def read(ctx):
    if ctx.trace is None or not ctx.trace.ops:
        return None
    return ctx.trace.idle_percent()
