"""device.idle_share.bulk: the share of the traced window in which no
operation ran on the card (the union of the device operations'
intervals in a ``torch.profiler`` trace, against the window)."""


def read(ctx):
    return ctx.trace.idle_share() if ctx.trace is not None else None
