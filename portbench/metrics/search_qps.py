"""search_qps: the queries answered in the window, over the window,
which lasts from its start until the last call returns."""


def read(ctx):
    load = ctx.load
    if load is None or load.window_s <= 0:
        return None
    return load.answered / load.window_s
