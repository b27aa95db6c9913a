"""setup_s: process start to the first timed request: imports, the
kernels' build (a first run), the corpus, the bulk load, the index
build and the warm-up."""


def read(ctx):
    return ctx.setup_s if ctx.setup_s > 0 else None
