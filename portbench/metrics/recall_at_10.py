"""recall_at_10: over the checked answers of the window (those of the
traffic's ``check_share`` of the calls, drawn from the seed), the share of the
exact float32 top-10 ids (the reference's, same query, same corpus)
found among the answer's ids."""

import math


def read(ctx):
    recall = ctx.result.get("recall")
    return None if recall is None or math.isnan(recall) else recall
