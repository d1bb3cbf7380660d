"""Items a seam call carries: the seam's own batched_items over its batches
(CRC buckets, or EC key groups), as deltas over the traced window."""


def read(ctx):
    batches = ctx.counters.get("batches", 0)
    return ctx.counters["batched_items"] / batches if batches else None
