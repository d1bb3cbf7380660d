"""B2 (csrc/rs_raid6_words.cu) or B3 (csrc/rs_reconstruct_words.cu),
whichever the cell's operation runs: the least time its shards need at the
HBM rate over its kernel's device time in the trace."""

from fsbench import roofline


def read(ctx):
    return roofline.layer_share(ctx, "rs")
