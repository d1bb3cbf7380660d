"""B1 (csrc/crc_words.cu, alone or inside a fused step): the least time its
rows need at the HBM rate over its kernels' device time in the trace."""

from fsbench import roofline


def read(ctx):
    return roofline.layer_share(ctx, "crc")
