"""Host-to-device bytes copied in the traced window over what the card's
link could carry in it at its published rate."""

from fsbench import roofline


def read(ctx):
    t = ctx.trace
    if t is None or t.h2d_bytes is None or t.window_s <= 0:
        return None
    return 100.0 * t.h2d_bytes / (t.window_s * roofline.H2D_BYTES_PER_S)
