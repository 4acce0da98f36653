"""device.idle_pct: the share of the traced span's wall time in which no
kernel, memcpy or memset of the span ran on the card, in percent."""


def read(ctx):
    span = ctx.trace
    if not span.ops or span.window_s <= 0:
        return None
    return 100.0 * (1.0 - span.busy_s / span.window_s)
