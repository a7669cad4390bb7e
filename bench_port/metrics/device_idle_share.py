"""device_idle_share (%): the share of the traced window in which no kernel,
copy or memset ran on the card."""


def read(ctx):
    t = ctx.trace
    if t.window_s <= 0 or not t.device:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
