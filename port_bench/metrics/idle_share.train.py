"""The device's idle share of the traced window: 100 x (1 - the union of
the device operations' intervals / the window)."""


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.ops or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_ns() / 1e9 / tr.window_s)
