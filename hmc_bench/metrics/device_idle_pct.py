"""Share of the traced window in which the device ran no kernel, memcpy or
memset: 100·(window − union of device intervals)/window."""


def read(ctx):
    t = ctx.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (t.window_s - t.busy_s) / t.window_s
