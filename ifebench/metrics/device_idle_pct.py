"""device_idle_pct (device trace): 100 x (1 - the union of the device's
kernel, memcpy and memset intervals / the traced window), the window from
the first traced scan's start to the last one's end."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.device or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
