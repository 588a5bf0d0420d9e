"""device_idle_pct.bag (device trace): device_idle_pct in the bag cells,
where it moves bags_per_s: 100 x (1 - the union of the device's kernel,
memcpy and memset intervals / the traced window)."""


def read(ctx):
    t = ctx.trace
    if t is None or not t.device or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
