"""h2d_ms_per_scan (device trace): the device time of the host-to-device
copies of the traced window, in ms per traced scan."""


def read(ctx):
    t = ctx.trace
    if t is None:
        return None
    s = t.device_seconds(lambda name, cat: cat == "gpu_memcpy"
                         and "HtoD" in name)
    if s <= 0:
        return None
    return 1e3 * s / t.n_scans
