"""scans_per_s (host clock): the scans completed in the window divided by
the window's seconds, from the start of the first scan to the end of the
last."""


def read(ctx):
    if ctx.scans == 0 or ctx.window_s <= 0:
        return None
    return ctx.scans / ctx.window_s
