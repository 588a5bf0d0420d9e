"""bags_per_s (host clock): the bags completed in the window, one a scan,
divided by the window's seconds, from the start of the first scan to the
end of the last. The bag cells' own rate: their host-bound runs spread
ten times as far as the feature cells', so they carry a bound of their
own (PERF.md section 2)."""


def read(ctx):
    if ctx.scans == 0 or ctx.window_s <= 0:
        return None
    return ctx.scans / ctx.window_s
