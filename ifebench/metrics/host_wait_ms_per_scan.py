"""host_wait_ms_per_scan (host clock): the host ms of the program's
"bag.fetch" spans in the traced window, per traced scan: the host blocked
on the card, once a scale and ROI size class, for the frequencies. It
waits for all the work queued before them, the scale's features as well
as its binning, so a change to the feature kernels moves it too."""
from ifebench.spans import per_scan_ms


def read(ctx):
    return per_scan_ms(ctx, "bag.fetch", "host")
