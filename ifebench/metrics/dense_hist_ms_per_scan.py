"""dense_hist_ms_per_scan (device trace): the device ms of the program's
"bag.dense.bin" spans in the traced window, per traced scan, read from the
CUDA events each span records on its stream: the dense binning of every
ROI of a scan (the bins of the region of the boxes, then the rows by
running box sums), a scale at a time. None on a program without the span."""
from ifebench.spans import per_scan_ms


def read(ctx):
    return per_scan_ms(ctx, "bag.dense.bin", "device")
