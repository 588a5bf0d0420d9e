"""roi_hist_ms_per_scan (device trace): the device ms of the program's
"bag.bin" spans in the traced window, per traced scan, read from the CUDA
events each span records on its stream: the histogram kernel over every ROI
of a size class and the divide into frequencies, a scale at a time."""
from ifebench.spans import per_scan_ms


def read(ctx):
    return per_scan_ms(ctx, "bag.bin", "device")
