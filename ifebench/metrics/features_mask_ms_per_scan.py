"""features_mask_ms_per_scan (device trace): the device ms of the program's
"features.mask" spans in the traced window, per traced scan: the mask's
clamp and cast to the image's dtype, once a call of every branch of
ops/features.py:fused_features8."""
from ifebench.spans import per_scan_ms


def read(ctx):
    return per_scan_ms(ctx, "features.mask", "device")
