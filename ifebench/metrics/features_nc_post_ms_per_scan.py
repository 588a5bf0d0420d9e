"""features_nc_post_ms_per_scan (device trace): the self device ms of the
program's "features.nc_post" spans in the traced window, per traced scan:
the time between the CUDA events each span of this branch of
ops/features.py:fused_features8 records on its stream, less its
"features.mask" child. It reads no kernel name, so it stays valid when
the branch's kernels are fused or renamed."""
from ifebench.spans import per_scan_ms


def read(ctx):
    return per_scan_ms(ctx, "features.nc_post", "self_device")
