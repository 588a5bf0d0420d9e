"""stage_host_ms_per_scan (host clock): the host ms of the program's
"bag.stage" spans in the traced window, per traced scan: roi/bag.py's
staging of a scan, the mask's clamp on the host ("bag.stage.clip") and
the pageable copies of image and mask to the card ("bag.stage.h2d")."""
from ifebench.spans import per_scan_ms


def read(ctx):
    return per_scan_ms(ctx, "bag.stage", "host")
