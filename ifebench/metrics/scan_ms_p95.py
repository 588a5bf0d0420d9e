"""scan_ms_p95: the 95th percentile of the latency of every scan of the
window, in ms, from the call's start to the end of its synchronize, read
from two CUDA events that the harness records at the call's start and
after it returns, on an idle card either time: the host clock is too
coarse for a 16 ms scan."""
import numpy as np


def read(ctx):
    if not ctx.latencies_ms:
        return None
    return float(np.percentile(np.asarray(ctx.latencies_ms, np.float64), 95))
