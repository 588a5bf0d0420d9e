"""What the per-layer metrics that read the program's own spans share.

The program records its spans (``ife_tpu_torch.utils.profiling.span``) into
one store, and only while torch.profiler records in the calling thread. In
a run of the harness the profiler runs over the traced scans alone, once a
process, so the store holds exactly the traced scans' spans.
"""
from ife_tpu_torch.utils import profiling


def per_scan_ms(ctx, name, reading):
    """The sum over the store's spans named `name` of `reading` ("host",
    "device" or "self_device": ``utils.profiling.span_<reading>_ms``), per
    traced scan. None where the run has no trace or its trace no device
    record (a run on the CPU), where the program records no spans or none
    named `name`, and where a span has no device events to read."""
    t = ctx.trace
    if t is None or not t.device or t.n_scans <= 0:
        return None
    read = getattr(profiling, f"span_{reading}_ms", None)
    if read is None:
        return None
    values = [read(r) for r in profiling.spans(name)]
    if not values or None in values:
        return None
    return sum(values) / t.n_scans
