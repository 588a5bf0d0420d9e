"""stage_pinned_pct (host clock): of the bytes that roi/bag.py's staging
sends to the card in the traced window (the work of the program's
"bag.stage.h2d" spans), the share that goes through its ring of
page-locked buffers (the work of the "bag.stage.pinned" spans inside
them), in %: 100 where every byte does, less where an array takes the
pageable copy."""
from ifebench import spans


def read(ctx):
    """None where the run has no trace or its trace no device record, and
    where the program records no "bag.stage.pinned" span (a program without
    the ring)."""
    t = ctx.trace
    if t is None or not t.device or t.n_scans <= 0:
        return None
    records = getattr(spans.profiling, "spans", None)
    if records is None:
        return None
    pinned = records("bag.stage.pinned")
    staged = sum(r.work or 0 for r in records("bag.stage.h2d"))
    if not pinned or staged <= 0:
        return None
    return 100.0 * sum(r.work or 0 for r in pinned) / staged
