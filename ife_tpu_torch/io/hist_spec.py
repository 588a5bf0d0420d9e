"""Histogram-spec file (a copy of ife_tpu/io/hist_spec.py: the same bytes
for the same edges): '#' comment lines, then one comma-separated edge
list per (scale, feature) histogram, all rows the same length.

Written by the bin-edges tool (reference
tools/DetermineHistogramBinEdges_MultiScaleEigenvalueFeatures.cxx:266-296,
header lines '# Features: ...' and '# Scales: ...'), consumed by MakeBag
(tools/MakeBag.cxx:334-371).
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np

from ife_tpu_torch.io.text import write_sequence_as_text


def read_hist_spec(path: str) -> List[np.ndarray]:
    """Returns the list of edge arrays; enforces equal bin counts
    (MakeBag.cxx:350-361). Stops at the first empty line, like the
    reference's read loop (MakeBag.cxx:334-345)."""
    out: List[np.ndarray] = []
    size = None
    with open(path) as f:
        for line in f:
            if not line.strip():
                break
            if line.lstrip().startswith("#"):
                continue
            edges = np.asarray(
                [float(t) for t in line.strip().split(",") if t.strip() != ""]
            )
            if size is None:
                size = edges.size
            elif edges.size != size:
                raise ValueError("Histograms must have the same bin count")
            out.append(edges)
    return out


def write_hist_spec(
    path: str,
    edge_rows: Sequence[np.ndarray],
    scales: Sequence[float] | None = None,
    feature_names: Sequence[str] | None = None,
) -> None:
    with open(path, "w") as f:
        if feature_names:
            f.write("# Features: " + " ".join(feature_names) + "\n")
        if scales is not None:
            f.write("# Scales: " + " ".join(_num(s) for s in scales) + "\n")
        for edges in edge_rows:
            f.write(write_sequence_as_text(np.asarray(edges).tolist()) + "\n")


def _num(v: float) -> str:
    return f"{v:g}"
