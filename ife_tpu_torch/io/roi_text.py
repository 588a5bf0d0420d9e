"""ROIInfo text format (a copy of ife_tpu/io/roi_text.py on the port's ROI): one '[ix, iy, iz][sx, sy, sz]' line per ROI.

Written at reference tools/MakeBag.cxx:290-292 / GenerateROIs.cxx:155-163
(ITK Index/Size operator<< format), parsed by include/ife/IO/ROIReader.hxx
:26-50 (optional single header line to skip).
"""
from __future__ import annotations

import re
from typing import List, Sequence

from ife_tpu_torch.roi.generate import ROI

_LINE = re.compile(
    r"\[\s*(-?\d+)\s*,\s*(-?\d+)\s*,\s*(-?\d+)\s*\]"
    r"\s*\[\s*(\d+)\s*,\s*(\d+)\s*,\s*(\d+)\s*\]"
)


def read_rois(path: str, header: bool = False) -> List[ROI]:
    rois = []
    with open(path) as f:
        if header:
            f.readline()
        for lineno, line in enumerate(f, 2 if header else 1):
            if not line.strip():
                continue
            m = _LINE.search(line)
            if not m:
                raise ValueError(
                    f"{path}:{lineno}: malformed ROI line: {line.strip()!r}"
                )
            nums = [int(g) for g in m.groups()]
            rois.append(ROI(tuple(nums[:3]), tuple(nums[3:])))
    return rois


def write_rois(path: str, rois: Sequence[ROI], header: str | None = None) -> None:
    with open(path, "w") as f:
        if header is not None:
            f.write(header.rstrip("\n") + "\n")
        for r in rois:
            f.write(str(r) + "\n")
