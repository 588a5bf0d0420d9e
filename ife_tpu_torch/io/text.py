"""Plain-text helpers (a copy of ife_tpu/io/text.py: the same text for the
same values) mirroring the reference's IO.h / String.h utilities.

Reference: include/ife/IO/IO.h:24-113, src/IO/IO.cxx:20-41,
include/ife/Util/String.h (trim/split).
"""
from __future__ import annotations

from typing import Iterable, List, Sequence, Tuple

import numpy as np


def trim(s: str, chars: str = " \t\r\n") -> str:
    return s.strip(chars)


def split(s: str, sep: str) -> List[str]:
    return s.split(sep)


def write_sequence_as_text(values: Iterable, sep: str = ",") -> str:
    """Comma-separated rendering (reference IO.h:24-41). Floats use
    shortest-roundtrip repr."""
    def fmt(v):
        if isinstance(v, (float, np.floating)):
            return repr(float(v))
        return str(v)
    return sep.join(fmt(v) for v in values)


def read_text_sequence(line: str, dtype=float, sep: str = ",") -> np.ndarray:
    """Parse a separated sequence of numbers."""
    parts = [p for p in line.strip().split(sep)]
    vals = [dtype(p.strip()) for p in parts if p.strip() != ""]
    return np.asarray(vals, dtype=np.float64 if dtype is float else None)


def read_text_matrix(path_or_lines, dtype=float, sep: str = ",") -> np.ndarray:
    """Rectangular CSV-ish matrix (reference IO.h:77-107; asserts all rows
    share the first row's column count)."""
    if isinstance(path_or_lines, str):
        with open(path_or_lines) as f:
            lines = f.readlines()
    else:
        lines = list(path_or_lines)
    rows = []
    for line in lines:
        if not line.strip():
            continue
        vals = [dtype(p.strip()) for p in line.strip().split(sep)]
        if rows and len(vals) != len(rows[0]):
            raise ValueError("Matrix rows must have equal length")
        rows.append(vals)
    return np.asarray(rows)


def read_pair_list(path: str, sep: str = ",") -> List[Tuple[str, str]]:
    """Lines of 'image<sep>mask', whitespace-trimmed; raises on a line
    without the separator (reference src/IO/IO.cxx:20-41)."""
    out = []
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            if sep not in line:
                raise ValueError(f"Missing separator '{sep}' in line: {line!r}")
            a, b = line.split(sep, 1)
            out.append((a.strip(), b.strip()))
    return out


def write_matrix_csv(path: str, matrix) -> None:
    """Bag CSV format: comma columns, newline rows, no trailing comma
    (reference tools/MakeBag.cxx:475-486), each value as C++ ostream's
    default formatting writes it: 6 significant digits. `matrix` is an
    array, or an iterator of arrays whose rows follow one another. A row is
    formatted in one `%` of its values (twice the rate of a format a
    value)."""
    blocks = [matrix] if isinstance(matrix, (np.ndarray, list, tuple)) \
        else matrix
    with open(path, "w") as f:
        for block in blocks:
            rows = np.asarray(block, np.float64)
            if not len(rows):
                continue
            line = ",".join(["%.6g"] * rows.shape[1]) + "\n"
            f.writelines(line % tuple(row) for row in rows.tolist())
