"""Format-dispatching volume read/write (counterpart of
ife_tpu/io/volume_io.py).

NIfTI (.nii/.nii.gz) is the workhorse; HR2 and Octave cover the conversion
formats; .npy holds a raw array. DICOM series go through the from-scratch
parser of io/dicom.py (the convert-dicom CLI).
"""
from __future__ import annotations

import numpy as np

from ife_tpu_torch.core.volume import Volume
from ife_tpu_torch.io.nifti import read_nifti, write_nifti
from ife_tpu_torch.io.hr2 import read_hr2, write_hr2
from ife_tpu_torch.io.octave import read_octave, write_octave


def read_volume(path: str) -> Volume:
    p = str(path)
    low = p.lower()
    if low.endswith((".nii", ".nii.gz")):
        return read_nifti(p)
    if low.endswith(".hr2"):
        return read_hr2(p)
    if low.endswith((".mat", ".octave", ".txt")):
        return read_octave(p)
    if low.endswith((".npy",)):
        return Volume.from_numpy(np.load(p))
    # sniff: HR2 magic, else NIfTI (plain or gzip)
    with open(p, "rb") as f:
        head = f.read(4)
    if head[:2] == b"HR" and head[2:3] != b"3":
        return read_hr2(p)
    return read_nifti(p)


def write_volume(path: str, vol: Volume) -> None:
    p = str(path)
    low = p.lower()
    if low.endswith((".nii", ".nii.gz")):
        write_nifti(p, vol)
    elif low.endswith(".hr2"):
        write_hr2(p, vol)
    elif low.endswith((".mat", ".octave")):
        write_octave(p, vol)
    elif low.endswith(".npy"):
        np.save(p, vol.numpy())
    else:
        write_nifti(p, vol)
