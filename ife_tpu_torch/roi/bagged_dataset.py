"""Bagged-dataset assembly — the fixed MakeBaggedDataset capability (a copy
of ife_tpu/roi/bagged_dataset.py: the same arrays for the same files).

The reference's MakeBaggedDataset (tools/MakeBaggedDataset.cxx:73-149,
dead code: needs the external `bagged-data` headers, tools/CMakeLists
.txt:10-11) merges per-image `.bag` CSVs plus bag-level and instance-level
labels into a serialized `bd::BaggedDataset`. Here the serialization is an
.npz with the same information:

  instances      (n_instances, n_features)  all bag rows stacked
  bag_index      (n_instances,)             which bag each row belongs to
  bag_labels     (n_bags, ...)              one label row per bag
  instance_labels(n_instances, ...)         optional per-instance labels
  bag_names      (n_bags,)                  source identifiers
"""
from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np

from ife_tpu_torch.io.text import read_text_matrix


def merge_bags(
    bag_paths: Sequence[str],
    bag_labels: Optional[np.ndarray] = None,
    instance_label_paths: Optional[Sequence[str]] = None,
) -> dict:
    """Merge per-image bag CSVs into one bagged dataset dict."""
    instances: List[np.ndarray] = []
    bag_index: List[np.ndarray] = []
    inst_labels: List[np.ndarray] = []
    n_cols = None
    for b, path in enumerate(bag_paths):
        m = np.atleast_2d(read_text_matrix(path))
        if n_cols is None:
            n_cols = m.shape[1]
        elif m.shape[1] != n_cols:
            raise ValueError(
                f"{path}: {m.shape[1]} columns, expected {n_cols}"
            )
        instances.append(m)
        bag_index.append(np.full(m.shape[0], b, dtype=np.int64))
        if instance_label_paths is not None:
            il = np.atleast_2d(read_text_matrix(instance_label_paths[b]))
            if il.shape[0] != m.shape[0]:
                raise ValueError(
                    f"{instance_label_paths[b]}: {il.shape[0]} instance "
                    f"labels for {m.shape[0]} instances"
                )
            inst_labels.append(il)
    data = {
        "instances": np.concatenate(instances, axis=0),
        "bag_index": np.concatenate(bag_index),
        "bag_names": np.asarray(
            [os.path.basename(p) for p in bag_paths], dtype=object
        ),
    }
    if bag_labels is not None:
        bl = np.atleast_2d(np.asarray(bag_labels))
        if bl.shape[0] != len(bag_paths):
            raise ValueError(
                f"{bl.shape[0]} bag labels for {len(bag_paths)} bags"
            )
        data["bag_labels"] = bl
    if inst_labels:
        data["instance_labels"] = np.concatenate(inst_labels, axis=0)
    return data


def save_bagged_dataset(path: str, data: dict) -> None:
    np.savez_compressed(path, **{
        k: (v.astype("U") if v.dtype == object else v) if isinstance(v, np.ndarray) else v
        for k, v in data.items()
    })


def load_bagged_dataset(path: str) -> dict:
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}
