"""Multi-process runtime: distributed init, shard manifests, restartable
runs (counterpart of ife_tpu/parallel/launcher.py).

The reference is single-process with de-facto stage-level resume through
file materialization (features .nii.gz, ROIs .ROIInfo, spec .txt, bags
.bag). This module scales that contract out:

  * `distributed_init` brings up torch.distributed from the same variables
    as ife_tpu (coordinator address, process count / index): NCCL between
    CUDA devices, gloo between CPU processes.
  * `ShardManifest` records per-block outputs of a sharded run; a restarted
    run skips completed blocks.
"""
from __future__ import annotations

import json
import os
import tempfile
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ife_tpu_torch.parallel.mesh import ShardedVolume, default_device, gather_volume
from ife_tpu_torch.utils.logging import get_logger

log = get_logger("ife.dist")


def distributed_init(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> Tuple[int, int]:
    """Initialize torch.distributed. Returns (rank, world size).

    Args default from env: IFE_COORDINATOR (host:port), IFE_NUM_PROCESSES,
    IFE_PROCESS_ID. Single-process, with no process group, if there is no
    coordinator. The backend follows the compute device (default_device:
    NCCL on the card; IFE_PLATFORM=cpu asks for the CPU and gloo; a host
    without a card raises), the rendezvous is a TCP store on the
    coordinator's address.
    """
    coordinator = coordinator or os.environ.get("IFE_COORDINATOR")
    if coordinator is None:
        return 0, 1
    num_processes = int(
        num_processes or os.environ.get("IFE_NUM_PROCESSES", "1"))
    process_id = int(
        process_id if process_id is not None
        else os.environ.get("IFE_PROCESS_ID", "0"))
    # the process group does not exist yet, so default_device() sees rank 0:
    # only its kind matters here (it raises on a host without a card unless
    # IFE_PLATFORM=cpu, so a missing card never becomes gloo by itself)
    cuda = default_device().type == "cuda"
    if cuda:
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(
        backend="nccl" if cuda else "gloo",
        init_method=f"tcp://{coordinator}",
        world_size=num_processes, rank=process_id)
    log.info("distributed init: process %d/%d on %s (%s)", process_id,
             num_processes, default_device(), dist.get_backend())
    return process_id, num_processes


def distributed_init_from_args(args) -> Tuple[int, int]:
    """`distributed_init` from CLI flags (--coordinator/--num-processes/
    --process-id), falling back to the IFE_* env vars. The common entry for
    every `--sharded`-capable subcommand."""
    return distributed_init(
        coordinator=getattr(args, "coordinator", None),
        num_processes=getattr(args, "num_processes", None),
        process_id=getattr(args, "process_id", None),
    )


def distributed_shutdown() -> None:
    """Tear the process group down, if there is one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def is_primary() -> bool:
    """True on the process that owns side effects (file writes, logs)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def fetch_to_host(arr) -> np.ndarray:
    """A tensor, or a ShardedVolume gathered from every process's blocks, as
    the full numpy array on EVERY process."""
    if isinstance(arr, ShardedVolume):
        arr = gather_volume(arr)
    return arr.cpu().numpy()


def broadcast_int(value: int) -> int:
    """The primary's `value` on every process."""
    if not dist.is_initialized():
        return int(value)
    t = torch.tensor([int(value)], dtype=torch.int64, device=default_device())
    dist.broadcast(t, src=0)
    return int(t.item())


@dataclass
class ShardManifest:
    """Per-block completion ledger for restartable sharded runs (a copy of
    ife_tpu's).

    JSON file: {"blocks": {block_key: {"path": ..., "done": true}}}.
    Writes are atomic (tmp + rename) so a killed run never corrupts it.
    """

    path: str

    def _load(self) -> Dict:
        if not os.path.exists(self.path):
            return {"blocks": {}}
        with open(self.path) as f:
            return json.load(f)

    def is_done(self, block_key: str) -> bool:
        entry = self._load()["blocks"].get(block_key)
        if not entry or not entry.get("done"):
            return False
        out = entry.get("path")
        return out is None or os.path.exists(out)

    def mark_done(self, block_key: str, out_path: Optional[str] = None) -> None:
        data = self._load()
        data["blocks"][block_key] = {"path": out_path, "done": True}
        d = os.path.dirname(os.path.abspath(self.path)) or "."
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".manifest.tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(data, f, indent=1)
            os.replace(tmp, self.path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise

    def pending(self, block_keys: List[str]) -> List[str]:
        return [k for k in block_keys if not self.is_done(k)]

    def reset(self) -> None:
        if os.path.exists(self.path):
            os.unlink(self.path)
