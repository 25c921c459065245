"""Process-group initialization for runs over several processes or hosts
(counterpart of cerebro_tpu/parallel/multihost.py).

One process per device, every process running the same program: join
them with ``init_multihost``, build the mesh with ``global_mesh``, and
read the process's coordinates with ``host_info``. Nothing discovers a
cluster: the caller gives the coordinator's address, the number of
processes and this one's id (a ``torchrun`` launch may give them through
its environment instead).
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from cerebro_tpu_torch.parallel.mesh import Mesh, make_mesh


def init_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device: Optional[str] = None,
) -> None:
    """Join the process group: NCCL on the CUDA device (this process takes
    device ``process_id % device_count``), or gloo with ``device="cpu"``.
    Without CUDA and without ``device="cpu"`` it raises. The address is
    ``host:port`` (or ``tcp://host:port``) of process 0's store; with no
    address, ``init_process_group``'s environment variables
    (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``) are read."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "init_multihost joins the CUDA device and none is available; "
                "pass device='cpu' to join over gloo on the CPU"
            )
        device = "cuda"
    kind = torch.device(device).type
    if kind not in ("cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    kw = {"backend": "nccl" if kind == "cuda" else "gloo"}
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("an address needs num_processes and process_id")
        addr = coordinator_address
        kw.update(
            init_method=addr if addr.startswith("tcp://") else f"tcp://{addr}",
            world_size=num_processes,
            rank=process_id,
        )
    if kind == "cuda":
        rank = process_id if process_id is not None else int(os.environ.get("LOCAL_RANK", 0))
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(**kw)


def global_mesh(axis: str = "db") -> Mesh:
    """Mesh over every process of the group (all hosts)."""
    return make_mesh(axis=axis)


def host_info() -> dict:
    """The JAX package's keys: this process's index, the process count, its
    devices (one per process) and the devices of the group."""
    n = dist.get_world_size()
    return {
        "process_index": dist.get_rank(),
        "process_count": n,
        "local_devices": 1,
        "global_devices": n,
    }
