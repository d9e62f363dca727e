"""Process-group bootstrap for data-parallel training (counterpart of
``gcn_tpu.parallel.distributed``): one process a device, over
``torch.distributed``.

``initialize`` reads the job from its arguments or from gcn_tpu's
environment (``GCN_TPU_COORDINATOR`` ``host:port``, ``GCN_TPU_NUM_PROCS``,
``GCN_TPU_PROC_ID``), else from ``torchrun``'s (``MASTER_ADDR``,
``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``), and starts the
default process group once: NCCL when the ranks run on the card, gloo on
the CPU (or where asked: gloo takes CUDA tensors too, and is the only
backend that lets two ranks share one card).  With nothing configured it
starts nothing, and the job is one process.
"""

from __future__ import annotations

import os
import socket
from typing import Optional

import torch
import torch.distributed as dist


def free_port() -> int:
    """A TCP port on localhost that is free now."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None,
               device="cpu") -> bool:
    """Start the default process group unless one is running (idempotent).
    ``backend`` None picks NCCL where ``device`` is the card, gloo
    otherwise.  Returns whether a group is running."""
    if dist.is_initialized():
        return True
    env = os.environ
    coordinator_address = (coordinator_address
                           or env.get("GCN_TPU_COORDINATOR"))
    if num_processes is None and "GCN_TPU_NUM_PROCS" in env:
        num_processes = int(env["GCN_TPU_NUM_PROCS"])
    if process_id is None and "GCN_TPU_PROC_ID" in env:
        process_id = int(env["GCN_TPU_PROC_ID"])
    if coordinator_address:
        init_method = f"tcp://{coordinator_address}"
    elif "MASTER_ADDR" in env and "WORLD_SIZE" in env:  # torchrun
        init_method = "env://"
        num_processes = int(env["WORLD_SIZE"])
        process_id = int(env["RANK"])
    else:
        return False
    if num_processes is None or process_id is None:
        raise ValueError("a coordinator needs the number of processes and "
                         "this process's id (GCN_TPU_NUM_PROCS, "
                         "GCN_TPU_PROC_ID)")
    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=init_method,
                            world_size=num_processes, rank=process_id)
    return True


def initialize_single(backend: str) -> None:
    """A process group of this process alone, on a free localhost port,
    unless one is running."""
    if not dist.is_initialized():
        initialize(f"localhost:{free_port()}", 1, 0, backend=backend)


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def backend() -> Optional[str]:
    return dist.get_backend() if dist.is_initialized() else None


def local_device(device="cuda") -> torch.device:
    """This rank's device: on the card ``cuda:LOCAL_RANK`` (torchrun's), or
    the rank modulo the host's cards; the CPU as it is."""
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    local = os.environ.get("LOCAL_RANK")
    index = (int(local) if local is not None
             else rank() % max(torch.cuda.device_count(), 1))
    return torch.device("cuda", index)


def runtime_info() -> dict:
    return {"process_index": rank(), "process_count": world_size(),
            "backend": backend(),
            "local_devices": torch.cuda.device_count(),
            "platform": "gpu" if torch.cuda.is_available() else "cpu"}


def shutdown() -> None:
    """End the default process group, if one is running."""
    if dist.is_initialized():
        dist.destroy_process_group()
