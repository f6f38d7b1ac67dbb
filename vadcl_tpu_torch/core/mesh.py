"""Process-group bootstrap and rank queries (``vadcl_tpu/core/mesh.py``).

The JAX package lays a 1-D ``data`` mesh over every device it can address
and lets XLA emit the collectives.  The port runs one process per card
instead, as ``torchrun --nproc_per_node N`` launches it: the process group
is the data axis, each process drives the card ``cuda:LOCAL_RANK``, and the
collectives are ``torch.distributed``'s (NCCL on the card, gloo on the
CPU).  There is no single-process, many-card mode (no ``DataParallel``).
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

# The launcher's variables (torchrun sets all of them).
_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def is_distributed() -> bool:
    """True inside an initialised process group."""
    return dist.is_available() and dist.is_initialized()


def maybe_initialize_distributed(device: str = "cuda",
                                 timeout: datetime.timedelta = datetime.timedelta(minutes=10)
                                 ) -> bool:
    """Start the process group from the torchrun environment: NCCL when
    ``device`` is ``"cuda"`` (each process first takes ``cuda:LOCAL_RANK``),
    gloo on the CPU, every collective bounded by ``timeout``.  A process
    started without the launcher's variables runs alone and this is a
    no-op.  Returns whether a group is up."""
    if is_distributed():
        return True
    if not all(k in os.environ for k in _ENV):
        return False
    card = None
    if device == "cuda":
        card = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(card)
    dist.init_process_group("nccl" if card is not None else "gloo", init_method="env://",
                            timeout=timeout, device_id=card)
    return True


def shutdown_distributed() -> None:
    """Leave the process group, if there is one (a CLI's last act)."""
    if is_distributed():
        dist.destroy_process_group()


def process_index() -> int:
    """This process's rank (0 outside a group)."""
    return dist.get_rank() if is_distributed() else 0


def process_count() -> int:
    """The number of processes in the group (1 outside a group)."""
    return dist.get_world_size() if is_distributed() else 1


def local_device(device: str = "cuda") -> torch.device:
    """The device this process drives: ``cuda:LOCAL_RANK`` (``cuda:0``
    without the launcher) for ``"cuda"``, else the CPU."""
    if torch.device(device).type != "cuda":
        return torch.device("cpu")
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))


def barrier() -> None:
    """Wait for every process of the group (no-op outside a group)."""
    if is_distributed():
        dist.barrier()
