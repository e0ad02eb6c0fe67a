"""Multi-process orchestration: one process per GPU.

The reference scales across machines with SLURM job arrays writing
independent shard files merged offline (reference:
slurm/submit_gp_find_lls.sh:7-13, CDDF_analysis/sbatch_reunion.py).
The port's equivalent of ``gpy_dla_detection_tpu/parallel/distributed.py``:
one PyTorch process per card joined through ``torch.distributed``, each
processing its contiguous shard of the survey and writing its own shard
file; a failed process's shard is simply re-run, and
``analysis.catalog_tools.merge_catalogs`` assembles the survey catalog.

The group uses the ``gloo`` backend: the shard pattern needs only ranks,
no tensor crosses processes, and NCCL refuses two ranks on one card.  The
environment is the reference's: ``GPY_DLA_NUM_PROCESSES``,
``GPY_DLA_PROCESS_ID`` and ``GPY_DLA_COORDINATOR`` (``tcp://host:port``,
a bare ``host:port`` taken as such).
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

DEFAULT_COORDINATOR = "tcp://localhost:9731"


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Join the process group (a no-op at one process).  A process on a
    machine with cards takes card ``rank % device_count()`` as its
    current device, as JAX gives each process its local devices."""
    if num_processes is None:
        num_processes = int(os.environ.get("GPY_DLA_NUM_PROCESSES", "1"))
    if num_processes <= 1:
        return
    if process_id is None:
        process_id = int(os.environ.get("GPY_DLA_PROCESS_ID", "0"))
    address = coordinator_address or os.environ.get("GPY_DLA_COORDINATOR",
                                                    DEFAULT_COORDINATOR)
    if "://" not in address:
        address = f"tcp://{address}"
    dist.init_process_group("gloo", init_method=address, world_size=num_processes,
                            rank=process_id)
    if torch.cuda.is_available():
        torch.cuda.set_device(process_id % torch.cuda.device_count())


def _rank_and_size() -> tuple[int, int]:
    """(rank, world size) of the group, or (0, 1) outside one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def host_shard(items: list, process_id: int | None = None,
               num_processes: int | None = None) -> list:
    """This process's contiguous slice of a global work list."""
    rank, size = _rank_and_size()
    pid = process_id if process_id is not None else rank
    n = num_processes if num_processes is not None else size
    per = -(-len(items) // n)
    return items[pid * per : (pid + 1) * per]


def shard_filename(base: str, process_id: int | None = None) -> str:
    """Per-process output file name, merged later by merge_catalogs."""
    pid = process_id if process_id is not None else _rank_and_size()[0]
    root, ext = os.path.splitext(base)
    return f"{root}.shard{pid:04d}{ext}"
