"""Multi-process start, the counterpart of ``x2i_tpu/core/multihost.py``.

JAX starts a multi-host run with ``jax.distributed.initialize``; here the
same environment starts a ``torch.distributed`` process group, one process
per device, as ``torchrun`` launches them. The environment is read in
JAX's order: ``COORDINATOR_ADDRESS``, else ``MASTER_ADDR:MASTER_PORT``
(port 1234 when unset), then ``WORLD_SIZE`` and ``RANK``. A single
process (no coordinator, or one process) starts nothing, so that the same
entry points run everywhere.
"""

from __future__ import annotations

import datetime
import logging
import os
from typing import Optional

import torch.distributed as dist

log = logging.getLogger("x2i_torch")

# a rank that waits this long for its peers fails instead of hanging
DEFAULT_TIMEOUT = datetime.timedelta(seconds=600)


def coordinator_from_env(coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None):
    """-> (address, num_processes, process_id), each argument left as it
    is when given, else read from the environment (None where unset)."""
    env = os.environ
    coordinator_address = coordinator_address or env.get(
        "COORDINATOR_ADDRESS")
    if coordinator_address is None and env.get("MASTER_ADDR"):
        coordinator_address = (f"{env['MASTER_ADDR']}:"
                               f"{env.get('MASTER_PORT', '1234')}")
    if num_processes is None and env.get("WORLD_SIZE"):
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and env.get("RANK"):
        process_id = int(env["RANK"])
    return coordinator_address, num_processes, process_id


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None,
               timeout: datetime.timedelta = DEFAULT_TIMEOUT) -> bool:
    """Start this process's group when several processes run; -> whether
    a group was started. ``backend`` is NCCL unless the caller asks for
    the CPU's ("gloo"). A no-op in a single process or when a group
    exists already."""
    addr, n, rank = coordinator_from_env(coordinator_address, num_processes,
                                         process_id)
    if addr is None or (n or 1) <= 1:
        log.info("single-process run (no coordinator configured)")
        return False
    if dist.is_initialized():
        return False
    if rank is None:
        raise ValueError("a multi-process run needs the process id (RANK)")
    dist.init_process_group(backend or "nccl", init_method=f"tcp://{addr}",
                            world_size=n, rank=rank, timeout=timeout)
    log.info("multi-process run: process %d of %d", rank, n)
    return True


def is_main_process() -> bool:
    """Rank 0 of the group, or the one process where no group exists."""
    return not dist.is_initialized() or dist.get_rank() == 0
