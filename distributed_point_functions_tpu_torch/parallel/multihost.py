"""Multi-process scaling: key batches across processes, a mesh within each.

The port's counterpart of the JAX package's ``parallel/multihost.py``. The
DPF math has no cross-key terms, so the key batch is embarrassingly
parallel across processes: each process runs the single-process sharded
paths (parallel/sharded.py) over its OWN cards, a local (keys, domain)
mesh, on its own contiguous slice of the key batch. Only the application
moves keys out and answers back; no compute path uses a collective.

On every process:

    from distributed_point_functions_tpu_torch.parallel import multihost, sharded
    multihost.initialize()                        # gloo handshake (torchrun env)
    mesh = multihost.local_mesh()                 # this process's cards
    lo, hi = multihost.local_key_slice(num_keys)  # this process's key range
    out = sharded.pir_query_batch(dpf, keys[lo:hi], db, mesh)
    # gather the answers at the application layer

The same program runs unchanged in one process (``initialize`` is then a
no-op and the slice is the whole batch). ``torch.distributed`` over gloo
carries the handshake alone, and nothing tells a program of a cluster: the
coordinator's address, the process count and the rank are passed, or come
from torchrun's ``MASTER_ADDR``/``MASTER_PORT``/``WORLD_SIZE``/``RANK``.
"""

from __future__ import annotations

import datetime
import logging
import os
from typing import Optional, Tuple

import torch

from ..utils.errors import FailedPreconditionError, InvalidArgumentError
from . import sharded

_log = logging.getLogger("distributed_point_functions_tpu_torch")

# The handshake's bound: a process that waits longer for its peers fails.
INIT_TIMEOUT_SECONDS = 300


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Joins the process group: ``torch.distributed.init_process_group("gloo")``
    at ``tcp://<coordinator_address>`` ("host:port") with `num_processes`
    and this process's `process_id`.

    Unset arguments come from torchrun's environment (MASTER_ADDR and
    MASTER_PORT, WORLD_SIZE, RANK). With all three known the group is
    joined exactly as told and a failure propagates; with some but not all,
    InvalidArgumentError. With none, the process logs and runs alone,
    unless the environment says there are several processes
    (``_multi_host_markers_present``): then it raises, because running
    alone would evaluate the whole key batch on every process. A second
    call in an initialized process does nothing."""
    import torch.distributed as dist

    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    given = (coordinator_address, num_processes, process_id)
    if all(x is None for x in given):
        if _multi_host_markers_present():
            raise FailedPreconditionError(
                "the environment names several processes (SLURM, OpenMPI or WORLD_SIZE > 1) "
                "but no coordinator; pass coordinator_address, num_processes and process_id "
                "(or torchrun's MASTER_ADDR/MASTER_PORT/WORLD_SIZE/RANK)"
            )
        _log.info("no process group configured; running as a single process")
        return
    if any(x is None for x in given):
        raise InvalidArgumentError(
            "initialize needs coordinator_address, num_processes and process_id together, "
            f"got {given}"
        )
    if not 0 <= process_id < num_processes:
        raise InvalidArgumentError(
            f"process_id {process_id} is outside 0 .. {num_processes - 1}"
        )
    if dist.is_initialized():
        return
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator_address}", world_size=int(num_processes),
        rank=int(process_id), timeout=datetime.timedelta(seconds=INIT_TIMEOUT_SECONDS),
    )


def shutdown() -> None:
    """Leaves the process group, if this process joined one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def _multi_host_markers_present() -> bool:
    """True only when the environment says there is MORE THAN ONE
    process: SLURM over several nodes, OpenMPI or torchrun with a world
    size above 1. A single-node run may safely go on as one process."""

    def _gt1(name):
        try:
            return int(os.environ[name]) > 1
        except (KeyError, ValueError):
            return False

    return _gt1("SLURM_JOB_NUM_NODES") or _gt1("OMPI_COMM_WORLD_SIZE") or _gt1("WORLD_SIZE")


def local_mesh(
    n_key_shards: Optional[int] = None,
    n_domain_shards: Optional[int] = None,
    shape: Optional[Tuple[int, int]] = None,
    devices=None,
) -> sharded.Mesh:
    """A (keys, domain) mesh over THIS process's devices: `devices`, or
    every visible CUDA card. Default: all of them on 'domain'.

    `shape` is the ``(keys, domain)`` pair form (what the "KxD" knobs
    parse to), exclusive with the per-axis arguments. A shape whose product
    is not the local device count raises InvalidArgumentError naming
    both."""
    if shape is not None:
        if n_key_shards is not None or n_domain_shards is not None:
            raise InvalidArgumentError(
                "pass shape=(keys, domain) OR n_key_shards/n_domain_shards, not both"
            )
        try:
            n_key_shards, n_domain_shards = (int(s) for s in shape)
        except (TypeError, ValueError):
            raise InvalidArgumentError(f"shape must be a (keys, domain) pair, got {shape!r}")
    if devices is None:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        devices = [torch.device("cuda", i) for i in range(count)]
    devices = list(devices)
    n_local = len(devices)
    for name, v in (("n_key_shards", n_key_shards), ("n_domain_shards", n_domain_shards)):
        if v is not None and v < 1:
            raise InvalidArgumentError(f"`{name}` must be positive, got {v}")
    if n_key_shards is None and n_domain_shards is None:
        n_key_shards, n_domain_shards = 1, n_local
    elif n_key_shards is None:
        n_key_shards = n_local // n_domain_shards
    elif n_domain_shards is None:
        n_domain_shards = n_local // n_key_shards
    if n_key_shards < 1 or n_domain_shards < 1 or n_key_shards * n_domain_shards != n_local:
        raise InvalidArgumentError(
            f"mesh {n_key_shards} x {n_domain_shards} does not match the local device count "
            f"({n_local})"
        )
    return sharded.make_mesh(n_key_shards, n_domain_shards, devices=devices)


def local_key_slice(num_keys: int) -> Tuple[int, int]:
    """This process's contiguous [start, stop) range of a global key batch;
    the remainder spreads over the first ranks. (0, num_keys) when no
    process group is initialized."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return 0, num_keys
    n_proc, pid = dist.get_world_size(), dist.get_rank()
    base, extra = divmod(num_keys, n_proc)
    start = pid * base + min(pid, extra)
    return start, start + base + (1 if pid < extra else 0)
