"""The port's ``parallel/multihost.py`` on the CPU: the single-process
degenerate case, the handshake's refusals, and two processes joined over
gloo on 127.0.0.1 (worker ``tests/torch_multihost_worker.py``) whose key
slices, answered over local meshes and concatenated, equal one process's
answers and the JAX package's slice arithmetic."""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from distributed_point_functions_tpu.parallel import multihost as jax_multihost
from distributed_point_functions_tpu_torch.parallel import multihost, sharded
from distributed_point_functions_tpu_torch.utils.errors import (
    FailedPreconditionError,
    InvalidArgumentError,
)
from torch_fold_case import one_torch_thread  # noqa: F401 (autouse fixture)

HERE = Path(__file__).resolve().parent
ENV_NAMES = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "SLURM_JOB_NUM_NODES",
             "OMPI_COMM_WORLD_SIZE")


@pytest.fixture
def clean_env(monkeypatch):
    for name in ENV_NAMES:
        monkeypatch.delenv(name, raising=False)
    return monkeypatch


def test_single_process_degenerates(clean_env):
    """With no cluster configured, initialize is a no-op, the slice is the
    whole batch, and a local mesh drives the sharded paths."""
    from torch_multihost_worker import case

    multihost.initialize()
    assert multihost.local_key_slice(10) == (0, 10) == jax_multihost.local_key_slice(10)
    mesh = multihost.local_mesh(n_domain_shards=2, devices=["cpu"] * 4)
    assert mesh.shape == {"keys": 2, "domain": 2}
    with pytest.raises(InvalidArgumentError, match="does not match"):
        multihost.local_mesh(n_key_shards=3, n_domain_shards=3, devices=["cpu"] * 4)
    dpf, keys, db = case()
    got = sharded.pir_query_batch(dpf, keys, db, mesh, integrity=False)
    assert np.array_equal(got, sharded.pir_query_batch(
        dpf, keys, db, sharded.make_mesh(1, 1, devices=["cpu"]), integrity=False))


def test_initialize_refusals(clean_env):
    """Markers of several processes with no coordinator raise (running
    alone would answer the whole batch on every process); a partial
    configuration raises; one process's markers do not."""
    for name in ("SLURM_JOB_NUM_NODES", "OMPI_COMM_WORLD_SIZE"):
        clean_env.setenv(name, "2")
        with pytest.raises(FailedPreconditionError, match="several processes"):
            multihost.initialize()
        clean_env.setenv(name, "1")
        multihost.initialize()
        clean_env.delenv(name)
    with pytest.raises(InvalidArgumentError, match="together"):
        multihost.initialize(coordinator_address="127.0.0.1:1")
    clean_env.setenv("WORLD_SIZE", "2")
    with pytest.raises(InvalidArgumentError, match="together"):
        multihost.initialize()
    with pytest.raises(InvalidArgumentError, match="outside"):
        multihost.initialize("127.0.0.1:1", 2, 2)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_processes_over_gloo(tmp_path):
    """Two gloo processes on 127.0.0.1: each answers its key slice over a
    local (1, 2) mesh; the concatenated slices equal one process's answers,
    and the slices are the JAX package's."""
    from torch_multihost_worker import NUM_KEYS, case

    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k not in ENV_NAMES}
    procs = [
        subprocess.Popen(
            [sys.executable, str(HERE / "torch_multihost_worker.py"), str(pid), "2", str(port),
             str(tmp_path / f"out{pid}.npy")],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for pid in (0, 1)
    ]
    infos = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=240)
            assert p.returncode == 0, err
            infos.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert [i["world"] for i in infos] == [2, 2]
    assert [(i["lo"], i["hi"]) for i in infos] == [(0, 3), (3, 5)]
    got = np.concatenate([np.load(tmp_path / f"out{pid}.npy") for pid in (0, 1)])
    dpf, keys, db = case()
    assert got.shape == (NUM_KEYS, 4)
    assert np.array_equal(got, sharded.pir_query_batch(
        dpf, keys, db, sharded.make_mesh(1, 2, devices=["cpu"] * 2), integrity=False))
