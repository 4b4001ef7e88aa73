"""The PyTorch/CUDA port stands alone: it imports neither JAX nor the JAX
package, and its entry points do not run on the CPU unless asked to.

The import guard runs in a subprocess: tests/conftest.py imports jax into
every pytest process.
"""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

import distributed_point_functions_tpu_torch as port
from distributed_point_functions_tpu_torch.parallel import pir
from distributed_point_functions_tpu_torch.utils.devices import resolve_device
from distributed_point_functions_tpu_torch.utils.errors import (
    InvalidArgumentError,
    UnavailableError,
)

REPO = Path(__file__).resolve().parent.parent

_GUARD = r"""
import sys
import numpy as np
import distributed_point_functions_tpu_torch as port
from distributed_point_functions_tpu_torch.ops import evaluator
from distributed_point_functions_tpu_torch.parallel import pir
dpf = port.DistributedPointFunction.create(port.DpfParameters(6, port.Int(64)))
keys, _ = dpf.generate_keys_batch([3], [[5]], seeds=np.ones((1, 2, 4), np.uint32))
folds = list(evaluator.full_domain_fold_chunks(dpf, keys, device="cpu"))
assert len(folds) == 1
jax_package = "distributed_point_functions_tpu"
bad = sorted(
    m for m in sys.modules
    if m == "jax" or m.startswith("jax.") or m == jax_package
    or m.startswith(jax_package + ".")
)
print("LOADED:" + ",".join(bad))
"""


def test_port_imports_neither_jax_nor_the_jax_package():
    out = subprocess.run(
        [sys.executable, "-c", _GUARD], cwd=REPO, capture_output=True, text=True,
        timeout=300, check=True,
    ).stdout
    assert "LOADED:\n" in out, out


def test_device_rule(monkeypatch):
    """None means CUDA; the CPU only when asked; no silent move."""
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(InvalidArgumentError):
        resolve_device("meta")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(UnavailableError):
        resolve_device(None)
    with pytest.raises(UnavailableError):
        resolve_device("cuda:0")


def test_pir_entry_points_without_a_card_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    dpf = port.DistributedPointFunction.create(port.DpfParameters(6, port.XorWrapper(128)))
    db = [[0, 0, 0, 0]] * 64
    with pytest.raises(UnavailableError):
        pir.prepare_pir_database(dpf, db)
    keys, _ = dpf.generate_keys_batch([1], [[1]])
    with pytest.raises(UnavailableError):
        pir.pir_query_batch_chunked(dpf, keys, db)
