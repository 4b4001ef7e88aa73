"""Wrappers of the hand-written Hopper kernels K2, K3 and K4.

Each wrapper takes the same tensors as its plain version in
ops/backend_torch.py and returns the same result:

=====  ===========================  ==========================================
K      wrapper                      replaces (distributed_point_functions_tpu)
=====  ===========================  ==========================================
K2     ``expand_one_level``         ops/aes_pallas.py
                                    expand_one_level_pallas_batched
K3     ``expand_and_hash_last_      ops/aes_pallas.py
       level``                      expand_and_hash_last_level_pallas_batched
K4     ``hash_value_planes``        ops/aes_pallas.py
                                    hash_value_planes_pallas_batched
=====  ===========================  ==========================================

K1, the bitsliced AES row circuit (csrc/aes_rows.cuh, replacing
``_aes_rows`` / ``_sbox_rows``), is inlined into all three.

Device rule: a wrapper given CPU tensors runs the plain version, because the
tensors lie on the CPU; given CUDA tensors it launches its kernel or raises.
There is no fallback from the kernel to the plain version.

What bounds the kernels on an H100 is integer operations (about 25k 32-bit
logic operations per lane word and hash, against 512 bytes of plane traffic
each way), so the kernels keep the AES state in registers and touch each
plane word once in each direction; see csrc/expand.cu.

Build: the first launch builds csrc/binding.cpp (the one source with
PyTorch's headers) and csrc/expand.cu with ``torch.utils.cpp_extension.load``
for ``sm_90a`` into the package's ``_build/`` directory; ninja rebuilds what
changed and reuses the rest. ``-Xptxas -v`` reports each kernel's registers
and spills, kept in ``Kernel.ptxas``. The binding makes the operands' device
current, launches on PyTorch's current stream and checks every launch with
``C10_CUDA_KERNEL_LAUNCH_CHECK``.
"""

from __future__ import annotations

import contextlib
import functools
import os
import re
import sys
from pathlib import Path
from typing import Dict

import numpy as np
import torch

from ..utils.errors import InternalError, InvalidArgumentError
from . import backend_torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
EXTRA_CUDA_CFLAGS = ("-O3", "-gencode=arch=compute_90a,code=sm_90a", "-Xptxas", "-v")


class Kernel:
    """Handle of one CUDA kernel: its name, a count of its launches and what
    ptxas reported for it (registers, spill bytes)."""

    def __init__(self, name: str, symbol: str):
        self.name = name
        self.symbol = symbol  # substring of the mangled __global__ name
        self.launches = 0
        self.ptxas: Dict[str, int] = {}

    def reset(self) -> None:
        self.launches = 0


K2 = Kernel("K2 expand_one_level", "dpf_expand_level_kernel")
K3 = Kernel("K3 expand_and_hash_last_level", "dpf_expand_hash_kernel")
K4 = Kernel("K4 hash_value_planes", "dpf_value_hash_kernel")
KERNELS = (K2, K3, K4)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.reset()


# ---------------------------------------------------------------------------
# Build and bind
# ---------------------------------------------------------------------------


def round_key_header() -> str:
    """C source of ``kRoundKeys[3][11][128]``: the left, right and value PRG
    key schedules as 0 / ~0 plane masks (the tables backend_torch._rk_np
    gives the plain version), in (table, round, plane = 8 * byte + bit)
    order."""
    tables = np.stack(
        [backend_torch._rk_np(t).reshape(11, 128) for t in ("left", "right", "value")]
    )
    body = ",\n".join(
        "  {" + ",\n   ".join(
            "{" + ",".join("0xffffffffu" if v else "0u" for v in rnd) + "}"
            for rnd in table
        ) + "}"
        for table in tables
    )
    return (
        "// Generated by distributed_point_functions_tpu_torch/ops/aes_cuda.py"
        " from the package's AES key schedule.\n#pragma once\n"
        "static __constant__ uint32_t kRoundKeys[3][11][128] = {\n"
        + body
        + "};\n"
    )


def _parse_ptxas(log: str) -> Dict[str, Dict[str, int]]:
    """Registers and spill bytes per kernel from ``-Xptxas -v`` output."""
    out: Dict[str, Dict[str, int]] = {}
    current = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            current = m.group(1)
            out[current] = {}
            continue
        if current is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out[current]["spill_stores"] = int(m.group(1))
            out[current]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[current]["registers"] = int(m.group(1))
    return out


@contextlib.contextmanager
def _stdout_to(path: Path):
    """Sends file descriptor 1 to `path`: a verbose cpp_extension build
    prints the compilers' output (ptxas's report among it) there."""
    sys.stdout.flush()
    saved = os.dup(1)
    try:
        with open(path, "w") as f:
            os.dup2(f.fileno(), 1)
        yield
    finally:
        sys.stdout.flush()
        os.dup2(saved, 1)
        os.close(saved)


@functools.lru_cache(maxsize=1)
def library():
    """Builds (when a source changed) and loads the kernel extension."""
    from torch.utils.cpp_extension import load

    include = BUILD_DIR / "include"
    include.mkdir(parents=True, exist_ok=True)
    header = include / "dpf_round_keys.h"
    text = round_key_header()
    if not header.exists() or header.read_text() != text:
        header.write_text(text)  # unchanged text keeps its mtime: no rebuild
    log = BUILD_DIR / "build.log"
    try:
        with _stdout_to(log):
            module = load(
                name="dpf_tpu_torch_kernels",
                sources=[str(CSRC / "binding.cpp"), str(CSRC / "expand.cu")],
                extra_cuda_cflags=list(EXTRA_CUDA_CFLAGS),
                extra_include_paths=[str(include), str(CSRC)],
                build_directory=str(BUILD_DIR),
                verbose=True,
            )
    except Exception as e:
        raise InternalError(f"building the kernels failed: {e}\n{log.read_text()}") from e
    report = _parse_ptxas(log.read_text())
    ptxas = BUILD_DIR / "ptxas.txt"
    if report:  # this call compiled expand.cu: keep its report for later loads
        ptxas.write_text(log.read_text())
    elif ptxas.exists():
        report = _parse_ptxas(ptxas.read_text())
    for kernel in KERNELS:
        for fn, stats in report.items():
            if kernel.symbol in fn:
                kernel.ptxas = stats
    return module


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------


def _on_cpu(*tensors: torch.Tensor) -> bool:
    """True when every tensor lies on the CPU, False when every one lies on
    one CUDA device; raises on a mix or on any other device."""
    devices = {t.device for t in tensors}
    if all(d.type == "cpu" for d in devices):
        return True
    if len(devices) == 1 and next(iter(devices)).type == "cuda":
        return False
    raise InvalidArgumentError(
        f"kernel operands must all lie on the CPU or on one CUDA device, got "
        f"{sorted(str(d) for d in devices)}"
    )


def _check(t: torch.Tensor, shape, what: str) -> None:
    if t.dtype != torch.int32:
        raise InvalidArgumentError(f"{what} must be int32 words, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise InvalidArgumentError(
            f"{what} must have shape {tuple(shape)}, got {tuple(t.shape)}"
        )


def _check_expand_args(planes, control, cw_plane, ccl_mask, ccr_mask):
    if planes.dim() != 3:
        raise InvalidArgumentError(f"planes must be [K, 128, W], got {tuple(planes.shape)}")
    k, _, w = planes.shape
    _check(planes, (k, 128, w), "planes")
    _check(control, (k, w), "control")
    _check(cw_plane, (k, 128), "cw_plane")
    _check(ccl_mask, (k,), "ccl_mask")
    _check(ccr_mask, (k,), "ccr_mask")


def _expand(kernel: Kernel, planes, control, cw_plane, ccl_mask, ccr_mask):
    k, _, w = planes.shape
    args = (planes, control, cw_plane, ccl_mask, ccr_mask)
    if not all(t.is_contiguous() for t in args):
        raise InvalidArgumentError(f"{kernel.name}: operands must be contiguous")
    out_planes = torch.empty((k, 128, 2 * w), dtype=torch.int32, device=planes.device)
    out_control = torch.empty((k, 2 * w), dtype=torch.int32, device=planes.device)
    if k == 0 or w == 0:
        return out_planes, out_control
    library().expand_level(*args, out_planes, out_control, kernel is K3)
    kernel.launches += 1
    return out_planes, out_control


def expand_one_level(planes, control, cw_plane, ccl_mask, ccr_mask):
    """K2: one doubling level for K keys. planes int32[K, 128, W], control
    int32[K, W], cw_plane int32[K, 128], ccl_mask/ccr_mask int32[K] ->
    (int32[K, 128, 2W], int32[K, 2W]) in [left | right] order. Replaces
    aes_pallas.py:expand_one_level_pallas_batched."""
    args = (planes, control, cw_plane, ccl_mask, ccr_mask)
    _check_expand_args(*args)
    if _on_cpu(*args):
        return backend_torch.expand_one_level(*args)
    return _expand(K2, *args)


def expand_and_hash_last_level(planes, control, cw_plane, ccl_mask, ccr_mask):
    """K3: K2's children hashed under the value PRG in the same kernel.
    Same arguments as ``expand_one_level``; returns (hashed int32[K, 128,
    2W], control int32[K, 2W]). Replaces
    aes_pallas.py:expand_and_hash_last_level_pallas_batched."""
    args = (planes, control, cw_plane, ccl_mask, ccr_mask)
    _check_expand_args(*args)
    if _on_cpu(*args):
        return backend_torch.expand_and_hash_last_level(*args)
    return _expand(K3, *args)


def hash_value_planes(planes):
    """K4: value-PRG hash of int32[K, 128, W] planes -> same shape.
    Replaces aes_pallas.py:hash_value_planes_pallas_batched."""
    if planes.dim() != 3 or planes.shape[1] != 128:
        raise InvalidArgumentError(f"planes must be [K, 128, W], got {tuple(planes.shape)}")
    _check(planes, planes.shape, "planes")
    if _on_cpu(planes):
        return backend_torch.hash_value_planes(planes)
    if not planes.is_contiguous():
        raise InvalidArgumentError(f"{K4.name}: planes must be contiguous")
    k, _, w = planes.shape
    out = torch.empty_like(planes)
    if k == 0 or w == 0:
        return out
    library().value_hash(planes, out)
    K4.launches += 1
    return out
