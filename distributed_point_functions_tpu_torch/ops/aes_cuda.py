"""Wrappers of the hand-written Hopper kernels K2 to K9 (K7 in two forms).

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
K5     ``megakernel_fold``          ops/aes_pallas.py
                                    megakernel_fold_pallas_batched
K6     ``walk_level`` (and          ops/aes_pallas.py
       ``walk_levels``, one         walk_levels_pallas_batched
       launch per level)
K7     ``walk_megakernel``          ops/aes_pallas.py
                                    walk_megakernel_pallas_batched
                                    (EvaluateAt form, ``captures=None``; DCF
                                    form, a ``captures`` tuple: its own
                                    kernel and count, ``K7_DCF``)
K8     ``hier_megakernel``          ops/aes_pallas.py
                                    hier_megakernel_pallas_batched
K9     ``keygen_megakernel``        ops/aes_pallas.py
                                    keygen_megakernel_pallas_batched
=====  ===========================  ==========================================

``expand_one_level_single``, one key in the ``[128, W]`` layout, replaces
aes_pallas.py:expand_one_level_pallas, the legacy one-key kernel; it is a
view of K2 (a batch of one key) with no kernel body and no count of its
own.

K1, the bitsliced AES circuit, is inlined into all of them in one of two
forms that share one S-box (csrc/aes_sbox.cuh, a netlist of three-input
LOP3 functions generated by gen_sbox_lop3.py) and one MixColumns
(csrc/aes_rows.cuh ``mix_column``, with the round key). The row form
(csrc/aes_rows.cuh, replacing ``_aes_rows`` / ``_sbox_rows``: one thread
holds a lane word's 128 planes) runs in K8 alone, with the PRG key
selected per lane. The column form (csrc/aes_quad.cuh: four threads a lane
word, one AES column each) runs in K2-K7 (K6 and both forms of K7 with the
PRG key selected per lane) and K9.

Device rule: a wrapper given CPU tensors runs the plain version, because the
tensors lie on the CPU; given CUDA tensors it launches its kernel or raises.
There is no fallback from the kernel to the plain version.

What bounds the kernels on an H100 is integer operations (one MMO hash is
about 15.4k logic instructions per lane word, against 512 bytes of plane
traffic each way), so the kernels keep the AES state in registers and
touch each plane word once in each direction; see csrc/expand.cu and
csrc/megakernel.cu. Every kernel but K8 splits each word's AES state over
four threads so that it fits 128 registers without a spill.

Build: the first launch builds csrc/binding.cpp (the one source with
PyTorch's headers), csrc/expand.cu, csrc/megakernel.cu, csrc/walk.cu,
csrc/walk_megakernel.cu, csrc/hier_megakernel.cu and
csrc/keygen_megakernel.cu with ``torch.utils.cpp_extension.load`` for
``sm_90a`` into the package's ``_build/`` directory; ninja compiles the
sources in parallel, rebuilds what changed and reuses the rest. ``-Xptxas -v`` reports each kernel's registers
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
import threading
from pathlib import Path
from typing import Dict, Optional

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
    ptxas reported for it (registers, spill bytes, stack frame bytes)."""

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
K5 = Kernel("K5 megakernel_fold", "dpf_megakernel_fold_kernel")
K6 = Kernel("K6 walk_level", "dpf_walk_level_kernel")
K7 = Kernel("K7 walk_megakernel", "dpf_walk_megakernel_kernel")
K7_DCF = Kernel("K7 walk_megakernel, DCF form", "dpf_walk_dcf_kernel")
K8 = Kernel("K8 hier_megakernel", "dpf_hier_megakernel_kernel")
K9 = Kernel("K9 keygen_megakernel", "dpf_keygen_megakernel_kernel")
KERNELS = (K2, K3, K4, K5, K6, K7, K7_DCF, K8, K9)
# Each .cu source and the kernels ptxas reports for it.
CUDA_SOURCES = {
    "expand.cu": (K2, K3, K4),
    "megakernel.cu": (K5,),
    "walk.cu": (K6,),
    "walk_megakernel.cu": (K7, K7_DCF),
    "hier_megakernel.cu": (K8,),
    "keygen_megakernel.cu": (K9,),
}
SOURCES = ("binding.cpp",) + tuple(CUDA_SOURCES)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.reset()


# ---------------------------------------------------------------------------
# Build and bind
# ---------------------------------------------------------------------------


def _key_tables() -> np.ndarray:
    """uint32[3, 11, 128]: the left, right and value PRG key schedules as
    0 / ~0 plane masks (the tables backend_torch._rk_np gives the plain
    version), in (table, round, plane = 8 * byte + bit) order."""
    return np.stack(
        [backend_torch._rk_np(t).reshape(11, 128) for t in ("left", "right", "value")]
    )


def _key_header(declaration: str, table: np.ndarray) -> str:
    """A generated header defining `declaration` as the 0 / ~0 words of
    `table`, nested in braces as its shape."""
    def braces(a):
        if a.ndim == 1:
            return "{" + ",".join("0xffffffffu" if v else "0u" for v in a) + "}"
        return "{" + ",\n".join(braces(x) for x in a) + "}"

    return (
        "// Generated by distributed_point_functions_tpu_torch/ops/aes_cuda.py"
        " from the package's AES key schedule.\n#pragma once\n"
        f"{declaration} = {braces(table)};\n"
    )


def round_key_header() -> str:
    """C source of ``kRoundKeys[3][11][128]`` (``_key_tables``), the
    constant-memory tables of K1."""
    return _key_header("static __constant__ uint32_t kRoundKeys[3][11][128]", _key_tables())


def quad_key_header() -> str:
    """C source of ``kQuadRoundKeys[3][11][32][4]``, K5's copy of the same
    schedules for its column threads (csrc/aes_quad.cuh): entry [table]
    [round][i][c] is plane 32 c + i of ``kRoundKeys[table][round]``, so the
    four columns' words of one plane row lie side by side."""
    tables = _key_tables().reshape(3, 11, 4, 32).transpose(0, 1, 3, 2)
    return _key_header("static __device__ const uint32_t kQuadRoundKeys[3][11][32][4]", tables)


def write_key_headers(include: Path) -> None:
    """Writes dpf_round_keys.h and dpf_quad_keys.h into `include`; a header
    whose text is unchanged keeps its mtime, so nothing rebuilds."""
    for name, text in (("dpf_round_keys.h", round_key_header()),
                       ("dpf_quad_keys.h", quad_key_header())):
        header = include / name
        if not header.exists() or header.read_text() != text:
            header.write_text(text)


def _parse_ptxas(log: str) -> Dict[str, Dict[str, int]]:
    """Registers, spill bytes and stack frame bytes per kernel from
    ``-Xptxas -v`` output."""
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
        m = re.search(r"(\d+) bytes stack frame", line)
        if m:
            out[current]["stack_frame"] = int(m.group(1))
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


_library_lock = threading.Lock()


def library():
    """Builds (when a source changed) and loads the kernel extension, once a
    process. The first call holds a lock: threads that reach a cold process
    together (a server's two parties, a front door's workers) wait for one
    build and one import, and none sees the module half imported or stdout
    left redirected to the build log."""
    with _library_lock:
        return _load_library()


@functools.lru_cache(maxsize=1)
def _load_library():
    from torch.utils.cpp_extension import load

    include = BUILD_DIR / "include"
    include.mkdir(parents=True, exist_ok=True)
    write_key_headers(include)
    log = BUILD_DIR / "build.log"
    try:
        with _stdout_to(log):
            module = load(
                name="dpf_tpu_torch_kernels",
                sources=[str(CSRC / name) for name in SOURCES],
                extra_cuda_cflags=list(EXTRA_CUDA_CFLAGS),
                extra_include_paths=[str(include), str(CSRC)],
                build_directory=str(BUILD_DIR),
                verbose=True,
            )
    except Exception as e:
        raise InternalError(f"building the kernels failed: {e}\n{log.read_text()}") from e
    # Each .cu's report is kept: ninja recompiles only the sources that
    # changed, and a load that compiled none reports nothing.
    text = log.read_text()
    fresh = _parse_ptxas(text)
    for source, kernels in CUDA_SOURCES.items():
        saved = BUILD_DIR / f"ptxas.{source}.txt"
        report = fresh
        if any(k.symbol in fn for fn in report for k in kernels):
            saved.write_text(text)
        elif saved.exists():
            report = _parse_ptxas(saved.read_text())
        for kernel in kernels:
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


def expand_one_level_single(planes, control, cw_plane, ccl_mask, ccr_mask):
    """K2 for one key in the legacy ``[128, W]`` layout: planes int32[128,
    W], control int32[W], cw_plane int32[128], ccl_mask/ccr_mask int32
    scalars (0-dim or one element) -> (int32[128, 2W], int32[2W]) in [left |
    right] order. A view of ``expand_one_level`` on a batch of one key: K2's
    launch and count, no kernel of its own. Replaces
    aes_pallas.py:expand_one_level_pallas, which refuses a width with no
    divisor block; K2 takes any width, so this view refuses none. The plain
    version is ``backend_torch.expand_one_level_single``."""
    if planes.dim() != 2 or control.dim() != 1 or cw_plane.dim() != 1:
        raise InvalidArgumentError(
            f"planes must be [128, W], control [W] and cw_plane [128], got "
            f"{tuple(planes.shape)}, {tuple(control.shape)} and {tuple(cw_plane.shape)}"
        )
    if ccl_mask.numel() != 1 or ccr_mask.numel() != 1:
        raise InvalidArgumentError("ccl_mask and ccr_mask must be one word each")
    out, new_control = expand_one_level(
        planes[None], control[None], cw_plane[None], ccl_mask.reshape(1), ccr_mask.reshape(1)
    )
    return out[0], new_control[0]


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
    Replaces aes_pallas.py:hash_value_planes_pallas_batched.

    Bound on the H100: integer operations, one MMO hash per lane word
    against 1 KiB of plane traffic; four column threads a (key, word) item
    (csrc/expand.cu)."""
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


def _plan_fields(plan) -> list:
    """A MegakernelPlan's fields in the order binding.cpp megakernel_args
    reads them."""
    return [plan.levels_a, plan.levels_b, plan.entry_words, plan.mid_words,
            plan.slab_words, plan.final_words, plan.fold_words, plan.num_slabs]


def megakernel_blocks_per_key(plan, bits: int, num_keys: int, device) -> int:
    """K5's blocks per key for `num_keys` keys under `plan` on CUDA
    `device` when the wrapper chooses: the most, up to num_slabs, that keep
    the whole grid resident on the card at once."""
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    blocks = library().megakernel_blocks_per_key(_plan_fields(plan), bits // 32, num_keys, index)
    if blocks < 1:
        raise InternalError(f"{K5.name}: the occupancy query failed on cuda:{index}")
    return blocks


def megakernel_fold(
    planes, control, cw_planes, ccl, ccr, corrections, db_rows=None, *,
    plan, bits: int, party: int, xor_group: bool, keep: int,
    blocks_per_key: Optional[int] = None,
):
    """K5, the slab megakernel: one launch for a chunk of K keys.

    planes int32[K, 128, entry_words], control int32[K, entry_words],
    cw_planes int32[K, L, 128], ccl/ccr int32[K, L] (L = levels_a +
    levels_b), corrections int32[K, epb, lpe], db_rows int32[keep * lpe *
    32, total_words] or None -> int32[K, lpe, fold_words] partial folds
    (``evaluator.MegakernelPlan`` fields). Every device level, the value
    hash, the transpose to limbs, the correction, the database AND and the
    fold run in the kernel; the leaves never reach device memory. Replaces
    aes_pallas.py:megakernel_fold_pallas_batched (the plain version is
    ``backend_torch.megakernel_fold``).

    Bound on the H100: integer operations, ~25k logic operations per lane
    word and hash against a few hundred bytes of input per key and the
    database read once. The design (csrc/megakernel.cu) keeps each key's
    tree on chip, runs four threads a lane word (one AES column each, 128
    registers, two 256-thread blocks an SM) and splits each key's slabs
    over ``blocks_per_key`` blocks, each expanding the phase-A words its
    slabs need in its own workspace row and XORing its fold into the
    zeroed output. ``None`` takes the most blocks a key (at most num_slabs)
    that keep the grid resident on the card at once; an int in 1 ..
    num_slabs sets it (the result does not depend on it). The plan's
    phase-B buffers must fit one block's shared memory
    (``evaluator.MEGAKERNEL_BUDGET`` plans do); a larger plan is refused on
    the card.
    """
    if bits % 32:
        raise NotImplementedError(
            f"K5's value correction handles 32-bit-multiple widths, got {bits}"
        )
    if party not in (0, 1):
        raise InvalidArgumentError(f"party must be 0 or 1, got {party}")
    lpe, epb = bits // 32, 128 // bits
    if keep < 1 or keep > epb or keep & (keep - 1):
        raise InvalidArgumentError(f"keep must be a power of two <= {epb}, got {keep}")
    if planes.dim() != 3:
        raise InvalidArgumentError(f"planes must be [K, 128, W], got {tuple(planes.shape)}")
    k = planes.shape[0]
    levels = plan.levels_a + plan.levels_b
    total = plan.num_slabs * plan.final_words
    if not (
        plan.mid_words == plan.entry_words << plan.levels_a == plan.num_slabs * plan.slab_words
        and plan.final_words == plan.slab_words << plan.levels_b
        and plan.fold_words == min(128, plan.final_words)
        and levels >= 1
    ):
        raise InvalidArgumentError(f"{plan} is not a consistent megakernel plan")
    _check(planes, (k, 128, plan.entry_words), "planes")
    _check(control, (k, plan.entry_words), "control")
    _check(cw_planes, (k, levels, 128), "cw_planes")
    _check(ccl, (k, levels), "ccl")
    _check(ccr, (k, levels), "ccr")
    _check(corrections, (k, epb, lpe), "corrections")
    args = [planes, control, cw_planes, ccl, ccr, corrections]
    if db_rows is not None:
        _check(db_rows, (keep * lpe * 32, total), "db_rows")
        args.append(db_rows)
    if blocks_per_key is not None and not 1 <= blocks_per_key <= plan.num_slabs:
        raise InvalidArgumentError(
            f"blocks_per_key must be in 1 .. {plan.num_slabs} (the plan's slabs), "
            f"got {blocks_per_key}"
        )
    kw = dict(plan=plan, bits=bits, party=party, xor_group=xor_group, keep=keep)
    if _on_cpu(*args):
        return backend_torch.megakernel_fold(
            planes, control, cw_planes, ccl, ccr, corrections, db_rows, **kw
        )
    if not all(t.is_contiguous() for t in args):
        raise InvalidArgumentError(f"{K5.name}: operands must be contiguous")
    dev = planes.device
    out = torch.zeros((k, lpe, plan.fold_words), dtype=torch.int32, device=dev)
    if k == 0:
        return out
    lib = library()
    fields = _plan_fields(plan)
    need = lib.megakernel_smem_bytes(fields, lpe)
    limit = lib.max_shared_memory_per_block(dev.index)
    if need > limit:
        raise InvalidArgumentError(
            f"{K5.name}: {plan} needs {need} bytes of shared memory per block "
            f"and {dev} allows {limit}; plan it with a smaller budget"
        )
    if blocks_per_key is None:
        blocks_per_key = megakernel_blocks_per_key(plan, bits, k, dev)
    # Each block's phase A ping-pongs between a mid_words and a mid_words / 2
    # buffer of 129 rows (128 planes and the control row).
    ws_words = 129 * (plan.mid_words + plan.mid_words // 2) if plan.levels_a else 1
    workspace = torch.empty((k * blocks_per_key, ws_words), dtype=torch.int32, device=dev)
    lib.megakernel_fold(
        planes, control, cw_planes, ccl, ccr, corrections,
        planes if db_rows is None else db_rows, db_rows is not None,
        out, workspace, fields, lpe, keep, party, xor_group, blocks_per_key,
    )
    K5.launches += 1
    return out


def _check_walk_args(planes, control, path_mask, cw_plane, ccl_mask, ccr_mask):
    if planes.dim() != 3:
        raise InvalidArgumentError(f"planes must be [K, 128, W], got {tuple(planes.shape)}")
    k, _, w = planes.shape
    _check(planes, (k, 128, w), "planes")
    _check(control, (k, w), "control")
    _check(path_mask, (w,), "path_mask")
    _check(cw_plane, (k, 128), "cw_plane")
    _check(ccl_mask, (k,), "ccl_mask")
    _check(ccr_mask, (k,), "ccr_mask")


def walk_level(planes, control, path_mask, cw_plane, ccl_mask, ccr_mask):
    """K6: one level of the point walk for K keys. planes int32[K, 128, W],
    control int32[K, W], path_mask int32[W] (this level's path bits, shared
    by the keys), cw_plane int32[K, 128], ccl_mask/ccr_mask int32[K] ->
    (int32[K, 128, W], int32[K, W]). Replaces
    aes_pallas.py:walk_levels_pallas_batched (one launch per level, as its
    pallas_call); the plain version is ``backend_torch.walk_level``.

    Bound on the H100: integer operations, one MMO hash with the per-lane
    key select per lane word against 1 KiB of plane traffic; four column
    threads a (key, word) item, K7's column walk level with the item's
    planes loaded and stored (csrc/walk.cu)."""
    args = (planes, control, path_mask, cw_plane, ccl_mask, ccr_mask)
    _check_walk_args(*args)
    if _on_cpu(*args):
        return backend_torch.walk_level(*args)
    if not all(t.is_contiguous() for t in args):
        raise InvalidArgumentError(f"{K6.name}: operands must be contiguous")
    out_planes = torch.empty_like(planes)
    out_control = torch.empty_like(control)
    if planes.shape[0] == 0 or planes.shape[2] == 0:
        return out_planes, out_control
    library().walk_level(*args, out_planes, out_control)
    K6.launches += 1
    return out_planes, out_control


def walk_levels(planes, control, path_masks, cw_planes, ccl, ccr):
    """Every level of the point walk, one K6 launch per level: path_masks
    int32[L, W], cw_planes int32[K, L, 128], ccl/ccr int32[K, L] (as
    ``backend_torch.walk_levels``, the plain version)."""
    if path_masks.dim() != 2:
        raise InvalidArgumentError(f"path_masks must be [L, W], got {tuple(path_masks.shape)}")
    # Level-major once, so that each level's per-key tables are contiguous.
    cw, cl, cr = (t.transpose(0, 1).contiguous() for t in (cw_planes, ccl, ccr))
    for lvl in range(path_masks.shape[0]):
        planes, control = walk_level(planes, control, path_masks[lvl], cw[lvl], cl[lvl], cr[lvl])
    return planes, control


def walk_megakernel(
    seed_planes, path_masks, cw_planes, ccl, ccr, corrections, sel_bits, *,
    bits: int, party: int, xor_group: bool, keep: int, captures=None,
):
    """K7, the walk megakernel: one launch for a chunk of K keys.

    seed_planes int32[K, 128] root-seed plane masks, path_masks int32[L, Wp],
    cw_planes int32[K, L, 128], ccl/ccr int32[K, L] -> int32[K, lpe * 32,
    Wp] value rows (row l * 32 + i at word w is limb l of point 32 w + i).
    Every level of the walk and the captures (value hash, transpose,
    correction, element select) run in the kernel. The plain version is
    ``backend_torch.walk_megakernel``.

    ``captures=None``, the EvaluateAt form (K7): corrections int32[K, epb,
    lpe] and sel_bits int32[keep, Wp]; the leaves are captured once.
    Replaces aes_pallas.py:walk_megakernel_pallas_batched with
    ``captures=None``.

    A tuple of L + 1 flags, the DCF form (K7_DCF, dcf.batch_evaluate):
    corrections int32[K, (L + 1) * keep, lpe] and sel_bits int32[(L + 1) *
    keep, Wp], rows d * keep + e; each flagged depth d is captured before
    level d with its correction rows (no party negation) and select rows,
    the captures are summed in the kernel (limb add with carry; XOR for an
    XOR group) and party 1 negates the sum once. Replaces the same Pallas
    kernel with ``captures``.

    Bound on the H100: integer operations, L + 1 MMO hashes per lane word
    (the DCF form: L + one per flagged depth) against the path and select
    words and a few hundred bytes per key (csrc/walk_megakernel.cu).
    """
    if bits % 32:
        raise NotImplementedError(
            f"K7's value correction handles 32-bit-multiple widths, got {bits}"
        )
    if party not in (0, 1):
        raise InvalidArgumentError(f"party must be 0 or 1, got {party}")
    lpe, epb = bits // 32, 128 // bits
    if keep < 1 or keep > epb or keep & (keep - 1):
        raise InvalidArgumentError(f"keep must be a power of two <= {epb}, got {keep}")
    if seed_planes.dim() != 2 or path_masks.dim() != 2:
        raise InvalidArgumentError(
            f"seed_planes must be [K, 128] and path_masks [L, Wp], got "
            f"{tuple(seed_planes.shape)} and {tuple(path_masks.shape)}"
        )
    k = seed_planes.shape[0]
    levels, wp = path_masks.shape
    if levels < 1:
        raise InvalidArgumentError("the walk megakernel needs at least one tree level")
    rows = epb
    sel_rows = keep
    kernel = K7
    if captures is not None:
        captures = tuple(bool(f) for f in captures)
        if len(captures) != levels + 1:
            raise InvalidArgumentError(
                f"captures must hold levels + 1 = {levels + 1} flags, got {len(captures)}"
            )
        if levels >= 128:
            raise InvalidArgumentError(
                f"the DCF form takes at most 127 tree levels, got {levels}"
            )
        rows = sel_rows = (levels + 1) * keep
        kernel = K7_DCF
    _check(seed_planes, (k, 128), "seed_planes")
    _check(path_masks, (levels, wp), "path_masks")
    _check(cw_planes, (k, levels, 128), "cw_planes")
    _check(ccl, (k, levels), "ccl")
    _check(ccr, (k, levels), "ccr")
    _check(corrections, (k, rows, lpe), "corrections")
    _check(sel_bits, (sel_rows, wp), "sel_bits")
    args = (seed_planes, path_masks, cw_planes, ccl, ccr, corrections, sel_bits)
    kw = dict(bits=bits, party=party, xor_group=xor_group, keep=keep)
    if _on_cpu(*args):
        return backend_torch.walk_megakernel(*args, captures=captures, **kw)
    if not all(t.is_contiguous() for t in args):
        raise InvalidArgumentError(f"{kernel.name}: operands must be contiguous")
    out = torch.empty((k, lpe * 32, wp), dtype=torch.int32, device=seed_planes.device)
    if k == 0 or wp == 0:
        return out
    capture_words = []
    if captures is not None:  # bit d of the mask: depth d captures
        mask = sum(1 << d for d, flag in enumerate(captures) if flag)
        capture_words = [(mask >> (32 * i)) & 0xFFFFFFFF for i in range(4)]
    library().walk_megakernel(*args, out, lpe, keep, party, xor_group, capture_words)
    kernel.launches += 1
    return out


HIER_MAX_LEVELS = 62  # csrc/megakernel_args.h kHierMaxLevels


def _check_hier_segments(segments, levels: int, lanes: int, state_cap: int) -> None:
    """Refuses a segment table K8 cannot walk (HierMegakernelArgs): the
    segments contiguous from lane 0, none empty, their depths strictly
    increasing from >= 0 to L with levels_d the step to each, and the exit
    (the last segment and its pad lanes) inside the window."""
    if not 1 <= len(segments) <= levels + 1:
        raise InvalidArgumentError(
            f"a window of {levels} levels has 1 .. {levels + 1} segments, got {len(segments)}"
        )
    base, depth = 0, 0
    for t, seg in enumerate(segments):
        if len(seg) != 4:
            raise InvalidArgumentError(f"segment {t} must be (base, lanes, depth, levels_d)")
        b, n, d, ld = (int(x) for x in seg)
        if b != base or n < 1 or ld != d - depth or ld < (0 if t == 0 else 1):
            raise InvalidArgumentError(
                f"segment {t} {tuple(seg)} does not follow the last (which ended at lane "
                f"{base}, depth {depth})"
            )
        base, depth = b + n, d
    if depth != levels:
        raise InvalidArgumentError(f"the last segment lies at depth {depth}, not {levels}")
    if base > lanes or not segments[-1][1] <= state_cap <= lanes - segments[-1][0]:
        raise InvalidArgumentError(
            f"{base} segment lanes and an exit of {state_cap} from lane {segments[-1][0]} "
            f"must fit the window's {lanes} lanes and hold the last segment"
        )


def hier_megakernel(
    entry_seeds, entry_control, entry_pos, parent, path_masks, cw_planes, ccl, ccr,
    corrections, sel_bits, *, segments, state_cap: int, bits: int, party: int,
    xor_group: bool, keep: int,
):
    """K8, the hierarchical megakernel: one launch for a chunk of K keys and
    one prefix window of the heavy-hitters advance.

    entry_seeds int32[K, M, 4] and entry_control int32[K, M] (0 / 1), the
    window-entry state lane-major; entry_pos int64[Wp * 32], each lane's
    entry ancestor, which only the plain version reads (the kernel reaches
    it through the parents); parent int32[Wp * 32], each lane's parent (an entry lane
    for segment 0, a lane of segment t - 1 for segment t); path_masks
    int32[L, Wp] (each lane's path from its entry ancestor, shared by the
    keys); cw_planes int32[K, L, 128], ccl/ccr int32[K, L]; corrections
    int32[K, G * keep, lpe] and sel_bits int32[G * keep, Wp] (row t * keep +
    e: element e of slot t); segments: G tuples (base, lanes, depth,
    levels_d), segment t captured in slot t; state_cap: the exit lanes from
    the last segment's base -> (int32[K, keep * lpe * 32, Wp] value rows,
    row (e * lpe + l) * 32 + i at word w is limb l of element e of lane 32 w
    + i; int32[K, state_cap, 4] exit seeds; int32[K, state_cap] exit
    control). Each capture applies the full correction, party 1's negation
    included. Exit lanes past the last segment are pad lanes: entry lane 0
    walked L levels along path 0. The tables must be a window that
    ``hierarchical.prepare_levels_fused(mode="hierkernel")`` composes: the
    kernel walks each lane from its parent, so windows of random lanes are
    no input to it. Replaces aes_pallas.py:hier_megakernel_pallas_batched;
    the plain version is ``backend_torch.hier_window`` (gather, pack,
    ``backend_torch.hier_megakernel``, unpack).

    Bound on the H100: integer operations, one masked MMO hash per (segment,
    lane word) and tree level it advances from its parent and one value
    hash per (segment, lane word), against the entry lanes, the tables, the
    value rows and the exit state (csrc/hier_megakernel.cu). One cooperative
    launch; a launch the card refuses raises InternalError.
    """
    if bits % 32:
        raise NotImplementedError(
            f"K8's value correction handles 32-bit-multiple widths, got {bits}"
        )
    if party not in (0, 1):
        raise InvalidArgumentError(f"party must be 0 or 1, got {party}")
    lpe = bits // 32
    if keep < 1 or keep * lpe > 4:
        raise InvalidArgumentError(
            f"keep * lpe must be 1 .. 4 (one 128-bit block), got keep={keep}, lpe={lpe}"
        )
    if entry_seeds.dim() != 3 or path_masks.dim() != 2 or sel_bits.dim() != 2:
        raise InvalidArgumentError(
            f"entry_seeds must be [K, M, 4], path_masks [L, Wp] and sel_bits [n_rows, Wp], "
            f"got {tuple(entry_seeds.shape)}, {tuple(path_masks.shape)} and "
            f"{tuple(sel_bits.shape)}"
        )
    k, m = entry_seeds.shape[:2]
    levels, wp = path_masks.shape
    if not 1 <= levels <= HIER_MAX_LEVELS:
        raise InvalidArgumentError(
            f"a window walks 1 .. {HIER_MAX_LEVELS} tree levels, got {levels}"
        )
    segments = tuple(tuple(int(x) for x in seg) for seg in segments)
    _check_hier_segments(segments, levels, 32 * wp, state_cap)
    n_rows = len(segments) * keep
    if m < 1:
        raise InvalidArgumentError("the window-entry state must hold a lane")
    _check(entry_seeds, (k, m, 4), "entry_seeds")
    _check(entry_control, (k, m), "entry_control")
    if entry_pos.dtype != torch.int64 or tuple(entry_pos.shape) != (32 * wp,):
        raise InvalidArgumentError(
            f"entry_pos must be int64[{32 * wp}], got {entry_pos.dtype}{list(entry_pos.shape)}"
        )
    _check(parent, (32 * wp,), "parent")
    _check(path_masks, (levels, wp), "path_masks")
    _check(cw_planes, (k, levels, 128), "cw_planes")
    _check(ccl, (k, levels), "ccl")
    _check(ccr, (k, levels), "ccr")
    _check(corrections, (k, n_rows, lpe), "corrections")
    _check(sel_bits, (n_rows, wp), "sel_bits")
    args = (entry_seeds, entry_control, entry_pos, parent, path_masks, cw_planes, ccl, ccr,
            corrections, sel_bits)
    state_base = segments[-1][0]
    if _on_cpu(*args):
        return backend_torch.hier_window(
            entry_seeds, entry_control, entry_pos, path_masks, cw_planes, ccl, ccr,
            corrections, sel_bits, bits=bits, party=party, xor_group=xor_group, keep=keep,
            segments=segments, state_cap=state_cap,
        )
    if not all(t.is_contiguous() for t in args):
        raise InvalidArgumentError(f"{K8.name}: operands must be contiguous")
    dev = entry_seeds.device
    out = torch.empty((k, keep * lpe * 32, wp), dtype=torch.int32, device=dev)
    exit_seeds = torch.empty((k, state_cap, 4), dtype=torch.int32, device=dev)
    exit_control = torch.empty((k, state_cap), dtype=torch.int32, device=dev)
    if k == 0:
        return out, exit_seeds, exit_control
    # The walked lanes of every segment but the last, lane-major, which the
    # next segment reads its parents from.
    scratch = max(1, state_base)
    state_seeds = torch.empty((k, scratch, 4), dtype=torch.int32, device=dev)
    state_control = torch.empty((k, scratch), dtype=torch.int32, device=dev)
    err = library().hier_megakernel(
        entry_seeds, entry_control, parent, path_masks, cw_planes, ccl, ccr, corrections,
        sel_bits, out, state_seeds, state_control, exit_seeds, exit_control, lpe, keep,
        party, xor_group, [x for seg in segments for x in seg[:3]],
    )
    if err:
        raise InternalError(f"{K8.name}: the cooperative launch failed: {err}")
    K8.launches += 1
    return out, exit_seeds, exit_control


KEYGEN_MAX_LEVELS = 128  # csrc/megakernel_args.h kKeygenMaxLevels


def keygen_megakernel(planes0, planes1, path_masks, *, captures):
    """K9, the keygen megakernel: the whole two-party dealer loop for one key
    batch in one launch.

    planes0/planes1 int32[128, Wp] both parties' seed planes (keys in lanes:
    bit i of word w is key 32 w + i), path_masks int32[L, Wp] each level's
    packed alpha bits, captures: L + 1 flags, the last set -> (cw int32[L *
    128, Wp] seed-correction planes, cc int32[L * 2, Wp] rows ccl and ccr of
    each level, vh int32[slots * 256, Wp] value hashes, slot s, party p,
    plane q at row s * 256 + p * 128 + q, ctrl int32[slots, Wp] party 1's
    control at each capture). Replaces
    aes_pallas.py:keygen_megakernel_pallas_batched with the same boundary
    layouts; the plain version is ``backend_torch.keygen_megakernel``.

    Bound on the H100: integer operations, four MMO hashes per word and
    level and two per capture against the seed planes in and the
    corrections and value hashes out (csrc/keygen_megakernel.cu).
    """
    if path_masks.dim() != 2:
        raise InvalidArgumentError(f"path_masks must be [L, Wp], got {tuple(path_masks.shape)}")
    levels, wp = path_masks.shape
    if not 1 <= levels <= KEYGEN_MAX_LEVELS:
        raise InvalidArgumentError(
            f"the keygen megakernel runs 1 .. {KEYGEN_MAX_LEVELS} tree levels, got {levels}"
        )
    captures = tuple(bool(f) for f in captures)
    if len(captures) != levels + 1:
        raise InvalidArgumentError(
            f"captures must hold levels + 1 = {levels + 1} flags, got {len(captures)}"
        )
    if not captures[levels]:
        raise InvalidArgumentError("the last depth is always a value capture")
    _check(planes0, (128, wp), "planes0")
    _check(planes1, (128, wp), "planes1")
    _check(path_masks, (levels, wp), "path_masks")
    args = (planes0, planes1, path_masks)
    if _on_cpu(*args):
        return backend_torch.keygen_megakernel(*args, captures=captures)
    if not all(t.is_contiguous() for t in args):
        raise InvalidArgumentError(f"{K9.name}: operands must be contiguous")
    slots = sum(captures)
    dev = planes0.device
    cw = torch.empty((levels * 128, wp), dtype=torch.int32, device=dev)
    cc = torch.empty((levels * 2, wp), dtype=torch.int32, device=dev)
    vh = torch.empty((slots * 256, wp), dtype=torch.int32, device=dev)
    ctrl = torch.empty((slots, wp), dtype=torch.int32, device=dev)
    if wp == 0:
        return cw, cc, vh, ctrl
    mask = sum(1 << d for d, flag in enumerate(captures) if flag)
    capture_words = [(mask >> (32 * i)) & 0xFFFFFFFF for i in range(5)]
    library().keygen_megakernel(*args, cw, cc, vh, ctrl, capture_words)
    K9.launches += 1
    return cw, cc, vh, ctrl
