"""ctypes loader for the native AES-NI host engine (dpf_native.cc).

The port's copy of the JAX package's ``native/``: the same C API and the
same numpy wrappers. g++ builds the library at first use into the
package's ignored ``_build/`` directory, under a name that holds a hash of
the source and the flags, so a checkout whose files all carry one mtime
still rebuilds an edited source and never loads a stale one. The build
writes a temporary file and renames it into place, so processes that reach
a cold ``_build/`` together (pytest workers, server processes, replicas)
each load a whole library.

The host layer (core/aes_numpy.py, core/backend_numpy.py,
core/host_eval.py) uses the engine when it loads and otherwise runs its
numpy bodies, which stay the differential oracle. It does not load where
``DPF_TPU_NO_NATIVE=1`` is set, where the CPU lacks AES-NI, or where g++
fails; :func:`status` says which. Every wrapper is bit-exact with the numpy
engine. ``DPF_TPU_THREADS`` (default 1; 0 = every hardware thread) and
``DPF_TPU_NO_VAES`` (the 128-bit AES-NI path on a VAES host) are read by the
library once per process; outputs are bit-identical under both.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from ..utils import envflags

_HERE = Path(__file__).resolve().parent
_SRC = _HERE / "dpf_native.cc"
BUILD_DIR = _HERE.parent / "_build"
_FLAGS = ("-O3", "-maes", "-mssse3", "-pthread", "-shared", "-fPIC")

_lock = threading.Lock()
_lib = None
_tried = False
_reason: Optional[str] = None
_suspended = 0


def library_path() -> Path:
    """The library's path in ``_build/``: its name holds a hash of the
    source's contents and the build flags."""
    digest = hashlib.sha256(_SRC.read_bytes() + " ".join(_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libdpf_native.{digest[:16]}.so"


def _build(lib: Path) -> Optional[str]:
    """Builds `lib` with g++; returns None, or why the build failed."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = ["g++", *_FLAGS, str(_SRC), "-o", str(tmp)]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        return f"g++ did not run: {e}"
    if r.returncode != 0:
        try:
            tmp.unlink()
        except OSError:
            pass
        return f"g++ failed ({r.returncode}): {r.stderr.strip()[-2000:]}"
    os.replace(tmp, lib)
    return None


def _bind(lib) -> None:
    lib.dpf_native_uses_vaes.restype = ctypes.c_int
    lib.dpf_native_threads.restype = ctypes.c_int
    lib.dpf_native_cpu_brand.argtypes = [ctypes.c_char_p]
    lib.dpf_expand_key.argtypes = [ctypes.c_char_p, ctypes.c_void_p]
    lib.dpf_mmo_hash.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
    ]
    lib.dpf_mmo_hash_masked.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
    ]
    lib.dpf_evaluate_seeds.argtypes = [ctypes.c_void_p] * 8 + [
        ctypes.c_size_t, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.dpf_expand_forest.argtypes = [ctypes.c_void_p] * 7 + [
        ctypes.c_size_t, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.dpf_value_hash.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.dpf_dcf_evaluate_u64.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int,
    ] + [ctypes.c_void_p] * 8 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_size_t, ctypes.c_void_p,
    ]
    lib.dpf_dcf_evaluate_wide.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int,
    ] + [ctypes.c_void_p] * 8 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_size_t,
        ctypes.c_void_p,
    ]
    lib.dpf_finish_tree_values.argtypes = [ctypes.c_void_p] * 6 + [
        ctypes.c_uint8, ctypes.c_uint8, ctypes.c_int, ctypes.c_size_t,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.dpf_hash_correct_values.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_size_t, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]


def _load():
    global _lib, _tried, _reason
    with _lock:
        if _tried:
            return _lib
        # Parse the flag BEFORE latching _tried: a strict-parse failure
        # must raise on every call, not raise once and then silently
        # disable the native engine forever.
        no_native = envflags.env_bool("DPF_TPU_NO_NATIVE", default=False)
        _tried = True
        if no_native:
            _reason = "DPF_TPU_NO_NATIVE is set"
            return None
        try:
            path = library_path()
            if not path.exists():
                _reason = _build(path)
                if _reason is not None:
                    return None
            lib = ctypes.CDLL(str(path))
            if not lib.dpf_native_available():
                _reason = "this CPU lacks AES-NI or SSSE3"
                return None
            _bind(lib)
            _lib = lib
        except Exception as e:  # a broken library must not take the host layer down
            _reason = f"{type(e).__name__}: {e}"
            _lib = None
        return _lib


def available() -> bool:
    return not _suspended and _load() is not None


@contextlib.contextmanager
def suspended():
    """Within the block :func:`available` is False in this process, every
    thread included: the host layer runs its numpy bodies, the engine's
    differential oracle (how the tests and chip_smoke.py hold the two
    against each other in one process)."""
    global _suspended
    with _lock:
        _suspended += 1
    try:
        yield
    finally:
        with _lock:
            _suspended -= 1


def cpu_model() -> str:
    """The host CPU's model: ``/proc/cpuinfo``'s model name, else (where the
    kernel reports none, as some virtualized hosts do) the CPUID brand string
    through the loaded engine, else the platform's name."""
    name = ""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    name = line.split(":", 1)[1].strip()
                    break
    except OSError:
        pass
    if name and name.lower() != "unknown":
        return name
    lib = _load()
    if lib is not None:
        buf = ctypes.create_string_buffer(49)
        lib.dpf_native_cpu_brand(buf)
        brand = buf.value.decode(errors="replace").strip()
        if brand:
            return f"{brand} (CPUID)"
    return name or platform.processor() or platform.machine()


def status() -> dict:
    """Whether the engine loaded and how: ``available``; ``path``, "vaes"
    (four blocks a 512-bit register) or "aes-ni" (128-bit), None when not
    loaded; ``threads``, the worker threads of a batch call; ``reason``,
    why it did not load (the flag, a missing CPU feature or g++'s stderr),
    else None; ``library``, the built file."""
    lib = _load()
    if lib is None:
        return {"available": False, "path": None, "threads": None, "reason": _reason,
                "library": None}
    return {
        "available": True,
        "path": "vaes" if lib.dpf_native_uses_vaes() else "aes-ni",
        "threads": int(lib.dpf_native_threads()),
        "reason": None,
        "library": str(library_path()),
    }


def _ptr(a: np.ndarray):
    return np.ascontiguousarray(a).ctypes.data_as(ctypes.c_void_p)


def _loaded():
    lib = _load()
    assert lib is not None, "the native engine is not available"
    return lib


def expand_key(key_bytes: bytes) -> np.ndarray:
    """16-byte AES key -> uint8[11, 16] round keys."""
    lib = _loaded()
    out = np.empty((11, 16), dtype=np.uint8)
    lib.dpf_expand_key(key_bytes, out.ctypes.data_as(ctypes.c_void_p))
    return out


def mmo_hash_limbs(round_keys: np.ndarray, in_limbs: np.ndarray) -> np.ndarray:
    """MMO hash of uint32[N, 4] blocks with uint8[11, 16] round keys."""
    lib = _loaded()
    x = np.ascontiguousarray(in_limbs, dtype=np.uint32)
    out = np.empty_like(x)
    lib.dpf_mmo_hash(_ptr(round_keys), _ptr(x), _ptr(out), x.shape[0])
    return out


def mmo_hash_masked_limbs(
    rks_left: np.ndarray,
    rks_right: np.ndarray,
    in_limbs: np.ndarray,
    mask: np.ndarray,
) -> np.ndarray:
    """Per-block key-selected MMO hash (mask != 0 -> right key)."""
    lib = _loaded()
    x = np.ascontiguousarray(in_limbs, dtype=np.uint32)
    m = np.ascontiguousarray(mask, dtype=np.uint8)
    out = np.empty_like(x)
    lib.dpf_mmo_hash_masked(_ptr(rks_left), _ptr(rks_right), _ptr(x), _ptr(m), _ptr(out),
                            x.shape[0])
    return out


def evaluate_seeds(
    rks_left: np.ndarray,
    rks_right: np.ndarray,
    seeds: np.ndarray,  # uint32[N, 4]
    control: np.ndarray,  # bool/uint8[N]
    paths: np.ndarray,  # uint32[N, 4]
    cw_seed_limbs: np.ndarray,  # uint32[L, 4]
    cw_left: np.ndarray,  # bool/uint8[L]
    cw_right: np.ndarray,  # bool/uint8[L]
):
    """Native batched point-evaluation walk (EvaluateSeeds).

    Returns (uint32[N, 4] seeds, bool[N] control), bit-identical to
    core/backend_numpy's numpy walk.
    """
    lib = _loaded()
    x = np.ascontiguousarray(seeds, dtype=np.uint32)
    n = x.shape[0]
    out_seeds = np.empty_like(x)
    out_control = np.empty(n, dtype=np.uint8)
    lib.dpf_evaluate_seeds(
        _ptr(rks_left), _ptr(rks_right), _ptr(x),
        _ptr(np.ascontiguousarray(control, dtype=np.uint8)),
        _ptr(np.ascontiguousarray(paths, dtype=np.uint32)),
        _ptr(np.ascontiguousarray(cw_seed_limbs, dtype=np.uint32)),
        _ptr(np.ascontiguousarray(cw_left, dtype=np.uint8)),
        _ptr(np.ascontiguousarray(cw_right, dtype=np.uint8)),
        n, len(cw_seed_limbs), _ptr(out_seeds), _ptr(out_control),
    )
    return out_seeds, out_control.astype(bool)


def expand_forest(
    rks_left: np.ndarray,
    rks_right: np.ndarray,
    seeds: np.ndarray,  # uint32[N, 4] roots
    control: np.ndarray,  # bool/uint8[N]
    cw_seed_limbs: np.ndarray,  # uint32[L, 4]
    cw_left: np.ndarray,
    cw_right: np.ndarray,
    levels: int,
):
    """Doubling expansion of N roots by `levels` levels (ExpandSeeds).

    Returns (uint32[N << levels, 4], bool[N << levels]) in the interleaved
    per-level child order (leaf order), bit-identical to
    backend_numpy.expand_seeds's numpy body.
    """
    lib = _loaded()
    x = np.ascontiguousarray(seeds, dtype=np.uint32)
    n = x.shape[0]
    total = n << levels
    out_seeds = np.empty((total, 4), dtype=np.uint32)
    out_control = np.empty(total, dtype=np.uint8)
    scratch = np.empty((total, 4), dtype=np.uint32)
    lib.dpf_expand_forest(
        _ptr(rks_left), _ptr(rks_right), _ptr(x),
        _ptr(np.ascontiguousarray(control, dtype=np.uint8)),
        _ptr(np.ascontiguousarray(cw_seed_limbs, dtype=np.uint32)),
        _ptr(np.ascontiguousarray(cw_left, dtype=np.uint8)),
        _ptr(np.ascontiguousarray(cw_right, dtype=np.uint8)),
        n, int(levels), _ptr(out_seeds), _ptr(out_control), _ptr(scratch),
    )
    return out_seeds, out_control.astype(bool)


def value_hash(round_keys: np.ndarray, in_limbs: np.ndarray, blocks_needed: int):
    """MMO hash of in[i] + j for j < blocks_needed (HashExpandedSeeds).

    Returns uint32[N, blocks_needed, 4].
    """
    lib = _loaded()
    x = np.ascontiguousarray(in_limbs, dtype=np.uint32)
    n = x.shape[0]
    out = np.empty((n, blocks_needed, 4), dtype=np.uint32)
    lib.dpf_value_hash(_ptr(round_keys), _ptr(x), n, int(blocks_needed), _ptr(out))
    return out


def _dcf_args(rks_left, rks_right, rks_value, seed_limbs, party, cw_seed_limbs, cw_left,
              cw_right, vc, capture, acc_mask, block_sel, paths):
    return (
        _ptr(rks_left), _ptr(rks_right), _ptr(rks_value),
        _ptr(np.ascontiguousarray(seed_limbs, dtype=np.uint32)),
        int(party),
        _ptr(np.ascontiguousarray(cw_seed_limbs, dtype=np.uint32)),
        _ptr(np.ascontiguousarray(cw_left, dtype=np.uint8)),
        _ptr(np.ascontiguousarray(cw_right, dtype=np.uint8)),
        _ptr(vc),
        _ptr(np.ascontiguousarray(capture, dtype=np.uint8)),
        _ptr(np.ascontiguousarray(acc_mask, dtype=np.uint8)),
        _ptr(np.ascontiguousarray(block_sel, dtype=np.int32)),
        _ptr(np.ascontiguousarray(paths, dtype=np.uint32)),
    )


def dcf_evaluate_u64(
    rks_left: np.ndarray,
    rks_right: np.ndarray,
    rks_value: np.ndarray,
    seed_limbs: np.ndarray,  # uint32[4]
    party: int,
    cw_seed_limbs: np.ndarray,  # uint32[T, 4]
    cw_left: np.ndarray,  # bool/uint8[T]
    cw_right: np.ndarray,  # bool/uint8[T]
    vc: np.ndarray,  # uint64[T+1, epb] value corrections by depth
    capture: np.ndarray,  # bool/uint8[T+1]
    acc_mask: np.ndarray,  # uint8[T+1, P]
    block_sel: np.ndarray,  # int32[T+1, P]
    paths: np.ndarray,  # uint32[P, 4] tree indices
    value_bits: int,
) -> np.ndarray:
    """Fused batched DCF evaluation of one key (<= 64-bit additive values).

    One root-to-leaf walk per point with per-depth value captures, the host
    twin of dcf/batch.py's walk on the card. Returns uint64[P] shares.
    """
    lib = _loaded()
    vc = np.ascontiguousarray(vc, dtype=np.uint64)
    out = np.empty(paths.shape[0], dtype=np.uint64)
    lib.dpf_dcf_evaluate_u64(
        *_dcf_args(rks_left, rks_right, rks_value, seed_limbs, party, cw_seed_limbs,
                   cw_left, cw_right, vc, capture, acc_mask, block_sel, paths),
        int(value_bits), int(vc.shape[1]), len(cw_seed_limbs), paths.shape[0], _ptr(out),
    )
    return out


def dcf_evaluate_wide(
    rks_left: np.ndarray,
    rks_right: np.ndarray,
    rks_value: np.ndarray,
    seed_limbs: np.ndarray,  # uint32[4]
    party: int,
    cw_seed_limbs: np.ndarray,  # uint32[T, 4]
    cw_left: np.ndarray,  # bool/uint8[T]
    cw_right: np.ndarray,  # bool/uint8[T]
    vc: np.ndarray,  # uint64[T+1, epb, 2] value corrections (lo, hi)
    capture: np.ndarray,  # bool/uint8[T+1]
    acc_mask: np.ndarray,  # uint8[T+1, P]
    block_sel: np.ndarray,  # int32[T+1, P]
    paths: np.ndarray,  # uint32[P, 4] tree indices
    value_bits: int,
    is_xor: bool,
) -> np.ndarray:
    """Fused batched DCF evaluation of one key, every scalar group.

    `dcf_evaluate_u64` widened to 128-bit values and XOR groups; values
    travel as (lo, hi) uint64 pairs. Returns uint64[P, 2] shares.
    """
    lib = _loaded()
    vc = np.ascontiguousarray(vc, dtype=np.uint64)
    out = np.empty((paths.shape[0], 2), dtype=np.uint64)
    lib.dpf_dcf_evaluate_wide(
        *_dcf_args(rks_left, rks_right, rks_value, seed_limbs, party, cw_seed_limbs,
                   cw_left, cw_right, vc, capture, acc_mask, block_sel, paths),
        int(value_bits), 1 if is_xor else 0, int(vc.shape[1]), len(cw_seed_limbs),
        paths.shape[0], _ptr(out),
    )
    return out


def expand_forest_values(
    rks_left: np.ndarray,
    rks_right: np.ndarray,
    rks_value: np.ndarray,
    seeds: np.ndarray,  # uint32[N, 4] roots
    control: np.ndarray,  # bool/uint8[N]
    cw_seed_limbs: np.ndarray,  # uint32[L, 4]
    cw_left: np.ndarray,
    cw_right: np.ndarray,
    party: int,
    levels: int,
    vc_wide: np.ndarray,  # uint64[epb, 2]
    value_bits: int,
    is_xor: bool,
    keep_per_block: int,
    out: np.ndarray = None,
) -> np.ndarray:
    """Fused forest evaluation: N prefix roots expand `levels` levels with
    the final level fused into the value hash and correction pass (root
    j's outputs land contiguously). For full-domain and hierarchy tails
    where the expansion state is not needed afterwards.

    Returns uint8[(N << levels) * keep_per_block * value_bits/8] element
    bytes (or writes into a matching C-contiguous `out`).
    """
    lib = _loaded()
    vc_wide = np.ascontiguousarray(vc_wide, dtype=np.uint64)
    n = seeds.shape[0]
    n_out_bytes = (n << levels) * keep_per_block * (value_bits // 8)
    if out is None:
        out = np.empty(n_out_bytes, dtype=np.uint8)
    else:
        assert out.flags["C_CONTIGUOUS"] and out.nbytes == n_out_bytes
        out = out.view(np.uint8).reshape(-1)
    if levels == 0:
        lib.dpf_hash_correct_values(
            _ptr(rks_value),
            _ptr(np.ascontiguousarray(seeds, dtype=np.uint32)),
            _ptr(np.ascontiguousarray(control, dtype=np.uint8)),
            int(party), n, _ptr(vc_wide), int(value_bits), 1 if is_xor else 0,
            int(keep_per_block), _ptr(out),
        )
        return out
    parents, ctl_parents = expand_forest(
        rks_left, rks_right, seeds, np.ascontiguousarray(control, dtype=np.uint8),
        cw_seed_limbs[: levels - 1], cw_left[: levels - 1], cw_right[: levels - 1],
        levels - 1,
    )
    last = levels - 1
    lib.dpf_finish_tree_values(
        _ptr(rks_left), _ptr(rks_right), _ptr(rks_value),
        _ptr(parents),
        _ptr(np.ascontiguousarray(ctl_parents, dtype=np.uint8)),
        _ptr(np.ascontiguousarray(cw_seed_limbs[last], dtype=np.uint32)),
        int(bool(cw_left[last])), int(bool(cw_right[last])), int(party),
        parents.shape[0], _ptr(vc_wide), int(value_bits), 1 if is_xor else 0,
        int(keep_per_block), _ptr(out),
    )
    return out
