#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port on one GPU and checks it.

Run from the root of the repository, on a machine with an NVIDIA H100 and
the CUDA toolkit:

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero before the result line):

1. card: the card's name and power limit (nvidia-smi), then the build of
   the kernels from csrc/ with torch.utils.cpp_extension.load, with each kernel's registers and spills;
2. kernels: K2, K3 and K4 against their plain PyTorch versions on the card
   (exact: the outputs are integers), at the main path's shapes and a ragged
   width, each timed beside its plain version and its bound;
3. fold: 1024 Int(64) keys per party at log-domain 20 through
   ``full_domain_fold_chunks`` (key_chunk 128), on the default last step
   (K2 per level, then K4) and the fused one (K2, then K3); the kernel
   folds of 8 keys equal the plain path run on the card, and both paths
   agree;
4. PIR: a 2^20 x XorWrapper(128) database, one ``pir_query_batch_chunked``
   batch per party; every answer reconstructs its record.

Before the main path runs, every launch count is set to 0; after it, every
kernel of the path must have launched. The line before the last is the
``{"kernels": [...]}`` JSON, the last line ``{"ok": true, "device": ...}``.
Imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np

SEED = 20261016
LOG_DOMAIN = 20
NUM_KEYS = 1024
KEY_CHUNK = 128
HOST_LEVELS = 5
PIR_QUERIES = 128

# H100 SXM peaks (NVIDIA data sheet): HBM3 at 3.35 TB/s; 32-bit integer
# logic at 64 lanes per SM per clock, 132 SMs, 1980 MHz boost clock.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# A LOP3 instruction evaluates any function of three words, so it can retire
# two chained two-input gates of the circuit: the least instruction count of
# a gate count g is g / 2.
GATES_PER_INSTRUCTION = 2

# Two-input gates the AES-128 function needs per lane word: the smallest
# published circuits, not the circuit as the kernels write it.
SBOX_GATES = 113  # Boyar, Matthews, Peralta, J. Cryptology 26(2), 2013: 32 AND, 81 XOR/XNOR
MIXCOLUMN_GATES = 92  # one 32-bit column: Maximov, "AES MixColumn with 92 XOR gates", ePrint 2019/833
# AddRoundKey with a fixed, public key: a 0 key plane needs no gate, a ~0
# plane one NOT. `key_planes` counts the ~0 planes of a table's 11 round keys.


def mmo_gates(key_planes: int) -> int:
    """AES(sigma(x)) ^ sigma(x) for one lane word: sigma is 64 XORs and the
    feed-forward 128."""
    aes = 10 * 16 * SBOX_GATES + 9 * 4 * MIXCOLUMN_GATES + key_planes
    return aes + 64 + 128


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps: int) -> float:
    """Median device time of one call, from CUDA events, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(nbytes: float, gates: float):
    """(least time in ms, what bounds it) for moving `nbytes` through HBM
    and retiring `gates` two-input logic gates."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = gates / GATES_PER_INSTRUCTION / INT32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops else "operations")


def expand_cost(key_planes, k: int, w: int, hash_child: bool):
    """(bytes, gates) of K2 (or K3 with `hash_child`) on K keys of W words:
    each child word hashes under its child's PRG key, then takes the seed
    correction (cw & control, 256 gates) and the control update (2 gates)."""
    nbytes = 4 * (k * 128 * w + k * w + k * 128 + 2 * k + k * 128 * 2 * w + k * 2 * w)
    per_pair = sum(mmo_gates(key_planes[t]) + 2 * 128 + 2 for t in ("left", "right"))
    if hash_child:
        per_pair += 2 * mmo_gates(key_planes["value"])
    return nbytes, k * w * per_pair


def hash_cost(key_planes, k: int, w: int):
    """(bytes, gates) of K4 on K keys of W words."""
    return 4 * 2 * k * 128 * w, k * w * mmo_gates(key_planes["value"])


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    try:
        import distributed_point_functions_tpu_torch as T
        from distributed_point_functions_tpu_torch.ops import (
            aes_cuda, aes_torch, backend_torch, evaluator,
        )
        from distributed_point_functions_tpu_torch.parallel import pir
    except ImportError as e:
        fail(f"the port is not in this checkout: {e}")

    dev = torch.device("cuda")
    key_planes = {
        t: int(np.count_nonzero(backend_torch._rk_np(t))) for t in ("left", "right", "value")
    }
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
          f"{sys.version.split()[0]}, {kind} x{torch.cuda.device_count()}")

    # -- 1. build ---------------------------------------------------------
    t0 = time.perf_counter()
    aes_cuda.library()
    print(f"build: csrc/binding.cpp + csrc/expand.cu for sm_90a in "
          f"{time.perf_counter() - t0:.1f} s")
    for kern in aes_cuda.KERNELS:
        if "registers" not in kern.ptxas:
            fail(f"no ptxas report for {kern.name}")
        print(f"  {kern.name}: {kern.ptxas}")

    # -- 2. kernels against their plain versions ---------------------------
    # Main-path widths: Int(64) at log-domain 20 has 19 tree levels, XorWrapper
    # (128) 20; 5 run on the host, so K2 sees W = 1 .. 2^(levels-6) input
    # words, K3 the last of those, and K4 the doubled last width.
    vt_levels = {"Int(64)": LOG_DOMAIN - 1, "XorWrapper(128)": LOG_DOMAIN}
    max_w = max(1 << (lv - HOST_LEVELS - 1) for lv in vt_levels.values())
    g = torch.Generator(device=dev).manual_seed(SEED)

    def rnd(*shape):
        return torch.randint(
            -(2**31), 2**31 - 1, shape, dtype=torch.int32, device=dev, generator=g
        )

    def expand_args(k, w):
        return rnd(k, 128, w), rnd(k, w), rnd(k, 128), rnd(k), rnd(k)

    checks = {}

    def hold(name, got, want):
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            err = max(
                int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
                for a, b in zip(got, want)
            )
            fail(f"{name} disagrees with its plain version (max abs err {err})")
        checks[name] = 0

    for k, w in ((KEY_CHUNK, 1), (5, 3), (KEY_CHUNK, 1000 + 37)):
        args = expand_args(k, w)
        hold("K2", aes_cuda.expand_one_level(*args), backend_torch.expand_one_level(*args))
        hold("K3", aes_cuda.expand_and_hash_last_level(*args),
             backend_torch.expand_and_hash_last_level(*args))
        hold("K4", aes_cuda.hash_value_planes(args[0]),
             backend_torch.hash_value_planes(args[0]))
    print(f"kernels vs plain at W = 1, 3, 1037 (exact): {checks}")

    rows = {}
    args = expand_args(KEY_CHUNK, max_w)
    planes2 = rnd(KEY_CHUNK, 128, 2 * max_w)
    for name, kern, call, plain, cost in (
        ("K2", aes_cuda.K2, lambda: aes_cuda.expand_one_level(*args),
         lambda: backend_torch.expand_one_level(*args),
         expand_cost(key_planes, KEY_CHUNK, max_w, False)),
        ("K3", aes_cuda.K3, lambda: aes_cuda.expand_and_hash_last_level(*args),
         lambda: backend_torch.expand_and_hash_last_level(*args),
         expand_cost(key_planes, KEY_CHUNK, max_w, True)),
        ("K4", aes_cuda.K4, lambda: aes_cuda.hash_value_planes(planes2),
         lambda: backend_torch.hash_value_planes(planes2),
         hash_cost(key_planes, KEY_CHUNK, 2 * max_w)),
    ):
        hold(name, call(), plain())
        ms = time_ms(torch, call, 10)
        plain_ms = time_ms(torch, plain, 2)
        b_ms, b_by = bound_ms(*cost)
        rows[name] = dict(kernel=kern, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                          bound_by=b_by)
        print(f"{name} at K={KEY_CHUNK}, W={max_w if name != 'K4' else 2 * max_w}: "
              f"{ms:.4f} ms (plain {plain_ms:.2f} ms, bound {b_ms:.4f} ms by {b_by}); "
              f"{kern.ptxas}")
    del args, planes2
    k2_widths = {}
    for lv in range(max(vt_levels.values()) - HOST_LEVELS):
        w = 1 << lv
        a = expand_args(KEY_CHUNK, w)
        k2_widths[w] = round(time_ms(torch, lambda: aes_cuda.expand_one_level(*a), 5), 4)
    print(f"K2 ms per input width at K={KEY_CHUNK}: {json.dumps(k2_widths)}")
    torch.cuda.empty_cache()

    # -- 3. the main path: full-domain fold ---------------------------------
    rng = np.random.default_rng(SEED)
    dpf = T.DistributedPointFunction.create(T.DpfParameters(LOG_DOMAIN, T.Int(64)))
    alphas = [int(a) for a in rng.integers(0, 1 << LOG_DOMAIN, size=NUM_KEYS)]
    betas = [int(b) for b in rng.integers(1, 2**63, size=NUM_KEYS, dtype=np.uint64)]
    seeds = rng.integers(0, 2**32, size=(NUM_KEYS, 2, 4), dtype=np.uint32)
    t0 = time.perf_counter()
    keys = dpf.generate_keys_batch(alphas, [betas], seeds=seeds)
    print(f"keygen: {NUM_KEYS} Int(64) key pairs at log-domain {LOG_DOMAIN} in "
          f"{time.perf_counter() - t0:.2f} s (host)")

    def fold_pass(party_keys, fuse):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = [
            fold[:valid]
            for valid, fold in evaluator.full_domain_fold_chunks(
                dpf, party_keys, key_chunk=KEY_CHUNK, fuse_last_hash=fuse
            )
        ]
        folds = aes_torch.from_words(torch.cat(out))
        return folds, time.perf_counter() - t

    main_launches = {}
    results = {}
    for fuse in (False, True):
        aes_cuda.reset_launch_counts()
        for party in (0, 1):
            results[(fuse, party)] = fold_pass(keys[party], fuse)
        counts = {k.name: k.launches for k in aes_cuda.KERNELS}
        path = "fused" if fuse else "default"
        need = (aes_cuda.K2, aes_cuda.K3 if fuse else aes_cuda.K4)
        for kern in need:
            if kern.launches == 0:
                fail(f"{path} path ran without launching {kern.name}")
            main_launches[kern.name] = main_launches.get(kern.name, 0) + kern.launches
        secs = [results[(fuse, p)][1] for p in (0, 1)]
        print(f"fold, {path} path: {NUM_KEYS} keys x 2^{LOG_DOMAIN} per party in "
              f"{secs[0]:.3f} s / {secs[1]:.3f} s = "
              f"{NUM_KEYS * 2**LOG_DOMAIN / min(secs):.4e} evals/s; launches {counts}")
    # The AES work of one default-path pass, against the card's bound.
    levels = LOG_DOMAIN - 1 - HOST_LEVELS
    chunks = NUM_KEYS // KEY_CHUNK
    pass_gates = chunks * (
        sum(expand_cost(key_planes, KEY_CHUNK, 1 << lv, False)[1] for lv in range(levels))
        + hash_cost(key_planes, KEY_CHUNK, 1 << levels)[1]
    )
    pass_bound, _ = bound_ms(0, pass_gates)
    print(f"fold pass: {pass_gates:.4e} two-input gates of AES work, bound "
          f"{pass_bound:.1f} ms by operations")
    for party in (0, 1):
        if not np.array_equal(results[(False, party)][0], results[(True, party)][0]):
            fail(f"default and fused folds differ (party {party})")
        # The plain path on the card, for the first 8 keys of the first chunk.
        kb = evaluator.KeyBatch.from_keys(dpf, keys[party][:8], device=dev)
        ch = evaluator._prepare_chunk(kb, 8, HOST_LEVELS, 64)
        want = aes_torch.from_words(evaluator._fold_chunk(
            ch, None, LOG_DOMAIN - 1 - HOST_LEVELS, 64, party, False, 2, False,
            ops=backend_torch,
        ))
        if not np.array_equal(results[(False, party)][0][:8], want):
            fail(f"kernel folds differ from the plain path on the card (party {party})")
    print("fold: default == fused for every key; kernels == plain path for 8 keys "
          "per party")

    # Where one chunk's time goes (default path, party 0).
    kb = evaluator.KeyBatch.from_keys(dpf, keys[0][:KEY_CHUNK], device=dev)
    torch.cuda.synchronize()
    t = time.perf_counter()
    ch = evaluator._prepare_chunk(kb, KEY_CHUNK, HOST_LEVELS, 64)
    torch.cuda.synchronize()
    prep_s = time.perf_counter() - t
    levels = LOG_DOMAIN - 1 - HOST_LEVELS

    def kernels_only():
        p, c = aes_torch.pack_to_planes(ch.seeds), ch.control_mask
        for lv in range(levels):
            p, c = aes_cuda.expand_one_level(p, c, ch.cw[lv], ch.ccl[lv], ch.ccr[lv])
        aes_cuda.hash_value_planes(p)

    chunk_ms = time_ms(torch, lambda: evaluator._fold_chunk(
        ch, None, levels, 64, 0, False, 2, False), 3)
    kern_ms = time_ms(torch, kernels_only, 3)
    print(f"one chunk ({KEY_CHUNK} keys): host prep + upload {prep_s * 1e3:.1f} ms, "
          f"device {chunk_ms:.1f} ms of which pack + K2 x {levels} + K4 "
          f"{kern_ms:.1f} ms, unpack/correct/fold {chunk_ms - kern_ms:.1f} ms")
    del results, ch
    torch.cuda.empty_cache()

    # -- 4. the main path: PIR ----------------------------------------------
    pdpf = T.DistributedPointFunction.create(
        T.DpfParameters(LOG_DOMAIN, T.XorWrapper(128))
    )
    db = rng.integers(0, 2**32, size=(1 << LOG_DOMAIN, 4), dtype=np.uint32)
    targets = [int(a) for a in rng.integers(0, 1 << LOG_DOMAIN, size=PIR_QUERIES)]
    qseeds = rng.integers(0, 2**32, size=(PIR_QUERIES, 2, 4), dtype=np.uint32)
    qa, qb = pdpf.generate_keys_batch(targets, [(1 << 128) - 1], seeds=qseeds)
    t = time.perf_counter()
    prepared = pir.prepare_pir_database(pdpf, db)
    print(f"PIR: 2^{LOG_DOMAIN} x 16-byte database prepared in "
          f"{time.perf_counter() - t:.2f} s")
    aes_cuda.reset_launch_counts()
    answers = []
    for q in (qa, qb):
        torch.cuda.synchronize()
        t = time.perf_counter()
        answers.append(pir.pir_query_batch_chunked(pdpf, q, prepared, mode="fold"))
        secs = time.perf_counter() - t
        print(f"PIR: {PIR_QUERIES} queries in {secs:.3f} s = "
              f"{PIR_QUERIES / secs:.1f} queries/s")
    for kern in (aes_cuda.K2, aes_cuda.K4):
        if kern.launches == 0:
            fail(f"PIR ran without launching {kern.name}")
        main_launches[kern.name] = main_launches.get(kern.name, 0) + kern.launches
    rec = answers[0] ^ answers[1]
    if not np.array_equal(rec, db[targets]):
        bad = int((rec != db[targets]).any(axis=1).sum())
        fail(f"PIR: {bad} of {PIR_QUERIES} answers do not reconstruct their record")
    print(f"PIR: all {PIR_QUERIES} answers reconstruct (ra ^ rb == db[alpha]); "
          f"main-path launches {main_launches}")

    if "jax" in sys.modules:
        fail("JAX was imported")
    if any(m == "distributed_point_functions_tpu" or m.startswith("distributed_point_functions_tpu.")
           for m in sys.modules):
        fail("the JAX package was imported")

    # -- result -------------------------------------------------------------
    k1_bound, k1_by = bound_ms(0, hash_cost(key_planes, KEY_CHUNK, 2 * max_w)[1])
    kernels = [{
        "name": "K1 aes_rows (device function inlined in K2-K4; timed as K4)",
        "route": "cuda",
        "source": "distributed_point_functions_tpu_torch/csrc/aes_rows.cuh",
        "replaces": "distributed_point_functions_tpu/ops/aes_pallas.py:182",
        "launches": sum(main_launches.values()),
        "max_abs_err": checks["K4"],
        "ms": rows["K4"]["ms"],
        "plain_ms": rows["K4"]["plain_ms"],
        "bound_ms": k1_bound,
        "bound_by": k1_by,
        "library_ms": None,
    }]
    for name, line in (("K2", 315), ("K3", 421), ("K4", 462)):
        r = rows[name]
        kernels.append({
            "name": r["kernel"].name,
            "route": "cuda",
            "source": "distributed_point_functions_tpu_torch/csrc/expand.cu",
            "replaces": f"distributed_point_functions_tpu/ops/aes_pallas.py:{line}",
            "launches": main_launches.get(r["kernel"].name, 0),
            "max_abs_err": checks[name],
            "ms": r["ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "library_ms": None,
        })
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
