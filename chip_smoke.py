#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port on one GPU and checks it.

Run from the root of the repository, on a machine with an NVIDIA H100 and
the CUDA toolkit:

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero before the result line):

1. card: the card's name and power limit (nvidia-smi), then the build of
   the kernels from csrc/ with torch.utils.cpp_extension.load, with each
   kernel's registers and spills;
2. kernels: K2, K3, K4 and K5 against their plain PyTorch versions on the
   card (exact: the outputs are integers), at the main path's shapes and
   ragged ones (K5: a tiny plan with one-word slabs, a multi-slab plan with
   a database, 8 keys at the fold's full plan, 128 keys at it with each
   key's slabs over the blocks the wrapper chooses and over one block, and
   128 queries at the PIR path's plan with its database in phase 4, the
   same two ways), each timed beside its plain version and its bound; K2's
   and K3's registers, spills and stack frame, K5's registers and spills,
   and a timing probe of K5 at one block a key; K2 and K3 held again at
   each input width of the fold (K = 128, W = 1 to 16,384), K2 timed at
   each;
3. fold: 1024 Int(64) keys per party at log-domain 20 through
   ``full_domain_fold_chunks`` (key_chunk 128), on the default last step
   (K2 per level, then K4), the fused one (K2, then K3) and
   mode="megakernel" (one K5 launch per chunk); the kernel folds of 8 keys
   equal the plain path run on the card, and all three paths agree for
   every key;
4. PIR: a 2^20 x XorWrapper(128) database, one ``pir_query_batch_chunked``
   batch per party in mode="fold" over the lane order and in
   mode="megakernel" over the megakernel order; every answer reconstructs
   its record and the two modes agree;
5. walk kernels: K6, K4 and K7 against their plain versions on the card
   (exact), at odd shapes (W = 1, 3, 8, 13, 37 and 1037 words, mixed path
   masks, both parties, Int(32) with keep 4 and 2, Int(64) with keep 1 and
   2, XorWrapper(128), Int(128); K x W items not a multiple of the eight a
   warp of K4, K6 and K7 runs, so that a warp straddles the end) and at the
   EvaluateAt path's full width (K = 1024 keys, W = 128 words, L = 31
   levels), with K4 at that shape, each timed beside its plain version and
   its bound; K4's and K6's registers, spills and stack frame, and K7's in
   both forms;
6. EvaluateAt: 1024 Int(64) key pairs at log-domain 32 over 4096 points
   that hold every alpha, through ``evaluate_at_batch`` in mode="walk" (31
   K6 launches and one K4 per chunk) and mode="walkkernel" (one K7 launch
   per chunk); every share pair reconstructs beta at its alpha and 0
   elsewhere, the modes agree, and the port's host ``dpf.evaluate_at``
   equals both for 4 keys at all 4096 points; then the codec walk: 64
   IntModN(64, 2^64 - 59) key pairs at log-domain 24 over 256 points that
   hold every alpha, mode="walk" (24 K6 launches and one K4 a party), every
   share pair reconstructing mod N and the host ``dpf.evaluate_at`` equal
   for 2 keys a party;
7. DCF kernels: K7's DCF form against its plain version on the card
   (exact), at odd shapes (W = 1, 3, 37 words at K = 5, each leaving a
   warp that straddles the end, both parties, Int(32), Int(64) with keep 1
   and 2, XorWrapper(128), Int(128), captures tuples with depths that do
   not capture) and at BASELINE config 4's shape (K =
   512 keys, W = 16 words, L = 23 levels, Int(64)), with K4 and K6 at that
   shape, each timed beside its plain version and its bound;
8. DCF: BASELINE config 4 (benchmarks/bench_dcf.py: 512 Int(64) key pairs at
   log-domain 24, 512 points that hold every alpha and every alpha - 1 in
   the domain) through ``dcf.batch.batch_evaluate`` in mode="walk" (23 K6
   and 24 K4 launches per chunk) and mode="walkkernel" (one launch of K7's
   DCF form per chunk); every share pair reconstructs beta where x < alpha
   and 0 elsewhere, the modes agree, and the port's host ``dcf.evaluate``
   equals both for 4 keys at 16 points;
9. hierarchical kernel: K8 against its plain version on the card (exact:
   every value row and the exit state, pad lanes included) on the seven
   windows of small hierarchies in ops/hier_cases.py (Int(32)
   keeping 2 and 4, Int(64), Int(128), XorWrapper(128), both parties, a
   zero-level first step, steps of two and three tree levels, corrections
   that carry through every limb) and on window 4 of the heavy-hitters
   configuration (below) from an entry state of random context seeds, at
   key chunks of 4 and 32; then timed at the main path's chunk of 32 beside
   its plain version and its bound (counted at the function's work: a walk
   hash per tree node and level), every window timed at that chunk, with
   K2 and K4 at the fused mode's widest shape;
10. heavy hitters: BM_HeavyHitters at the top of its sweep (128 hierarchy
   levels, log-domain i + 1 at level i, Int(64), the prefixes of 10,000
   uniform leaves and the keys' alphas; benchmarks/bench_heavy_hitters.py),
   128 keys a party, through ``hierarchical.evaluate_levels_fused`` in
   mode="fused" (one K2 launch per tree level, one K4 per hierarchy level)
   and mode="hierkernel" (one K8 launch per prefix window of 16 levels and
   key chunk of 32); every level's share pair reconstructs beta at alpha's
   prefix and 0 at every other candidate, the modes agree bit for bit, and
   the port's CPU path on 2 keys equals the card;
11. keygen kernels: K9 against its plain version on the card (exact), at
   odd shapes (W = 1, 3, 5, 37 words, odd numbers of key words, so that
   the last of K9's two-word warps straddles the end, and 8; 1-5 levels,
   depths that do and do not capture) and on BM_KeyGeneration's 1024-key
   batch at depth 20 (below); K9 timed at 1024 keys at depths 20 and 128,
   at 16,384 keys at depth 128 and at BASELINE config 4's DCF dealer,
   beside its plain version, its bound and its per-warp issue floor, with
   its registers, spills and stack frame; K2's one-key view (the legacy
   [128, W] kernel) against its plain
   version at benchmarks/micro_tpu.py's W = 8192, timed;
12. keygen: BM_KeyGeneration (benchmarks/bench_keygen.py: single-level
   Int(64) DPFs, 1024 keys at log-domains 20, 64 and 128, draws from
   default_rng(23)) and config 4's DCF dealer (512 keys, log-domain 24)
   through ``keygen_batch.generate_keys_batch`` (the DCF through
   ``generate_keys_batch(mode=...)``) in mode="megakernel" (one K9 launch a
   batch), mode="perlevel" (one K2 a tree level, through its one-key view,
   and one K4 a capture) and mode="numpy-threaded"; every key of both
   parties equals the host numpy dealer's field by field, with keys/s per
   mode and where mode megakernel's and mode perlevel's time goes;
13. end to end: the depth-20 megakernel keys through
   ``evaluate_at_batch(mode="walkkernel")`` at every alpha and 63 other
   points; every share pair reconstructs beta at its alpha and 0 elsewhere;
14. the codec path's kernels: K2 and K4 at W = 1 for 256 keys (config 3's
   levels 0 and 1: a tree of 3 levels pads its 8 host lanes to one word),
   K2 and K4 at config 3's widest shapes (a key chunk at 2^18 words in, 2
   keys at 2^19 words), K6 on the full-domain walk's path masks (W = 1,
   37 and the walk's 1024 words at config 3's level 4), each exact against
   its plain version and the widest timed; then ``correct_values`` over a
   K4 stream on the card against the same functions on the CPU for
   IntModN(64, 2^64 - 59), IntModN(128, 2^80 - 65), the 160-bit tuple of
   five Int(32) (two K4 launches) and Tuple(Int(32), Tuple(IntModN(64),
   Int(32))) (the sampling chain), both parties;
15. BASELINE config 3 (benchmarks/bench_intmodn_hierarchy.py): 8
   IntModN(64, 2^64 - 59) hierarchy levels at log-domains 3, 6, ..., 24,
   256 key pairs from default_rng(3) through the port's host dealer, both
   parties through ``full_domain_evaluate_chunks(mode="fused")`` at every
   level (K2 a device level, K4, the plain-torch finalize); every share
   pair of every key checked on the card ((r0 + r1) mod N is beta at
   alpha's prefix, 0 elsewhere), with each level's wall time, a chunk's
   host, K2, K4 and finalize time and the peak device memory; mode "walk"
   (K6 a tree level, K4) equal at levels 0-4, ``lane_slab`` pieces and two
   ``PreparedKeyBatch`` replays at level 5, mode "levels" at level 6; the
   host ``dpf.evaluate_at`` equal to the card for 2 keys a party at 16
   points a level;
16. FSS gates at benchmarks/bench_gates.py's configuration (log-group 16,
   2048 masked inputs from default_rng(0x9A7E), 5 fractional bits, vector
   payloads): K6 and K4 at the sigmoid gate's shapes (K = 1, W = 1024; nb
   x W = 4 x 1024 words) and K7's DCF form at DReLU's (K = 1, W = 128) and
   bit decomposition's (K = 16, W = 2048), each exact against its plain
   version and timed; then DReLU (one Int(128) key, 4,096 points), ReLU
   (a Tuple(Int(32) x 4) key, 8,192), sigmoid and tanh (16 Int(32)s in 4
   value blocks, 32,768), bit decomposition (16 Int(128) keys, 65,536)
   and the scalar-payload ReLU (4 Int(128) keys) through ``batch_eval``,
   both parties, mode walk (K6 a tree level, K4 a depth) and, for DReLU,
   bit decomposition and the scalar ReLU, mode walkkernel (one launch of
   K7's DCF form); every input reconstructs ((s0 + s1 - r_out) mod N, mod
   2 for bit decomposition) to the plaintext, the modes agree, the host
   ``gate.eval`` equals 4 inputs a gate (bit decomposition: the host DCF
   equals the card's pass at the 32 sites of one input that its combine
   reads), and the dealers on the card (K9 for DReLU and ReLU, mode
   perlevel for sigmoid) give the host dealer's bytes; each gate's dealer
   time and ``batch_eval``'s own step times (``timings``: plan, tables,
   walk and the card's part of it, pull, Python ints, combine), wall,
   gate evaluations/s, DCF walks/s and peak memory; and
   examples/secure_relu_demo.py's flow: a ReLU layer of 256 and a sigmoid
   layer of 64 activations from ``gen_bundle``, each party's keys through
   ``serialize_gate_key`` / ``parse_gate_key``, ``bundle_eval`` on the
   card, every activation reconstructing to the plaintext;
17. the EvaluationContext API, both parties: BASELINE config 1 (one
   XorWrapper(128) key pair at log-domain 20) through
   ``hierarchical.evaluate_until_batch`` (K2 a tree level, K4), the shares
   XORing to beta at alpha and 0 elsewhere, the host ``evaluate_until`` on
   ``backend_torch.TorchBackend`` (K2, K4) equal, the numpy host
   ``evaluate_at`` equal at 4,096 points; BM_IsrgExampleHierarchy
   (benchmarks/bench_isrg.py: Int(32), log-domain 12 in full, then 2^13
   leaves under each of the 32 prefixes from default_rng(13)), the shares
   reconstructing, the numpy host ``evaluate_next`` equal at both levels,
   ``evaluate_next`` and ``evaluate_at(ctx=...)`` on TorchBackend (K2, K4,
   K6) equal at 256 points; BM_HeavyHitters one ``evaluate_until_batch`` a
   level (phase 10's keys and plan), every level equal to phase 10's mode
   fused bit for bit, per level the wall, the steps (KeyBatch, positions,
   K2, K4, finalize on CUDA events) and the launches, 2 keys' contexts
   exported at level 62 (``to_evaluation_contexts``, the wire format) and
   resumed on the host for levels 63 and 64 (the U128 crossing) equal, a
   context advanced per level to 62 and finished by
   ``evaluate_levels_fused`` equal; config 3's hierarchy (phase 15's keys)
   and a Tuple(Int(32), IntModN(64)) hierarchy under the heavy-hitters
   access pattern (level 0 in full, then the prefixes of the alphas and
   4,096 / 256 random leaves), every share pair reconstructing; and
   examples/heavy_hitters_demo.py's protocol at 10,000 clients (16 bits, 2
   a level, threshold 8): keys dealt, serialized and parsed with the
   port's wire format, each server's per-level ``evaluate_until_batch`` on
   the card summed over the clients, the reconstructed counts equal to the
   plaintext at every level and the heavy hitters found equal to the
   plaintext's;
18. PIR in natural order: BASELINE config 5 (2^24 records x XorWrapper(128),
   64 queries a server, key chunk 8) through ``pir_query_batch_chunked`` in
   modes levels (mode fold's path: K2, K4, the fold over the lane order), fused (K2, K4,
   ``lane_slab`` pieces against the natural order) and fold; and mode walk
   (K6, K4) on phase 4's 2^20 database; every answer reconstructs its
   record, the modes agree (walk with phase 4's fold), each mode's wall a
   batch, kernel time (torch.profiler) and peak memory printed;
19. the resilience layer: the self-test (the value hash's known answers
   through K4); bench.py's configuration (phase 3's keys) through
   ``full_domain_fold_chunks`` in modes fold and megakernel with
   ``pipeline=False`` and ``True`` in alternating passes, bit-identical
   with equal launch counts, each setting's median wall and spread, the card's busy share (torch.profiler), the telemetry
   counters and spans, and the host syncs on the path
   (``torch.cuda.set_sync_debug_mode("warn")``); phase 4's PIR through
   ``supervisor.pir_query_batch_robust(mode="megakernel")`` with the
   sentinel probe and without, pipelined and serial, every answer
   reconstructing and the probe verifying each call; a fault matrix at
   log-domain 14 and 16 keys (output corruption: megakernel/cuda degrades
   to fold/cuda; an injected ResourceExhaustedError: the chunk halves; an
   UnavailableError: a retry; a hang under a 2 s deadline: a retry), each
   equal to the host oracle with its events printed, and an Unavailable
   error or output corruption on every card rung, where the wrapper raises
   with every event on the cuda rungs (nothing but the kernels answers for
   the card); a real
   out-of-memory error at log-domain 20 (a key chunk whose measured peak
   exceeds the card, halved until it fits, the values checked against K5's
   folds and the host oracle) and a failing launch check in a child
   process; the chunk journal (a job killed after 2 of 4 groups resumes
   with the launches of the other 2 only); and
   ``evaluate_until_batch(engine="host")`` at BASELINE config 1's shape
   equal to the card. No run without an armed fault emits a retry,
   degrade or chunk-halved event;
20. the serving plane: (a) BASELINE config 5 over two server processes
   (``python -m distributed_point_functions_tpu_torch.serving.server``,
   party 0 and party 1 on loopback ports, the kernel library built here
   first): 64 queries as 16 concurrent requests of 4 through
   ``TwoServerClient``, merged by each server's batcher, every answer
   reconstructing its record, the merged widths, request latency p50 and
   p95, the wall a merged batch beside the direct calls at that width in
   this process, and the servers' launches equal to the direct robust
   calls'; (b) ``benchmarks/bench_serving.py``'s mixed stream and one
   request of each other kind (a DReLU gate, PIR on phase 4's database,
   BM_HeavyHitters' first 16 levels, 64 keys dealt at depth 20) through
   ``FrontDoor(engine="device")``: every merged batch equal to the direct
   entry-point call on the same merged batch, bit for bit, at the same
   launch counts, requests/s, p50, p95 and the batch-width histogram beside
   the same schedule served one request at a time; (c) the router's anchors
   (each op forced onto each device mode and onto the host engine, the
   dispatch prior), auto-routed batches with their decision records, and
   the learned state through a calibration file; (d) SIGTERM to one server
   with requests in flight (they finish, it reports not-ready and exits 0)
   and its restart on the same port, where the client's retry carries its
   next call bit-exact. ``python3 chip_smoke.py --phase 20`` runs the
   build and this phase alone.

Each path of the main path (fold default, fused and megakernel; PIR fold
and megakernel; EvaluateAt walk and walkkernel, and the codec walk; DCF
walk and walkkernel; heavy hitters fused and hierkernel; keygen
megakernel, perlevel and numpy-threaded at each configuration; config 3's
fused pass at each level, and its walk, slab, prepared and levels checks;
each gate's modes, the gate dealers on the card and the two layers; each
path of phases 17, 18, 19 and 20, whose servers report their launches in
their stats) runs
with every launch count set to 0
just before it, and every kernel of that path must have launched just after
it. The line before
the last is the ``{"kernels": [...]}`` JSON, the last line ``{"ok": true,
"device": ...}``. A kernel's ``ms`` there is one call of its wrapper from
the host (CUDA events around it, median after a warm-up); ``device_ms``,
for the kernels whose wrappers ``launch_ms`` times (K2-K4, K6, K7, K9),
the device time of one launch from a CUDA graph's replay, else null. Imports
nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import functools
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
import warnings

import numpy as np

SEED = 20261016
LOG_DOMAIN = 20
NUM_KEYS = 1024
KEY_CHUNK = 128
HOST_LEVELS = 5
PIR_QUERIES = 128
# EvaluateAt: BASELINE config 2 (benchmarks/bench_evaluate_at.py).
EVAL_LOG_DOMAIN = 32
EVAL_KEYS = 1024
EVAL_POINTS = 4096
ORACLE_KEYS = 4
# DCF: BASELINE config 4 (benchmarks/bench_dcf.py:24-26,41).
DCF_LOG_DOMAIN = 24
DCF_KEYS = 512
DCF_POINTS = 512
DCF_ORACLE_POINTS = 16
# Heavy hitters: BM_HeavyHitters at the top of its sweep
# (distributed_point_function_benchmark.cc:306-340 of the reference;
# benchmarks/bench_heavy_hitters.py and tests/test_hierkernel.py:271 here).
HH_LEVELS = 128
HH_NONZEROS = 10_000
HH_KEYS = 128
HH_CHUNK = 32
HH_GROUP = 16
HH_CPU_KEYS = 2
# Keygen: BM_KeyGeneration (reference distributed_point_function_benchmark.cc
# 228-260; benchmarks/bench_keygen.py:31-60 here): single-level Int(64) DPFs,
# 1024 keys, log-domains 20, 64 and 128, draws from default_rng(23); and the
# dealer of BASELINE config 4 (the DCF above: 512 keys, log-domain 24).
KG_KEYS = 1024
KG_DEPTHS = (20, 64, 128)
KG_SEED = 23
KG_WIDE_KEYS = 16384  # K9 timed at 512 lane words as well
KG_E2E_POINTS = 63  # other points besides the alphas in the end-to-end check
LEGACY_W = 8192  # benchmarks/micro_tpu.py:163, the K2 legacy kernel's width
# BASELINE config 3 (benchmarks/bench_intmodn_hierarchy.py without its smoke
# settings): an incremental DPF of 8 hierarchy levels at log-domains 3, 6,
# ..., 24, each IntModN(64, 2^64 - 59), 256 key pairs drawn from
# default_rng(3).
C3_LEVELS = 8
C3_STEP = 3
C3_KEYS = 256
C3_MODULUS = 2**64 - 59
C3_SEED = 3
# Leaves a key chunk evaluates at once (8 keys at log-domain 24, all 256 up
# to log-domain 19). The finalize's int64 limbs peak at about 170 bytes a
# leaf (the stream's four limbs, the fold's product and sum, the chain's
# compare-subtract temporaries), so a chunk stays near 22 GiB of the card's
# 80 GB. The JAX bench's 4-key chunk was a v5e memory limit.
C3_CHUNK_LEAVES = 1 << 27
C3_CPU_KEYS = 2
C3_CPU_POINTS = 16
# The codec walk of EvaluateAt: IntModN(64) keys at config 3's deepest
# log-domain. At EvaluateAt's 32 the reference's default security parameter
# (40 + 32 bits) exceeds the 66 bits that sampling mod 2^64 - 59 from one
# 128-bit block gives, and the parameters are refused.
CODEC_WALK_LOG_DOMAIN = 24
CODEC_WALK_KEYS = 64
CODEC_WALK_POINTS = 256
# FSS gates: benchmarks/bench_gates.py at its full configuration (log-group
# 16, a batch of 2048 masked inputs and 5 input sets drawn from
# default_rng(0x9A7E), fixed point at 5 fractional bits, vector payloads),
# and examples/secure_relu_demo.py's layers (default_rng(0xAC71)) at 256
# ReLU and 64 sigmoid activations.
GATE_LOG_GROUP = 16
GATE_BATCH = 2048
GATE_REPS = 5
GATE_SEED = 0x9A7E
GATE_FRAC_BITS = 5
GATE_ORACLE_INPUTS = 4
LAYER_SEED = 0xAC71
RELU_LAYER = 256
SIGMOID_LAYER = 64

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


def print_ptxas(what: str, kernels) -> None:
    """One line of what ptxas reported for `kernels`."""
    print(f"{what} ptxas: " + "; ".join(
        f"{kern.name} {kern.ptxas.get('registers')} registers, "
        f"{kern.ptxas.get('spill_stores')} B spill stores, {kern.ptxas.get('spill_loads')} B "
        f"spill loads, {kern.ptxas.get('stack_frame')} B stack frame"
        for kern in kernels))


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


def launch_ms(torch, fn, out_bytes: int, reps: int = 10):
    """(ms, device ms) of one call of a kernel's wrapper that writes
    `out_bytes`. ms, what every row's `ms` is: ``time_ms`` of one call from
    the host, the wrapper's checks, allocations and launch included, which
    set it at narrow shapes. Device ms: the call captured as many times as
    20 and 2 GiB of outputs allow in one CUDA graph, the graph's replay
    timed with CUDA events (median of 5 after a warm-up) over those calls,
    so the host's work is not in it."""
    call = time_ms(torch, fn, reps)
    launches = max(1, min(20, 2**31 // out_bytes))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    device = time_ms(torch, graph.replay, 5) / launches
    del graph
    return call, device


def planes_bytes(k: int, w: int) -> int:
    """Bytes of K keys' 128 bit-planes of W lane words (int32)."""
    return 4 * k * 128 * w


def word_source(torch, g):
    """rnd(*shape): random int32 words drawn from generator `g`, on its
    device."""

    def rnd(*shape):
        return torch.randint(
            -(2**31), 2**31 - 1, shape, dtype=torch.int32, device=g.device, generator=g
        )

    return rnd


def expand_args(rnd, k: int, w: int):
    """K2's and K3's operands for K keys of W input words: planes, control
    words, seed corrections and the two control corrections."""
    return rnd(k, 128, w), rnd(k, w), rnd(k, 128), rnd(k), rnd(k)


def k2_width_times(torch, aes_cuda, rnd, widths, hold=None):
    """{W: (ms, device ms)} of K2 (``launch_ms``) at KEY_CHUNK keys of W
    random input words, for each W of `widths`; ``hold(args)``, where
    given, checks the kernels on those operands first."""
    times = {}
    for w in widths:
        a = expand_args(rnd, KEY_CHUNK, w)
        if hold is not None:
            hold(a)
        times[w] = launch_ms(torch, lambda: aes_cuda.expand_one_level(*a),
                             planes_bytes(KEY_CHUNK, 2 * w), 10 if w < 4096 else 5)
    return times


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


# K5's tail per leaf word, besides its value hash: the 32x32 transposes (4
# groups x 5 stages x 16 pairs x 6 word operations: two shifts, an AND and
# three XORs) and, per block, the control mask (shift, AND, negate).
TRANSPOSE_OPS = 4 * 5 * 16 * 6
CONTROL_MASK_OPS = 3


def masked_mmo_gates(key_planes) -> int:
    """The MMO hash with the PRG key selected per lane (K6, K7). Per round-key
    plane the key bit is left ^ ((left ^ right) & mask): no gate where both
    keys are 0, one where either is 1 (NOT where both are, XOR with the mask
    where only the right is, XNOR where only the left is). `left_or_right`
    counts the planes where either key is 1."""
    return mmo_gates(0) + key_planes["left_or_right"]


# One walk level per lane word besides the hash: the seed correction (cw &
# c, XOR: 256), the per-lane control correction ccl ^ ((ccl ^ ccr) & path)
# (AND, XOR: ccl ^ ccr is per key) and the control update (AND, XOR).
WALK_LEVEL_EXTRA = 2 * 128 + 4


def walk_level_cost(key_planes, k: int, w: int):
    """(bytes, gates) of K6 on K keys of W words: planes and control in
    and out, the path word, the key's tables."""
    nbytes = 4 * (2 * k * 128 * w + 2 * k * w + w + k * 128 + 2 * k)
    return nbytes, k * w * (masked_mmo_gates(key_planes) + WALK_LEVEL_EXTRA)


def walk_megakernel_cost(key_planes, k: int, w: int, levels: int, bits: int, keep: int,
                         party: int, xor_group: bool, captures=None):
    """(bytes, gates) of K7 on K keys of W words: every level of the walk
    per lane word (L masked hashes), then each capture: the value hash, the
    transposes, and per point the control mask, each kept element's select
    mask, and per kept limb the gate (AND), the correction (XOR; or add with
    carry, 3, and for party 1 of the EvaluateAt form the negation, 3 more),
    the select (AND) and the XOR over elements. The EvaluateAt form
    (``captures=None``) captures the leaves once; the DCF form once per
    flagged depth, and adds the captures (per limb and point an add with
    carry, 3, or an XOR), party 1 negating the sum once (3 per limb).
    Bytes: the seed planes, path words, key tables, corrections and select
    words read once, the value rows written once."""
    lpe = bits // 32
    walk = levels * (masked_mmo_gates(key_planes) + WALK_LEVEL_EXTRA)
    negate = 3 if party and not xor_group else 0
    n = 1 if captures is None else sum(bool(f) for f in captures)
    per_limb = 1 + (1 if xor_group else 3) + 1 + 1
    if captures is None:
        per_limb += negate
    per_capture = (mmo_gates(key_planes["value"]) + TRANSPOSE_OPS
                   + 32 * (CONTROL_MASK_OPS + keep * (CONTROL_MASK_OPS + lpe * per_limb)))
    per_word = walk + n * per_capture
    corr_words, sel_words = k * 4, keep * w
    if captures is not None:
        per_word += 32 * lpe * ((n - 1) * (1 if xor_group else 3) + negate)
        corr_words = k * (levels + 1) * keep * lpe
        sel_words = (levels + 1) * keep * w
    nbytes = 4 * (k * 128 + levels * w + k * levels * 130 + corr_words + sel_words
                  + k * lpe * 32 * w)
    return nbytes, k * w * per_word


def hier_megakernel_cost(key_planes, k: int, segments, hot: int, entry_read: int, wp: int,
                         n_rows: int, state_cap: int, bits: int, keep: int, party: int,
                         xor_group: bool):
    """(bytes, gates) of K8's function on K keys and one window of W words,
    counted at what this window's inputs need, whatever implements it: per
    (segment, lane word) one masked walk hash and the walk's other
    operations per tree level it advances from its parent (each tree node
    is reached once, from its parent; ``segments`` holds (base, lanes,
    depth, levels_d)); then per (capture slot, word) that the select rows
    make hot (`hot` of them, counted from this window's tables) the value
    hash, the transposes, and per lane the control mask, each kept
    element's select mask, and per kept limb the gate (AND), the
    correction (XOR; or add with carry, 3, and for party 1 the negation, 3
    more), the select (AND) and the placement (XOR). Bytes: the entry lanes
    that segment 0 reads (`entry_read` a key: 16 B of seed and 4 of
    control), the tables (parent, path and select words, key tables,
    corrections) read once; the value rows and the exit state written
    once."""
    lpe = bits // 32
    walk = sum((-(-(b + n) // 32) - b // 32) * ld for b, n, _, ld in segments)
    per_limb = 1 + (1 if xor_group else 3 + (3 if party else 0)) + 1 + 1
    per_capture = (mmo_gates(key_planes["value"]) + TRANSPOSE_OPS
                   + 32 * (CONTROL_MASK_OPS + keep * (CONTROL_MASK_OPS + lpe * per_limb)))
    gates = k * (walk * (masked_mmo_gates(key_planes) + WALK_LEVEL_EXTRA) + hot * per_capture)
    levels = segments[-1][2]
    nbytes = 4 * (k * 5 * entry_read + 32 * wp + levels * wp + n_rows * wp
                  + k * levels * 130 + k * n_rows * lpe + k * keep * lpe * 32 * wp
                  + k * 5 * state_cap)
    return nbytes, gates


# One dealer level per lane word besides its four hashes, per plane: for
# each party both children from the two hashes by the alpha bit (d = hl ^
# hr, lose = hl ^ (d & path), keep = lose ^ d: 4), sc = lose0 ^ lose1 (1),
# and each party's new seed keep ^ (sc & c) (2 each); and ~20 operations of
# control-bit algebra.
KEYGEN_LEVEL_EXTRA = 128 * (2 * 4 + 1 + 2 * 2) + 20


# K9's per-warp issue floor. Its levels are a serial chain, and each of a
# key word's 16 column threads runs one column hash a level: ~10 rounds of
# the column round loop's 449 instructions (sass_mix.py), and ~300
# more for the children's selects, sc, the corrections and the 68 shuffles
# of the exchanges; a capture one more hash and sigma's 32-word inverse. A
# warp issues at most one instruction a clock.
COLUMN_HASH_INSTRUCTIONS = 10 * 449
KEYGEN_LEVEL_INSTRUCTIONS = COLUMN_HASH_INSTRUCTIONS + 300
KEYGEN_CAPTURE_INSTRUCTIONS = COLUMN_HASH_INSTRUCTIONS + 64
SM_CLOCK_HZ = 1.98e9


def keygen_warp_floor_ms(levels: int, slots: int) -> float:
    """The least time one warp of K9 takes at one instruction a clock."""
    issued = levels * KEYGEN_LEVEL_INSTRUCTIONS + slots * KEYGEN_CAPTURE_INSTRUCTIONS
    return issued / SM_CLOCK_HZ * 1e3


def keygen_megakernel_cost(key_planes, w: int, levels: int, slots: int):
    """(bytes, gates) of K9 on W lane words of keys: per level and party the
    left and the right MMO hash, the selects and corrections; per capture
    and party one value hash. Bytes: both parties' seed planes and the path
    words read once; the correction planes, control corrections, value
    hashes and control rows written once."""
    per_word = (levels * (2 * (mmo_gates(key_planes["left"]) + mmo_gates(key_planes["right"]))
                          + KEYGEN_LEVEL_EXTRA)
                + slots * 2 * mmo_gates(key_planes["value"]))
    nbytes = 4 * w * (2 * 128 + levels + levels * 130 + slots * 257)
    return nbytes, w * per_word


def megakernel_cost(key_planes, plan, k: int, bits: int, keep: int, party: int,
                    xor_group: bool, with_db: bool):
    """(bytes, gates) of K5 on K keys under `plan`: every child word hashes
    once under its child's PRG key, with the seed correction and control
    update (258); every leaf word hashes once under the value key, is
    transposed, and each kept limb of each block is gated (AND), corrected
    (XOR; or add with carry, 3, and for party 1 the negation, 3 more),
    masked by the database (AND) and folded (XOR). Bytes: the entry tile,
    the correction tables and the database read once, the output written
    once."""
    lpe = bits // 32
    levels = plan.levels_a + plan.levels_b
    child_words = (2 * (plan.mid_words - plan.entry_words)
                   + plan.num_slabs * 2 * (plan.final_words - plan.slab_words))
    leaf_words = plan.num_slabs * plan.final_words
    per_child = (mmo_gates(key_planes["left"]) + mmo_gates(key_planes["right"])) / 2 + 2 * 128 + 2
    per_limb = 1 + (1 if xor_group else 3 + (3 if party else 0)) + (1 if with_db else 0) + 1
    per_leaf = (mmo_gates(key_planes["value"]) + TRANSPOSE_OPS
                + 32 * (keep * lpe * per_limb + CONTROL_MASK_OPS))
    gates = k * (child_words * per_child + leaf_words * per_leaf)
    nbytes = 4 * (k * (129 * plan.entry_words + levels * 130 + 4 + lpe * plan.fold_words)
                  + (keep * lpe * 32 * leaf_words if with_db else 0))
    return nbytes, gates


def sample_value(vt, rng):
    """A random host value of the port's value type `vt`."""
    if hasattr(vt, "elements"):
        return tuple(sample_value(e, rng) for e in vt.elements)
    bound = vt.modulus if hasattr(vt, "modulus") else 1 << vt.bitsize
    return int.from_bytes(rng.bytes(16), "little") % bound


def k5_probe(torch, args, kw, k: int, ms: float, dev, what: str) -> None:
    """Timing only: K5 at the blocks a key the wrapper chooses (`ms`, two
    blocks an SM) against one block a key (the grid K5 had before it was
    split: one block an SM), so the two gains of its redesign, filled word
    rounds and occupancy, show apart."""
    from distributed_point_functions_tpu_torch.ops import aes_cuda

    blocks = aes_cuda.megakernel_blocks_per_key(kw["plan"], kw["bits"], k, dev)
    one_ms = time_ms(torch, lambda: aes_cuda.megakernel_fold(*args, **kw, blocks_per_key=1), 5)
    again_ms = time_ms(torch, lambda: aes_cuda.megakernel_fold(*args, **kw), 5)
    print(f"K5 probe at K={k}, {what} (timing only): {blocks} blocks a key {ms:.4f} / "
          f"{again_ms:.4f} ms, one block a key {one_ms:.4f} ms")


# -- phases 17 and 18, functions so that a CPU rehearsal can call them at tiny
# sizes (device "cpu", the kernels' plain versions) ---------------------------

# Phase 17: the EvaluationContext API. BASELINE config 1
# (BASELINE.md: one XorWrapper(128) key pair at log-domain 20);
# BM_IsrgExampleHierarchy (reference
# dpf/distributed_point_function_benchmark.cc:182-222, benchmarks/bench_isrg.py:
# Int(32) at log-domains 12 and 25, 32 prefixes from default_rng(13));
# BM_HeavyHitters level by level (phase 10's configuration); config 3's
# hierarchy under the heavy-hitters access pattern; and
# examples/heavy_hitters_demo.py's protocol at 10,000 clients.
PHASE17 = dict(
    c1_log_domain=20, c1_points=4096,
    isrg_domains=(12, 25), isrg_nonzeros=32, isrg_key_draws=6, isrg_points=256,
    hh_split=63, hh_export_keys=2,
    c3_random_leaves=4096, tuple_domains=(4, 8, 12, 16), tuple_keys=64,
    demo_bits=16, demo_bits_per_level=2, demo_clients=10_000, demo_threshold=8,
)
# Phase 18: PIR in natural order. BASELINE config 5 (2^24 records x
# XorWrapper(128), 64 queries a server) on one card at a key chunk of 8, and
# mode walk on phase 4's 2^20 database.
PHASE18 = dict(c5_log_domain=24, c5_queries=64, c5_chunk=8, walk_chunk=64)


def sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def reset_peak(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()


def peak_gib(torch, dev) -> float:
    return torch.cuda.max_memory_allocated() / 2**30 if dev.type == "cuda" else 0.0


def device_busy_ms(torch, dev, fn):
    """The card's kernel time over one call of `fn` (torch.profiler, the
    device time of every kernel summed), or None where the profiler shows
    none (or on the CPU)."""
    if dev.type != "cuda":
        fn()
        return None
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    from torch.autograd import DeviceType

    # The kernels' own events: a CPU operator's entry repeats the device
    # time of the kernels it launched.
    total = sum(
        getattr(evt, "self_device_time_total", getattr(evt, "self_cuda_time_total", 0))
        for evt in prof.key_averages() if evt.device_type == DeviceType.CUDA)
    return total / 1e3 if total > 0 else None


class PathCounts:
    """Runs each path of a phase with every launch count set to 0 just before
    it and checks just after it that each of its kernels launched and no
    other did; tallies the launches by kernel."""

    def __init__(self, aes_cuda, launches: bool = True):
        self.aes_cuda = aes_cuda
        self.check = launches
        self.total = {k.name: 0 for k in aes_cuda.KERNELS}

    def start(self) -> None:
        self.aes_cuda.reset_launch_counts()

    def end(self, what: str, need) -> dict:
        counts = {k.name: k.launches for k in self.aes_cuda.KERNELS}
        if self.check:
            missing = [k.name for k in need if counts[k.name] == 0]
            extra = [n for n, c in counts.items() if c and n not in {k.name for k in need}]
            if missing or extra:
                fail(f"{what}: launches {counts}; expected {[k.name for k in need]} only")
        for n, c in counts.items():
            self.total[n] += c
        return {n: c for n, c in counts.items() if c}


def limbs_of_ints(values, lpe: int):
    """Python ints -> uint32[n, lpe] little-endian limbs."""
    raw = b"".join(int(v).to_bytes(4 * lpe, "little") for v in values)
    return np.frombuffer(raw, dtype=np.uint32).reshape(-1, lpe)


def prefix_ints(prefixes) -> list:
    """A plan's prefix array (uint64 or U128) as Python ints."""
    from distributed_point_functions_tpu_torch.core import uint128

    if isinstance(prefixes, np.ndarray) and prefixes.dtype == uint128.U128:
        return uint128.u128_to_ints(prefixes)
    return [int(p) for p in prefixes]


def modn_sum(a: np.ndarray, b: np.ndarray, modulus: int) -> np.ndarray:
    """(a + b) mod N of residues uint64 < N < 2^64, without overflow."""
    s = a + b
    wrapped = s < a
    return np.where(wrapped, s + np.uint64((1 << 64) - modulus),
                    np.where(s >= np.uint64(modulus), s - np.uint64(modulus), s))


def phase_17(torch, T, dev, hh, c3, cfg, counts: PathCounts) -> None:
    """The EvaluationContext API at full width, both parties (module
    docstring, phase 17). `hh`: phase 10's DPF, keys, plan and mode fused's
    outputs a party; `c3`: phase 15's DPF, keys, alphas, betas and
    log-domains."""
    from distributed_point_functions_tpu_torch.ops import (
        aes_cuda, aes_torch, evaluator, hierarchical, value_codec,
    )
    from distributed_point_functions_tpu_torch.ops.backend_torch import TorchBackend
    from distributed_point_functions_tpu_torch.protos import serialization as ser

    K2, K4, K6 = aes_cuda.K2, aes_cuda.K4, aes_cuda.K6
    rng = np.random.default_rng(SEED + 17)

    def until(ctx, level, prefixes=(), timings=None, device_output=False):
        return hierarchical.evaluate_until_batch(ctx, level, prefixes, device=dev,
                                                 timings=timings, device_output=device_output)

    def steps(t) -> str:
        return ", ".join(f"{k} {v * 1e3:.2f}" for k, v in t.items() if not k.endswith("_card")) \
            + "; card " + ", ".join(f"{k[:-5]} {v * 1e3:.3f}" for k, v in t.items()
                                    if k.endswith("_card"))

    # -- 17a. BASELINE config 1: one XorWrapper(128) key pair, log-domain 20.
    lds = cfg["c1_log_domain"]
    params = [T.DpfParameters(lds, T.XorWrapper(128))]
    c1 = T.DistributedPointFunction.create_incremental(params)
    alpha = int(rng.integers(0, 1 << lds))
    beta = int.from_bytes(rng.bytes(16), "little") | 1
    (k0,), (k1,) = c1.generate_keys_batch(
        [alpha], [[beta]], seeds=rng.integers(0, 2**32, size=(1, 2, 4), dtype=np.uint32))
    shares, walls = [], []
    counts.start()
    for key in (k0, k1):
        t = {}
        sync(torch, dev)
        t0 = time.perf_counter()
        shares.append(until(hierarchical.BatchedContext.create(c1, [key]), 0, timings=t)[0])
        walls.append(time.perf_counter() - t0)
        if key is k0:
            c1_steps = steps(t)
    c1_launches = counts.end("config 1 through evaluate_until_batch", (K2, K4))
    rec = shares[0] ^ shares[1]
    want = np.zeros_like(rec)
    want[alpha] = limbs_of_ints([beta], 4)[0]
    if not np.array_equal(rec, want):
        fail(f"config 1: {int((rec != want).any(axis=1).sum())} shares do not XOR to beta at "
             "alpha and 0 elsewhere")
    ct = T.DistributedPointFunction.create_incremental(params, backend=TorchBackend(dev))
    counts.start()
    t0 = time.perf_counter()
    host_vals = ct.evaluate_until(0, [], ct.create_evaluation_context(k0))
    host_s = time.perf_counter() - t0
    tb_launches = counts.end("config 1 through the host evaluate_until on TorchBackend",
                             (K2, K4))
    if not np.array_equal(limbs_of_ints(host_vals, 4), shares[0]):
        fail("config 1: the host evaluate_until on TorchBackend differs from the batched path")
    del host_vals
    pts = sorted({alpha} | {int(x) for x in rng.integers(0, 1 << lds, size=cfg["c1_points"] - 1)})
    t0 = time.perf_counter()
    numpy_vals = c1.evaluate_at(k0, 0, pts)
    numpy_s = time.perf_counter() - t0
    if not np.array_equal(limbs_of_ints(numpy_vals, 4), shares[0][pts]):
        fail("config 1: the numpy host evaluate_at differs from the card")
    print(f"phase 17, config 1 (XorWrapper(128), log-domain {lds}, one key pair): "
          f"evaluate_until_batch {walls[0] * 1e3:.1f} / {walls[1] * 1e3:.1f} ms a party = "
          f"{(1 << lds) / walls[0]:.4e} evals/s (party 0 steps, ms: {c1_steps}); launches "
          f"{c1_launches}; the shares XOR to beta at alpha, 0 elsewhere; the host "
          f"evaluate_until on TorchBackend equals it ({host_s:.2f} s, launches {tb_launches}); "
          f"the numpy host evaluate_at equals it at {len(pts)} points ({numpy_s:.2f} s)")
    del shares, rec, want

    # -- 17b. BM_IsrgExampleHierarchy.
    lds0, lds1 = cfg["isrg_domains"]
    irng = np.random.default_rng(13)
    draws = irng.integers(0, 1 << lds1, size=cfg["isrg_key_draws"])
    iprefixes = [int(p) for p in np.unique(
        irng.integers(0, 1 << lds0, size=cfg["isrg_nonzeros"]).astype(np.uint64))]
    # The key's alpha under the first prefix, so that the level-1 check sees
    # a nonzero; its low bits from the benchmark's first key draw.
    ialpha = (iprefixes[0] << (lds1 - lds0)) | (int(draws[0]) & ((1 << (lds1 - lds0)) - 1))
    iparams = [T.DpfParameters(lds0, T.Int(32)), T.DpfParameters(lds1, T.Int(32))]
    idpf = T.DistributedPointFunction.create_incremental(iparams)
    ikeys = idpf.generate_keys_batch(
        [ialpha], [[1], [1]], seeds=rng.integers(0, 2**32, size=(1, 2, 4), dtype=np.uint32))
    iout, iwall = [], []
    counts.start()
    for party in (0, 1):
        ctx = hierarchical.BatchedContext.create(idpf, ikeys[party])
        sync(torch, dev)
        t0 = time.perf_counter()
        o0 = until(ctx, 0)[0, :, 0]
        t1 = time.perf_counter()
        o1 = until(ctx, 1, iprefixes)[0, :, 0]
        t2 = time.perf_counter()
        iout.append((o0, o1))
        iwall.append((t1 - t0, t2 - t1))
    isrg_launches = counts.end("BM_IsrgExampleHierarchy through evaluate_until_batch", (K2, K4))
    span = 1 << (lds1 - lds0)
    col1 = iprefixes.index(ialpha >> (lds1 - lds0)) * span + (ialpha & (span - 1))
    for level, col in ((0, ialpha >> (lds1 - lds0)), (1, col1)):
        total = (iout[0][level].astype(np.uint64) + iout[1][level]) & np.uint64(0xFFFFFFFF)
        want = np.zeros_like(total)
        want[col] = 1
        if not np.array_equal(total, want):
            fail(f"BM_IsrgExampleHierarchy level {level}: the shares do not reconstruct")
    t0 = time.perf_counter()
    for party in (0, 1):
        hctx = idpf.create_evaluation_context(ikeys[party][0])
        for level, pre in ((0, []), (1, iprefixes)):
            if not np.array_equal(np.array(idpf.evaluate_next(pre, hctx), np.uint32),
                                  iout[party][level]):
                fail(f"BM_IsrgExampleHierarchy level {level}: the numpy host evaluate_next "
                     f"differs from the card (party {party})")
    ihost_s = time.perf_counter() - t0
    itorch = T.DistributedPointFunction.create_incremental(iparams, backend=TorchBackend(dev))
    ipts = sorted({(iprefixes[int(i)] << (lds1 - lds0)) | int(x) for i, x in zip(
        rng.integers(0, len(iprefixes), size=cfg["isrg_points"]),
        rng.integers(0, span, size=cfg["isrg_points"]))})
    cols = [iprefixes.index(p >> (lds1 - lds0)) * span + (p & (span - 1)) for p in ipts]
    counts.start()
    key = ikeys[0][0]
    actx = itorch.create_evaluation_context(key)
    if itorch.evaluate_next([], actx) != [int(x) for x in iout[0][0]]:
        fail("BM_IsrgExampleHierarchy: evaluate_next on TorchBackend differs from the card")
    at_vals = itorch.evaluate_at(key, 1, ipts, ctx=actx)
    at_launches = counts.end("evaluate_next and evaluate_at(ctx=) on TorchBackend", (K2, K4, K6))
    if at_vals != [int(x) for x in iout[0][1][cols]] or actx.previous_hierarchy_level != 1:
        fail("BM_IsrgExampleHierarchy: evaluate_at(ctx=) on TorchBackend differs from the card")
    n_out = (1 << lds0) + len(iprefixes) * span
    print(f"phase 17, BM_IsrgExampleHierarchy (Int(32), log-domains {lds0} and {lds1}, "
          f"{len(iprefixes)} prefixes, one key pair): level 0 {iwall[0][0] * 1e3:.2f} / "
          f"{iwall[1][0] * 1e3:.2f} ms, level 1 {iwall[0][1] * 1e3:.2f} / "
          f"{iwall[1][1] * 1e3:.2f} ms (parties 0 / 1) = "
          f"{n_out / sum(iwall[0]):.4e} outputs/s; launches {isrg_launches}; the shares "
          f"reconstruct at both levels; the numpy host evaluate_next equals the card at both "
          f"levels ({ihost_s:.2f} s, both parties); on TorchBackend evaluate_next and "
          f"evaluate_at(key, 1, {len(ipts)} points, ctx=ctx) equal it (launches {at_launches})")
    del iout

    # -- 17c. BM_HeavyHitters level by level.
    hdpf, hkeys, hplan, hfused = hh["dpf"], hh["keys"], hh["plan"], hh["fused"]
    levels = len(hplan)
    split = cfg["hh_split"]
    nkeys = len(hkeys[0])
    per_level = []
    exported = None
    counts.start()
    hh_walls = []
    for party in (0, 1):
        ctx = hierarchical.BatchedContext.create(hdpf, hkeys[party])
        sync(torch, dev)
        t_party = time.perf_counter()
        for h, prefixes in hplan:
            t = {} if party == 0 else None
            before = (K2.launches, K4.launches)
            t0 = time.perf_counter()
            got = until(ctx, h, prefixes, timings=t)
            wall = time.perf_counter() - t0
            level_launches = (K2.launches - before[0], K4.launches - before[1])
            if not np.array_equal(got, hfused[party][h]):
                fail(f"heavy hitters level by level: level {h} (party {party}) differs from "
                     "evaluate_levels_fused(mode='fused')")
            if party == 0:
                per_level.append((h, wall, t, got.shape[1], level_launches))
                if h == split - 1:
                    exported = [ser.serialize_evaluation_context(x) for x in
                                ctx.to_evaluation_contexts(range(cfg["hh_export_keys"]))]
        hh_walls.append(time.perf_counter() - t_party)
    hh_launches = counts.end("heavy hitters through evaluate_until_batch", (K2, K4))
    hh_values = sum(p[3] for p in per_level)
    for h, wall, t, n, (n2, n4) in per_level:
        print(f"  hh level {h}: {n} values a key, K2 x {n2}, K4 x {n4}, wall {wall * 1e3:.2f} ms; ms: "
              f"keys {t.get('keys', 0) * 1e3:.2f}, positions {t.get('positions', 0) * 1e3:.2f}, "
              f"compact {t.get('compact_card', 0) * 1e3:.3f}, K2 "
              f"{t.get('expand_card', t.get('expand', 0)) * 1e3:.3f}, K4 "
              f"{t.get('hash_card', t.get('hash', 0)) * 1e3:.3f}, finalize "
              f"{t.get('finalize_card', t.get('finalize', 0)) * 1e3:.3f}, pull "
              f"{t.get('pull', 0) * 1e3:.2f}")
    sums = {k: sum(p[2].get(k, 0.0) for p in per_level) * 1e3 for k in (
        "keys", "positions", "tables", "expand_card", "compact_card", "hash_card",
        "finalize_card", "state_card", "select", "pull")}
    print(f"phase 17, heavy hitters level by level ({nkeys} keys x {hh_values} values a party, "
          f"{levels} evaluate_until_batch calls a party): {hh_walls[0]:.3f} / {hh_walls[1]:.3f} "
          f"s (parties 0 / 1; party 0 with a synchronizing clock a step) = "
          f"{nkeys * hh_values / hh_walls[1]:.4e} values/s (party 1); party 0's steps summed, "
          "ms: " + ", ".join(f"{k} {v:.1f}" for k, v in sums.items())
          + f"; launches {hh_launches}; every level equals phase 10's evaluate_levels_fused "
          "(mode fused) bit for bit")
    # The U128 crossing: exported contexts resumed on the host API.
    for i, raw in enumerate(exported):
        hctx = ser.parse_evaluation_context(raw)
        for h in (split, split + 1):
            got = hdpf.evaluate_next(prefix_ints(hplan[h][1]), hctx)
            want = [int(x) for x in evaluator.values_to_numpy(hfused[0][h][i], 64)]
            if got != want:
                fail(f"heavy hitters: key {i}'s context exported at level {split - 1} and "
                     f"resumed on the host differs from the card at level {h}")
    # A context advanced per level to split - 1, finished by the fused path.
    counts.start()
    ctx = hierarchical.BatchedContext.create(hdpf, hkeys[0])
    for h, prefixes in hplan[:split]:
        until(ctx, h, prefixes, device_output=True)
    rest = hierarchical.evaluate_levels_fused(ctx, hplan[split:], mode="fused", device=dev)
    mixed_launches = counts.end("heavy hitters, per level then fused", (K2, K4))
    if not all(np.array_equal(a, b) for a, b in zip(rest, hfused[0][split:])):
        fail(f"heavy hitters: a context advanced per level to level {split - 1} and finished "
             "by evaluate_levels_fused differs from the per-level run")
    print(f"phase 17, heavy hitters: {len(exported)} keys' contexts after level {split - 1} "
          f"(to_evaluation_contexts, serialize, parse) resumed for levels {split} and "
          f"{split + 1} on the host equal the card; per level to {split - 1} then "
          f"evaluate_levels_fused equals the per-level run (launches {mixed_launches})")
    del rest, ctx

    # -- 17d. Config 3's hierarchy under the heavy-hitters access pattern.
    def pruned_run(dpf, keys, leaves, domains):
        """Level 0 in full, then each level under the unique prefixes of
        `leaves` (the alphas and random leaves: the heavy-hitters access
        pattern); both parties. Returns per level (prefix list, [party 0,
        party 1] outputs, walls)."""
        runs = []
        ctxs = [hierarchical.BatchedContext.create(dpf, keys[p]) for p in (0, 1)]
        prefixes = []
        for level, d in enumerate(domains):
            if level:
                prefixes = sorted({x >> (domains[-1] - domains[level - 1]) for x in leaves})
            outs, walls = [], []
            for ctx in ctxs:
                sync(torch, dev)
                t0 = time.perf_counter()
                outs.append(until(ctx, level, prefixes))
                walls.append(time.perf_counter() - t0)
            runs.append((prefixes, outs, walls))
        return runs

    def target_cols(prefixes, alphas, domains, level):
        shift = domains[-1] - domains[level]
        if not level:
            return [a >> shift for a in alphas]
        span = domains[level] - domains[level - 1]
        return [prefixes.index(a >> (shift + span)) * (1 << span) + ((a >> shift) & ((1 << span) - 1))
                for a in alphas]

    modulus = c3["dpf"].validator.parameters[0].value_type.modulus
    counts.start()
    c3leaves = c3["alphas"] + [int(x) for x in np.random.default_rng(3).integers(
        0, 1 << c3["domains"][-1], size=cfg["c3_random_leaves"])]
    c3runs = pruned_run(c3["dpf"], c3["keys"], c3leaves, c3["domains"])
    c3_launches = counts.end("config 3's hierarchy through evaluate_until_batch", (K2, K4))
    rows_k = np.arange(len(c3["alphas"]))
    for level, (prefixes, (a, b), _) in enumerate(c3runs):
        total = modn_sum(evaluator.values_to_numpy(a, 64), evaluator.values_to_numpy(b, 64),
                         modulus)
        cols = target_cols(prefixes, c3["alphas"], c3["domains"], level)
        if not np.array_equal(total[rows_k, cols],
                              np.array([c3["betas"][level][i] for i in rows_k], np.uint64)):
            fail(f"config 3 pruned, level {level}: the shares at alpha's prefix do not "
                 "reconstruct beta")
        total[rows_k, cols] = 0
        if total.any():
            fail(f"config 3 pruned, level {level}: {int((total != 0).sum())} share pairs "
                 "are not 0 off alpha's prefix")
    c3_line = "; ".join(f"level {lv}: {len(p) or 1} prefixes, {a.shape[1]} values a key, "
                        f"{w[0] * 1e3:.1f} / {w[1] * 1e3:.1f} ms"
                        for lv, (p, (a, _), w) in enumerate(c3runs))
    print(f"phase 17, config 3's hierarchy pruned ({len(c3['alphas'])} keys, IntModN(64, "
          f"2^64 - 59), a level under the prefixes of the alphas and "
          f"{cfg['c3_random_leaves']} random leaves): {c3_line}; launches {c3_launches}; (r0 + r1) mod N is beta at alpha's "
          "prefix and 0 elsewhere at every level")
    del c3runs
    # The tuple arm: Tuple(Int(32), IntModN(64)) at a smaller size.
    tdomains = cfg["tuple_domains"]
    tvt = T.TupleType(T.Int(32), T.IntModN(64, C3_MODULUS))
    tdpf = T.DistributedPointFunction.create_incremental(
        [T.DpfParameters(d, tvt) for d in tdomains])
    trng = np.random.default_rng(4)
    talphas = [int(x) for x in trng.integers(0, 1 << tdomains[-1], size=cfg["tuple_keys"])]
    tbetas = [[(int(trng.integers(1, 2**32)), int(trng.integers(1, 2**62)))
               for _ in talphas] for _ in tdomains]
    tkeys = tdpf.generate_keys_batch(
        talphas, tbetas,
        seeds=trng.integers(0, 2**32, size=(len(talphas), 2, 4), dtype=np.uint32))
    counts.start()
    tleaves = talphas + [int(x) for x in trng.integers(0, 1 << tdomains[-1], size=256)]
    truns = pruned_run(tdpf, tkeys, tleaves, tdomains)
    t_launches = counts.end("the tuple hierarchy through evaluate_until_batch", (K2, K4))
    trows = np.arange(len(talphas))
    for level, (prefixes, (a, b), _) in enumerate(truns):
        cols = target_cols(prefixes, talphas, tdomains, level)
        s32 = (a[0][..., 0].astype(np.uint64) + b[0][..., 0]) & np.uint64(0xFFFFFFFF)
        smod = modn_sum(evaluator.values_to_numpy(a[1], 64), evaluator.values_to_numpy(b[1], 64),
                        C3_MODULUS)
        for comp, total in enumerate((s32, smod)):
            want = np.zeros_like(total)
            want[trows, cols] = [tbetas[level][i][comp] for i in trows]
            if not np.array_equal(total, want):
                fail(f"tuple hierarchy level {level}: component {comp} does not reconstruct")
        if level == 0:
            cctx = hierarchical.BatchedContext.create(tdpf, tkeys[0][:2])
            cpu_ctx_out = hierarchical.evaluate_until_batch(cctx, 0, device="cpu")
            if not all(np.array_equal(x[:2], y) for x, y in zip(a, cpu_ctx_out)):
                fail("tuple hierarchy: the CPU path differs from the card at level 0")
    print(f"phase 17, Tuple(Int(32), IntModN(64)) hierarchy at log-domains {tdomains}, "
          f"{len(talphas)} keys, the prefixes of the alphas and 256 random leaves: launches {t_launches}; both "
          "components reconstruct at every level; the CPU path equals the card at level 0")
    del truns

    # -- 17e. examples/heavy_hitters_demo.py's protocol (HH_MODE=host flow).
    bits, bpl = cfg["demo_bits"], cfg["demo_bits_per_level"]
    nclients, threshold = cfg["demo_clients"], cfg["demo_threshold"]
    drng = np.random.default_rng(2026)
    heavy = [0xBEEF, 0x1234, 0xC0DE]
    values = []
    for hv in heavy:
        values += [hv & ((1 << bits) - 1)] * (threshold + int(drng.integers(0, 5)))
    while len(values) < nclients:
        values.append(int(drng.integers(0, 1 << bits)))
    drng.shuffle(values)
    values = values[:nclients]
    true_counts = collections.Counter(values)
    want_hh = sorted(v for v, c in true_counts.items() if c >= threshold)
    dparams = [T.DpfParameters(d, T.Int(64)) for d in range(bpl, bits + 1, bpl)]
    ddpf = T.DistributedPointFunction.create_incremental(dparams)
    nlev = len(dparams)
    t0 = time.perf_counter()
    dk0, dk1 = ddpf.generate_keys_batch(
        values, [[1] * nclients] * nlev,
        seeds=drng.integers(0, 2**32, size=(nclients, 2, 4), dtype=np.uint32))
    wire = [[ser.serialize_dpf_key(k, dparams) for k in ks] for ks in (dk0, dk1)]
    deal_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    server_keys = [[ser.parse_dpf_key(b) for b in w] for w in wire]
    parse_s = time.perf_counter() - t0
    key_bytes = sum(len(b) for b in wire[0]) / nclients
    del dk0, dk1, wire
    ctxs = [hierarchical.BatchedContext.create(ddpf, ks) for ks in server_keys]
    prefixes = []
    demo_levels = []
    counts.start()
    sync(torch, dev)
    t_all = time.perf_counter()
    for level in range(nlev):
        aggs, walls = [], []
        for ctx in ctxs:
            t0 = time.perf_counter()
            v = until(ctx, level, prefixes, device_output=True)
            # Each server sums its shares over the clients, mod 2^64, limb by limb.
            lo = value_codec.unsigned(v[..., 0]).sum(dim=0).tolist()
            hi = value_codec.unsigned(v[..., 1]).sum(dim=0).tolist()
            aggs.append([(x + (y << 32)) % (1 << 64) for x, y in zip(lo, hi)])
            walls.append(time.perf_counter() - t0)
            del v
        counts_l = [(a + b) % (1 << 64) for a, b in zip(*aggs)]
        cand = hierarchical.candidate_children(prefixes, level * bpl, (level + 1) * bpl)
        shift = bits - (level + 1) * bpl
        plain = collections.Counter(x >> shift for x in values)
        if counts_l != [plain.get(int(c), 0) for c in cand]:
            fail(f"heavy-hitters demo level {level}: the reconstructed counts differ from the "
                 "plaintext")
        prefixes = [int(cand[i]) for i, c in enumerate(counts_l) if c >= threshold]
        demo_levels.append((len(cand), len(prefixes), walls))
        if not prefixes:
            break
    sync(torch, dev)
    demo_s = time.perf_counter() - t_all
    demo_launches = counts.end("the heavy-hitters demo through evaluate_until_batch", (K2, K4))
    if sorted(prefixes) != want_hh:
        fail(f"heavy-hitters demo: found {[hex(v) for v in prefixes]}, the plaintext count "
             f"gives {[hex(v) for v in want_hh]}")
    print(f"phase 17, the heavy-hitters demo's protocol ({nclients} clients, {bits} bits, "
          f"{bpl} a level, threshold {threshold}): dealer keygen + serialize {deal_s:.2f} s "
          f"({key_bytes:.0f} B a key), parse {parse_s:.2f} s a pair of servers; aggregation "
          f"{demo_s:.2f} s: " + "; ".join(
              f"level {i}: {c} candidates -> {s}, {w[0] * 1e3:.0f} / {w[1] * 1e3:.0f} ms"
              for i, (c, s, w) in enumerate(demo_levels))
          + f"; launches {demo_launches}; found {[hex(v) for v in prefixes]} = the plaintext "
          "count's heavy hitters, and every level's counts equal the plaintext")


def phase_18(torch, T, dev, p4, cfg, counts: PathCounts) -> None:
    """PIR in natural order (module docstring, phase 18). `p4`: phase 4's
    DPF, database, query targets, keys and mode fold's answers."""
    from distributed_point_functions_tpu_torch.ops import aes_cuda
    from distributed_point_functions_tpu_torch.parallel import pir

    K2, K4, K6 = aes_cuda.K2, aes_cuda.K4, aes_cuda.K6
    need = {"levels": (K2, K4), "fused": (K2, K4), "fold": (K2, K4), "walk": (K6, K4)}

    def run_mode(what, dpf, keys, pdb, mode, chunk):
        """Both parties' answers in one mode, timed: wall a batch (synchronized),
        the card's kernel time over a second batch (party 0), peak memory."""
        answers, walls = [], []
        reset_peak(torch, dev)
        counts.start()
        for party in (0, 1):
            sync(torch, dev)
            t0 = time.perf_counter()
            answers.append(pir.pir_query_batch_chunked(dpf, keys[party], pdb, key_chunk=chunk,
                                                       mode=mode))
            walls.append(time.perf_counter() - t0)
        launches = counts.end(f"{what}, PIR mode {mode}", need[mode])
        peak = peak_gib(torch, dev)
        busy = device_busy_ms(torch, dev, lambda: pir.pir_query_batch_chunked(
            dpf, keys[0], pdb, key_chunk=chunk, mode=mode))
        return answers, dict(wall_ms=[w * 1e3 for w in walls], busy_ms=busy, peak_gib=peak,
                             launches=launches)

    def report(what, mode, r, nq):
        busy = r["busy_ms"]
        host = "not measured" if busy is None else f"{r['wall_ms'][0] - busy:.1f} ms"
        busy_s = "not measured" if busy is None else f"{busy:.1f} ms"
        print(f"phase 18, {what}, mode {mode}: wall {r['wall_ms'][0]:.1f} / {r['wall_ms'][1]:.1f} "
              f"ms a batch of {nq} (parties 0 / 1) = {nq / r['wall_ms'][0] * 1e3:.1f} queries/s; "
              f"device (kernel time, torch.profiler, party 0) {busy_s}, wall less device "
              f"{host}; peak {r['peak_gib']:.2f} GiB; launches {r['launches']}")

    # -- 18a. BASELINE config 5 on one card.
    lds = cfg["c5_log_domain"]
    nq = cfg["c5_queries"]
    rng = np.random.default_rng(SEED + 18)
    dpf = T.DistributedPointFunction.create(T.DpfParameters(lds, T.XorWrapper(128)))
    t0 = time.perf_counter()
    db = rng.integers(0, 2**32, size=(1 << lds, 4), dtype=np.uint32)
    targets = [int(x) for x in rng.integers(0, 1 << lds, size=nq)]
    keys = dpf.generate_keys_batch(targets, [(1 << 128) - 1],
                                   seeds=rng.integers(0, 2**32, size=(nq, 2, 4), dtype=np.uint32))
    gen_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    dbs = {order: pir.prepare_pir_database(dpf, db, order=order, device=dev)
           for order in ("lane", "natural")}
    prep_s = time.perf_counter() - t0
    print(f"phase 18, BASELINE config 5 (2^{lds} x XorWrapper(128) = "
          f"{db.nbytes / 2**20:.0f} MiB, {nq} queries a server, key chunk {cfg['c5_chunk']}): "
          f"database and keys made in {gen_s:.2f} s, laid out in lane and natural order and "
          f"uploaded in {prep_s:.2f} s")
    answers = {}
    for mode in ("levels", "fused", "fold"):
        answers[mode], r = run_mode("config 5", dpf, keys, dbs[pir.MODE_ORDER[mode]], mode,
                                    cfg["c5_chunk"])
        rec = answers[mode][0] ^ answers[mode][1]
        if not np.array_equal(rec, db[targets]):
            fail(f"config 5, PIR mode {mode}: {int((rec != db[targets]).any(axis=1).sum())} of "
                 f"{nq} answers do not reconstruct their record")
        report("config 5", mode, r, nq)
    for mode in ("levels", "fused"):
        if not all(np.array_equal(a, b) for a, b in zip(answers[mode], answers["fold"])):
            fail(f"config 5: PIR modes {mode} and fold differ")
    print("phase 18, config 5: every answer reconstructs its record (ra ^ rb == db[alpha]) in "
          "modes levels, fused and fold, and the three modes agree")
    del dbs, db, answers
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # -- 18b. Mode walk on phase 4's database.
    pdb = pir.prepare_pir_database(p4["dpf"], p4["db"], order="natural", device=dev)
    got, r = run_mode("phase 4's database", p4["dpf"], p4["keys"], pdb, "walk", cfg["walk_chunk"])
    if not np.array_equal(got[0] ^ got[1], p4["db"][p4["targets"]]):
        fail("PIR mode walk: the answers do not reconstruct their records")
    if not all(np.array_equal(a, b) for a, b in zip(got, p4["fold"])):
        fail("PIR mode walk differs from phase 4's mode fold")
    report(f"phase 4's 2^{p4['dpf'].validator.parameters[0].log_domain_size} database", "walk",
           r, len(p4["targets"]))
    print("phase 18, mode walk: every answer reconstructs its record and equals phase 4's "
          "mode fold")


# Phase 19: the resilience layer. bench.py's configuration (bench.py:105-120:
# log-domain 20, Int(64), 1024 keys a party, key chunk 128) through the
# pipelined fold; phase 4's 2^20 x XorWrapper(128) PIR behind the supervisor
# with the sentinel probe; a fault matrix at log-domain 14 and 16 keys; a real
# out-of-memory error at log-domain 20; the chunk journal; the self-test and
# the host engine at BASELINE config 1's shape.
PHASE19 = dict(fault_log_domain=14, fault_keys=16, fault_chunk=8, hang_seconds=4.0,
               deadline_seconds=2.0, journal_log_domain=14, journal_keys=16, journal_chunk=4,
               oom_probe_keys=(8, 16), oom_margin=1.1, c1_log_domain=20,
               pipeline_passes=(False, True, True, False, False, True))
DEGRADE_KINDS = ("retry", "degrade", "chunk-halved")


class EventLog:
    """Every integrity event of the run, and the windows of it in which a
    fault was armed on purpose (or, for the real out-of-memory run,
    provoked): outside those windows no retry / degrade / chunk-halved
    event may occur."""

    def __init__(self, integrity):
        self.events = []
        self.windows = []
        integrity.add_event_hook(self.events.append)

    @contextlib.contextmanager
    def armed(self):
        start = len(self.events)
        try:
            yield
        finally:
            self.windows.append((start, len(self.events)))

    def kinds(self, start: int) -> list:
        return [e.kind for e in self.events[start:]]

    def clean_since(self, start: int, what: str) -> None:
        bad = [e.kind for e in self.events[start:] if e.kind in DEGRADE_KINDS]
        if bad:
            fail(f"{what}: degrade-kind events {bad} on a run with no fault armed")

    def check_all(self) -> int:
        armed = set()
        for a, b in self.windows:
            armed.update(range(a, b))
        bad = [(i, e.kind, e.detail) for i, e in enumerate(self.events)
               if e.kind in DEGRADE_KINDS and i not in armed]
        if bad:
            fail(f"degrade-kind events outside an armed fault: {bad[:5]}")
        return len(self.events)


LAUNCH_ERROR_PROBE = r"""
import json, sys, torch
from distributed_point_functions_tpu_torch.ops import aes_cuda, degrade
lib = aes_cuda.library()
dev = torch.device("cuda")
empty = torch.empty((0, 128, 1), dtype=torch.int32, device=dev)
out = {}
try:
    lib.value_hash(empty, torch.empty_like(empty))  # a grid of 0 blocks
    torch.cuda.synchronize()
    out["raised"] = None
except BaseException as e:
    err = degrade.classify_exception(e)
    out.update(raised=type(e).__name__, bases=[c.__name__ for c in type(e).__mro__[1:4]],
               message=str(e).splitlines()[0][:160],
               classified=None if err is None else type(err).__name__)
planes = torch.zeros((1, 128, 1), dtype=torch.int32, device=dev)
out["next_launch_ok"] = bool(torch.equal(aes_cuda.hash_value_planes(planes),
                                         aes_cuda.hash_value_planes(planes)))
print(json.dumps(out))
"""


def phase_19(torch, T, dev, fold_case, p4, cfg, counts: PathCounts, log: EventLog) -> dict:
    """The resilience layer on the main path (module docstring, phase 19).
    `fold_case`: phase 3's DPF and key pairs; `p4`: phase 4's PIR DPF,
    database, targets and keys. Returns the launches by path."""
    from distributed_point_functions_tpu_torch.core import host_eval
    from distributed_point_functions_tpu_torch.ops import (
        aes_cuda, aes_torch, degrade, evaluator, hierarchical, supervisor,
    )
    from distributed_point_functions_tpu_torch.parallel import pir
    from distributed_point_functions_tpu_torch.utils import faultinject, integrity, telemetry
    from distributed_point_functions_tpu_torch.utils.errors import (
        DataCorruptionError, ResourceExhaustedError, UnavailableError,
    )

    K2, K4, K5 = aes_cuda.K2, aes_cuda.K4, aes_cuda.K5
    cuda = dev.type == "cuda"
    policy = degrade.DegradationPolicy(backoff_seconds=0.0)
    launches = {}

    # -- 19f (first: it runs K4 once, outside every counted path). The KAT.
    t0 = time.perf_counter()
    integrity.selftest_device(dev)
    integrity.ensure_selftest(dev)
    print(f"phase 19f, self-test: the value hash's known answers through "
          f"{'K4' if cuda else 'K4 plain'} on {dev} ({(time.perf_counter() - t0) * 1e3:.1f} ms "
          "with the host oracle's)")

    # -- 19a. The executor at bench.py's configuration, both fold modes.
    dpf, keys = fold_case["dpf"], fold_case["keys"]
    chunk = cfg["fold_chunk"]
    need = {"fold": (K2, K4), "megakernel": (K5,)}
    t0 = time.perf_counter()
    evaluator.KeyBatch.from_keys(dpf, keys[0], device=dev)
    print(f"phase 19a: the key batch's host tables (KeyBatch.from_keys, {len(keys[0])} keys, "
          f"once a call, inside each wall below) {(time.perf_counter() - t0) * 1e3:.1f} ms")
    rows = {}
    for mode in ("fold", "megakernel"):
        per = {}
        # Passes alternate off, on, on, off, ...: the first pass of each
        # setting is checked and counted; every pass adds two walls (one a
        # party) to its setting's spread.
        for pass_no, pipe in enumerate(cfg["pipeline_passes"]):
            first = pipe not in per
            start = len(log.events)
            walls, folds = [], []
            counts.start()
            with telemetry.capture() as tel:
                for party in (0, 1):
                    sync(torch, dev)
                    t0 = time.perf_counter()
                    out = [f[:v] for v, f in evaluator.full_domain_fold_chunks(
                        dpf, keys[party], key_chunk=chunk, mode=mode, pipeline=pipe,
                        device=dev)]
                    folds.append(aes_torch.from_words(torch.cat(out)))
                    walls.append(time.perf_counter() - t0)
            got = counts.end(f"19a, fold mode {mode}, pipeline={pipe}, pass {pass_no}", need[mode])
            log.clean_since(start, f"19a, mode {mode}, pipeline={pipe}, pass {pass_no}")
            if not first:
                for party in (0, 1):
                    if not np.array_equal(per[pipe]["folds"][party], folds[party]):
                        fail(f"19a, mode {mode}, pipeline={pipe}: pass {pass_no} differs")
                if got != per[pipe]["launches"]:
                    fail(f"19a, mode {mode}, pipeline={pipe}: pass {pass_no} launches {got}")
                per[pipe]["walls"].extend(walls)
                continue
            snap = tel.snapshot()
            busy = device_busy_ms(torch, dev, lambda: [f for _, f in evaluator.full_domain_fold_chunks(
                dpf, keys[0], key_chunk=chunk, mode=mode, pipeline=pipe, device=dev)])
            per[pipe] = dict(folds=folds, walls=list(walls), launches=got, busy=busy, snap=snap)
        for pipe in (False, True):
            walls, snap, busy = per[pipe]["walls"], per[pipe]["snap"], per[pipe]["busy"]
            med = float(np.median(walls))
            pc = {k: v for k, v in snap["counters"].items() if k.startswith(("pipeline.", "bytes."))}
            spans = {k[5:]: dict(count=v["count"], total_ms=round(v["sum"] * 1e3, 3),
                                 p50_ms=round(v["p50"] * 1e3, 3))
                     for k, v in snap["histograms"].items()
                     if k.startswith("span.pipeline.") and "[" not in k}
            share = "not measured" if busy is None else f"{busy / (med * 1e3):.3f}"
            print(f"phase 19a, mode {mode}, pipeline={pipe}: wall median {med * 1e3:.1f} ms, "
                  f"min {min(walls) * 1e3:.1f}, max {max(walls) * 1e3:.1f} over {len(walls)} "
                  f"party calls ({len(keys[0])} keys x 2^"
                  f"{dpf.validator.parameters[0].log_domain_size}, key chunk {chunk}) = "
                  f"{med * 1e3 / -(-len(keys[0]) // chunk):.2f} ms a chunk; walls ms "
                  f"{[round(w * 1e3, 1) for w in walls]}; "
                  f"card busy (kernel time, torch.profiler, party 0) "
                  f"{'not measured' if busy is None else f'{busy:.1f} ms'} = share {share} of "
                  f"the median wall; launches {per[pipe]['launches']}; telemetry counters {pc}; "
                  f"spans {spans}; decisions {snap['decisions_by_source']}")
        for party in (0, 1):
            if not np.array_equal(per[False]["folds"][party], per[True]["folds"][party]):
                fail(f"19a, mode {mode}: pipeline=True and pipeline=False folds differ "
                     f"(party {party})")
        if per[False]["launches"] != per[True]["launches"]:
            fail(f"19a, mode {mode}: launches differ, {per[False]['launches']} vs "
                 f"{per[True]['launches']}")
        rows[mode] = per
        launches[f"19a {mode}"] = per[True]["launches"]
    for party in (0, 1):
        if not np.array_equal(rows["fold"][True]["folds"][party],
                              rows["megakernel"][True]["folds"][party]):
            fail(f"19a: modes fold and megakernel differ (party {party})")
    print("phase 19a: pipeline=True == pipeline=False bit for bit with equal launch counts "
          "in both modes, and the modes agree")
    if cuda:
        syncs = {}
        for mode in ("fold", "megakernel"):
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    for _ in evaluator.full_domain_fold_chunks(
                            dpf, keys[0], key_chunk=chunk, mode=mode, pipeline=True, device=dev):
                        pass
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            syncs[mode] = sorted({f"{w.filename.split('/')[-1]}:{w.lineno} {str(w.message)[:60]}"
                                  for w in caught})
        print(f"phase 19a, host syncs on the fold's path (set_sync_debug_mode('warn'), "
              f"one pipelined pass a mode): {json.dumps(syncs)}")

    # -- 19b. PIR behind the supervisor, with and without the probe.
    pdpf, db, targets = p4["dpf"], p4["db"], p4["targets"]
    pdb = pir.prepare_pir_database(pdpf, db, order="megakernel", device=dev)
    t0 = time.perf_counter()
    pdb.natural_host(pdpf)
    nat_s = time.perf_counter() - t0
    # The probe's host-oracle values are computed once per parameter set and
    # party, on the first call; timed apart here.
    first = []
    for party in (0, 1):
        t0 = time.perf_counter()
        supervisor.pir_query_batch_robust(pdpf, p4["keys"][party], pdb, key_chunk=cfg["pir_chunk"],
                                          policy=policy, mode="megakernel")
        first.append(time.perf_counter() - t0)
    print(f"phase 19b, first probed call a party (the probe key's host-oracle values over "
          f"2^{pdpf.validator.parameters[0].log_domain_size} positions, once a parameter set "
          f"and party): {first[0]:.2f} / {first[1]:.2f} s")
    pir_rows = {}
    for pass_no, pipe in enumerate(cfg["pipeline_passes"]):
        for verify in (True, False):
            pol = degrade.DegradationPolicy(backoff_seconds=0.0, verify=verify)
            start = len(log.events)
            answers, walls = [], []
            counts.start()
            for party in (0, 1):
                sync(torch, dev)
                t0 = time.perf_counter()
                answers.append(supervisor.pir_query_batch_robust(
                    pdpf, p4["keys"][party], pdb, key_chunk=cfg["pir_chunk"], policy=pol,
                    pipeline=pipe, mode="megakernel"))
                walls.append(time.perf_counter() - t0)
            got = counts.end(f"19b, PIR verify={verify} pipeline={pipe} pass {pass_no}", (K5,))
            log.clean_since(start, f"19b, PIR verify={verify}, pipeline={pipe}, pass {pass_no}")
            kinds = collections.Counter(log.kinds(start))
            if not np.array_equal(answers[0] ^ answers[1], db[targets]):
                fail(f"19b, verify={verify}, pipeline={pipe}: answers do not reconstruct")
            if verify and kinds["sentinel-ok"] != 2:
                fail(f"19b: the probe verified {kinds['sentinel-ok']} of 2 calls")
            row = pir_rows.setdefault((verify, pipe), dict(walls=[], launches=got,
                                                           events=dict(kinds)))
            if got != row["launches"]:
                fail(f"19b, verify={verify}, pipeline={pipe}: pass {pass_no} launches {got}")
            row["walls"].extend(walls)
            launches[f"19b verify={verify} pipeline={pipe}"] = got
    for (verify, pipe), row in sorted(pir_rows.items()):
        walls = row["walls"]
        print(f"phase 19b, pir_query_batch_robust(mode='megakernel', pipeline={pipe}), "
              f"probe {'on' if verify else 'off'}: wall median "
              f"{float(np.median(walls)) * 1e3:.1f} ms, min {min(walls) * 1e3:.1f}, max "
              f"{max(walls) * 1e3:.1f} over {len(walls)} party calls ({len(targets)} queries, "
              f"key chunk {cfg['pir_chunk']}); walls ms {[round(w * 1e3, 1) for w in walls]}; "
              f"launches {row['launches']}; events {row['events']}")
    cost = {pipe: (float(np.median(pir_rows[(True, pipe)]["walls"]))
                   - float(np.median(pir_rows[(False, pipe)]["walls"]))) * 1e3
            for pipe in (False, True)}
    print(f"phase 19b: every answer reconstructs its record (ra ^ rb == db[alpha]); no retry, "
          f"degrade or chunk-halved event; the probe verified each call; probe cost a call "
          f"(median with minus median without) {cost[False]:.1f} ms serial, "
          f"{cost[True]:.1f} ms pipelined (the natural-order copy of the "
          f"database, {nat_s * 1e3:.1f} ms, is made once a database); K5 launches with the "
          f"probe {pir_rows[(True, True)]['launches']}, without "
          f"{pir_rows[(False, True)]['launches']}")

    # -- 19c. The fault matrix at a small shape.
    lds = cfg["fault_log_domain"]
    rng = np.random.default_rng(SEED + 19)
    fdpf = T.DistributedPointFunction.create(T.DpfParameters(lds, T.XorWrapper(128)))
    fdb = rng.integers(0, 2**32, size=(1 << lds, 4), dtype=np.uint32)
    nk = cfg["fault_keys"]
    ftargets = [int(x) for x in rng.integers(0, 1 << lds, size=nk)]
    fkeys, _ = fdpf.generate_keys_batch(ftargets, [(1 << 128) - 1],
                                        seeds=rng.integers(0, 2**32, size=(nk, 2, 4),
                                                           dtype=np.uint32))
    oracle = supervisor._host_pir_fold(fdpf, fkeys, fdb, 128)
    fpdb = pir.prepare_pir_database(fdpf, fdb, order="megakernel", device=dev)
    hang_policy = degrade.DegradationPolicy(backoff_seconds=0.0,
                                            deadline_seconds=cfg["deadline_seconds"])
    matrix = [
        ("output corruption", [faultinject.FaultPlan(stage="device_output", pattern="lane",
                                                     lane=3, max_fires=1)],
         policy, ["degrade", "recovered"]),
        ("ResourceExhaustedError", [faultinject.FaultPlan(
            stage="device_call", exception=ResourceExhaustedError("RESOURCE_EXHAUSTED: injected"),
            max_fires=1)], policy, ["chunk-halved"]),
        ("UnavailableError", [faultinject.FaultPlan(
            stage="device_call", exception=UnavailableError("UNAVAILABLE: injected"),
            max_fires=1)], policy, ["retry"]),
        ("device_hang under a deadline", [faultinject.FaultPlan(
            stage="device_hang", hang_seconds=cfg["hang_seconds"], hang_point="finalize",
            max_fires=1)], hang_policy, ["deadline-expired", "retry"]),
    ]
    for name, plans, pol, want_kinds in matrix:
        start = len(log.events)
        sync(torch, dev)
        t0 = time.perf_counter()
        with log.armed(), faultinject.inject(*plans):
            got = supervisor.pir_query_batch_robust(
                fdpf, fkeys, fpdb, key_chunk=cfg["fault_chunk"], policy=pol, pipeline=True,
                mode="megakernel")
        secs = time.perf_counter() - t0
        if not np.array_equal(got, oracle):
            fail(f"19c, {name}: the answers differ from the host oracle")
        seq = [k for k in log.kinds(start) if k not in ("sentinel-ok", "pir-db-reprepared")]
        ends = [e.backend for e in log.events[start:] if e.kind == "recovered"]
        if seq != want_kinds:
            fail(f"19c, {name}: events {seq}, expected {want_kinds}")
        if cuda and ends not in ([], ["cuda"]):
            fail(f"19c, {name}: served by {ends}, not a kernel rung")
        print(f"phase 19c, {name}: equal to the host oracle bit for bit in {secs:.2f} s; events "
              f"{seq}" + (f"; served by {ends[0]}" if ends else ""))
    # A fault on every card rung: the wrapper raises. Neither the kernels'
    # plain versions nor the host answer for the card.
    for name, plan, want_err, want_kinds in (
        ("unavailable on every card rung", faultinject.FaultPlan(
            stage="device_call", exception=UnavailableError("UNAVAILABLE: injected"),
            backends=frozenset({"cuda"})), UnavailableError,
         ["retry", "retry", "degrade", "retry", "retry"]),
        ("output corruption on every card rung", faultinject.FaultPlan(
            stage="device_output", pattern="lane", lane=3, backends=frozenset({"cuda"})),
         DataCorruptionError, ["degrade"]),
    ):
        if not cuda:
            continue
        start = len(log.events)
        try:
            with log.armed(), faultinject.inject(plan):
                supervisor.pir_query_batch_robust(
                    fdpf, fkeys, fpdb, key_chunk=cfg["fault_chunk"], policy=policy,
                    pipeline=True, mode="megakernel")
            fail(f"19c, {name}: the wrapper answered")
        except want_err as e:
            raised = f"{type(e).__name__}: {str(e).splitlines()[0][:100]}"
        seq = [k for k in log.kinds(start)
               if k not in ("sentinel-ok", "pir-db-reprepared", "selftest-ok")]
        backends = sorted({e.backend for e in log.events[start:]
                           if e.kind in DEGRADE_KINDS + ("recovered",)})
        if seq != want_kinds or backends != ["cuda"]:
            fail(f"19c, {name}: events {seq} on backends {backends}, expected {want_kinds} "
                 "on cuda only")
        print(f"phase 19c, {name}: raised {raised}; events {seq}, every one on the cuda rungs")

    # -- 19d. One real out-of-memory error at log-domain 20.
    if cuda:
        odpf = dpf
        per_key = []
        for n in cfg["oom_probe_keys"]:
            torch.cuda.empty_cache()
            reset_peak(torch, dev)
            base = torch.cuda.memory_allocated()
            evaluator.full_domain_evaluate(odpf, keys[0][:n], key_chunk=n, device=dev,
                                           integrity=False, pipeline=False)
            per_key.append((torch.cuda.max_memory_allocated() - base) / n)
        total = torch.cuda.get_device_properties(dev).total_memory
        slope = max(per_key)
        oom_chunk = 1
        while oom_chunk * slope <= cfg["oom_margin"] * total:
            oom_chunk *= 2
        okeys = (list(keys[0]) * (-(-oom_chunk // len(keys[0]))))[:oom_chunk]
        print(f"phase 19d: full_domain_evaluate peaks at {slope / 2**20:.1f} MiB a key "
              f"(measured at {cfg['oom_probe_keys']} keys); the card holds "
              f"{total / 2**30:.1f} GiB, so a key chunk of {oom_chunk} needs "
              f"{oom_chunk * slope / 2**30:.1f} GiB")
        del per_key
        oom_policy = degrade.DegradationPolicy(backoff_seconds=0.0, verify=False)
        torch.cuda.empty_cache()
        reset_peak(torch, dev)
        start = len(log.events)
        t0 = time.perf_counter()
        with log.armed():
            # No probe (it would pad a second chunk of the same size) and one
            # chunk in flight: the values of a chunk are gigabytes on the host.
            vals = supervisor.full_domain_evaluate_robust(
                odpf, okeys, key_chunk=oom_chunk, policy=oom_policy, pipeline=False, device=dev)
        secs = time.perf_counter() - t0
        peak = peak_gib(torch, dev)
        evs = log.events[start:]
        halved = [e.data["key_chunk"] for e in evs if e.kind == "chunk-halved"]
        others = [e.kind for e in evs if e.kind in ("retry", "degrade")]
        if not halved or others or any(e.backend != "cuda" or e.data.get("cause") !=
                                       "OutOfMemoryError" for e in evs
                                       if e.kind == "chunk-halved"):
            fail(f"19d: expected chunk halvings on the cuda rung only, got "
                 f"{[(e.kind, e.backend) for e in evs if e.kind != 'sentinel-ok']}")
        # The XOR fold of each key's values is order-free: it must equal K5's fold.
        folds = np.bitwise_xor.reduce(vals, axis=1)
        k5 = np.concatenate([aes_torch.from_words(f[:v]) for v, f in
                             evaluator.full_domain_fold_chunks(odpf, okeys[:len(keys[0])],
                                                               key_chunk=chunk,
                                                               mode="megakernel", device=dev)])
        k5 = np.tile(k5, (-(-oom_chunk // len(keys[0])), 1))[:oom_chunk]
        sample = [0, len(okeys) - 1]
        want = host_eval.values_to_limbs(host_eval.full_domain_evaluate_host(
            odpf, [okeys[i] for i in sample]), 64)
        if not np.array_equal(folds, k5) or not np.array_equal(vals[sample], want):
            fail("19d: the values after the halvings differ from K5's folds or the host oracle")
        print(f"phase 19d: a real torch.OutOfMemoryError at key chunk {oom_chunk}, classified "
              f"ResourceExhaustedError; the chain halved the chunk to {halved} and answered "
              f"{vals.shape} values bit-exact (every key's XOR fold equals K5's, keys "
              f"{sample} equal the host oracle) in {secs:.1f} s; peak {peak:.2f} GiB")
        del vals, folds, k5
        torch.cuda.empty_cache()
        probe = subprocess.run([sys.executable, "-c", LAUNCH_ERROR_PROBE], capture_output=True,
                               text=True, timeout=300)
        line = probe.stdout.strip().splitlines()[-1] if probe.stdout.strip() else ""
        print(f"phase 19d, a failing launch check (a grid of 0 blocks through K4's binding, in "
              f"a child process): rc {probe.returncode}; {line or probe.stderr[-400:]}")
        if probe.returncode != 0:
            fail("the launch-error probe did not exit cleanly")
        seen = json.loads(line)
        if seen["raised"] is None or seen["classified"] != "UnavailableError" \
                or not seen["next_launch_ok"]:
            fail(f"a failing launch check is not a classified, non-sticky error: {seen}")

    # -- 19e. The chunk journal.
    jl = cfg["journal_log_domain"]
    jdpf = T.DistributedPointFunction.create(T.DpfParameters(jl, T.Int(64)))
    jn = cfg["journal_keys"]
    jkeys, _ = jdpf.generate_keys_batch(
        [int(x) for x in rng.integers(0, 1 << jl, size=jn)], [[7] * jn],
        seeds=rng.integers(0, 2**32, size=(jn, 2, 4), dtype=np.uint32))
    jc = cfg["journal_chunk"]
    groups = jn // jc
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "fd.journal")
        full = supervisor.full_domain_evaluate_robust(jdpf, jkeys, key_chunk=jc, policy=policy,
                                                      device=dev)
        counts.start()
        whole = supervisor.full_domain_evaluate_robust(
            jdpf, jkeys, key_chunk=jc, policy=policy, journal=os.path.join(tmp, "whole.journal"),
            device=dev)
        full_launches = counts.end("19e, the whole journaled job", (K2, K4))
        if not np.array_equal(whole, full):
            fail("19e: the journaled job differs from the job without a journal")
        # Each group of jc keys and its probe run as two executor chunks.
        kill_after = 2
        start = len(log.events)
        with log.armed(), faultinject.inject(faultinject.FaultPlan(
                stage="chunk_launch", exception=RuntimeError("killed"),
                skip_fires=2 * kill_after)):
            try:
                supervisor.full_domain_evaluate_robust(jdpf, jkeys, key_chunk=jc,
                                                       policy=policy, journal=path, device=dev)
                fail("19e: the injected kill did not stop the job")
            except RuntimeError as e:
                if "killed" not in str(e):
                    raise
        counts.start()
        resumed = supervisor.full_domain_evaluate_robust(jdpf, jkeys, key_chunk=jc,
                                                         policy=policy, journal=path, device=dev)
        rerun = counts.end("19e, the resumed job", (K2, K4))
    want = {k: v * (groups - kill_after) // groups for k, v in full_launches.items()}
    if not np.array_equal(resumed, full) or rerun != want:
        fail(f"19e: resumed job launches {rerun} (expected {want}) or values differ")
    print(f"phase 19e, the journal: {groups} groups of {jc} keys at log-domain {jl}; killed "
          f"after {kill_after} groups; the resumed job re-dispatched only the other "
          f"{groups - kill_after}: launches {rerun} against {full_launches} for the whole "
          "journaled job, values equal to the job without a journal")
    launches["19e"] = rerun

    # -- 19f. The host engine at BASELINE config 1's shape.
    cl = cfg["c1_log_domain"]
    c1 = T.DistributedPointFunction.create_incremental([T.DpfParameters(cl, T.XorWrapper(128))])
    alpha = int(rng.integers(0, 1 << cl))
    beta = int.from_bytes(rng.bytes(16), "little") | 1
    (k0,), (k1,) = c1.generate_keys_batch([alpha], [[beta]],
                                          seeds=rng.integers(0, 2**32, size=(1, 2, 4),
                                                             dtype=np.uint32))
    host_s = []
    for key in (k0, k1):
        card_vals = hierarchical.evaluate_until_batch(
            hierarchical.BatchedContext.create(c1, [key]), 0, device=dev)
        t0 = time.perf_counter()
        host_vals = hierarchical.evaluate_until_batch(
            hierarchical.BatchedContext.create(c1, [key]), 0, engine="host")
        host_s.append(time.perf_counter() - t0)
        if not np.array_equal(host_vals, card_vals):
            fail("19f: evaluate_until_batch(engine='host') differs from the card")
    print(f"phase 19f, evaluate_until_batch(engine='host') at config 1's shape (XorWrapper(128), "
          f"log-domain {cl}, one key a party): equal to the card, {host_s[0]:.2f} / "
          f"{host_s[1]:.2f} s a party on the host")
    print(f"phase 19: {log.check_all()} integrity events so far, no retry, degrade or "
          "chunk-halved event outside an armed fault")
    return launches


# Phase 20: the serving plane on the card. 20a: BASELINE config 5 over two
# server processes on loopback (`python -m ...serving.server`, ephemeral ports,
# --ready-file, --pir-db cfg5:24:<seed>, key chunk 8 as phase 18 ran it); 16
# concurrent requests of 4 queries merge in each server's batcher (a width
# target of 64 and a 200 ms wait let one merged batch take them all). 20b:
# benchmarks/bench_serving.py's mixed stream (:54-78, :734-770: 200 requests,
# log-domain 14, Int(64), a pool of 32 DPF and 4 DCF keys, default_rng(17), a
# mean gap of 5 ms, width 64, max_wait_ms 10, key chunk 32, undelayed) plus one
# request a kind for a DReLU gate at log-group 16, PIR on phase 4's database,
# BM_HeavyHitters' first 16 levels and 64 keys dealt at depth 20, through an
# in-process FrontDoor(engine="device"). 20c: the router's anchors, each op
# forced onto each device mode at these configurations and onto the host
# engine at a small shape. 20d: SIGTERM and restart of one 20a server.
PHASE20 = dict(
    server_device="cuda", start_timeout=300.0, request_timeout=900.0,
    c5_log_domain=24, c5_queries=64, c5_chunk=8, c5_requests=16, c5_wait_ms=200.0,
    c5_db_spec=f"cfg5:24:{SEED}",
    stream_requests=200, stream_log_domain=14, stream_pool=32, stream_dcf_keys=4,
    stream_seed=17, stream_gap_ms=5.0, stream_width=64, stream_wait_ms=10.0,
    stream_chunk=32, gate_log_group=16, gate_inputs=64, pir_keys=4, hh_levels=16,
    hh_keys=8, hh_nonzeros=10_000, keygen_keys=64, keygen_log_domain=20,
    drain_requests=4,
    # 20c: (device shape, host shape) per op.
    anchor_fd=((20, 32), (12, 4)), anchor_ea=((32, 1024, 4096), (32, 8, 64)),
    anchor_dcf=((24, 512, 512), (24, 2, 16)), anchor_pir_host=(12, 4),
    anchor_hh=((16, 64), (6, 2)), anchor_kg=((20, 1024), (20, 64)),
    dispatch_reps=20,
)


def _serving_pcts(latencies) -> tuple:
    v = np.sort(np.asarray(latencies)) * 1e3
    return float(np.percentile(v, 50)), float(np.percentile(v, 95))


class _Servers:
    """The party processes of phase 20a, stopped on any exit."""

    def __init__(self, cfg, tmp: str):
        self.cfg, self.tmp = cfg, tmp
        self.procs = {}

    def start(self, name: str, port: int = 0, wait: bool = True):
        cfg = self.cfg
        ready = os.path.join(self.tmp, f"{name}.ready")
        if os.path.exists(ready):
            os.remove(ready)
        cmd = [sys.executable, "-m", "distributed_point_functions_tpu_torch.serving.server",
               "--port", str(port), "--ready-file", ready, "--device", cfg["server_device"],
               "--engine", "device", "--key-chunk", str(cfg["c5_chunk"]),
               "--max-wait-ms", str(cfg["c5_wait_ms"]), "--width-target",
               str(cfg["c5_queries"]), "--pir-db", cfg["c5_db_spec"]]
        log = open(os.path.join(self.tmp, f"{name}.log"), "ab")
        proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT,
                                cwd=os.path.dirname(os.path.abspath(__file__)))
        self.procs[name] = (proc, ready)
        return self.wait_ready(name) if wait else None

    def wait_ready(self, name: str) -> int:
        proc, ready = self.procs[name]
        t0 = time.perf_counter()
        while not os.path.exists(ready):
            if proc.poll() is not None:
                fail(f"server {name} exited with {proc.returncode} before it listened:\n"
                     + self.log_tail(name))
            if time.perf_counter() - t0 > self.cfg["start_timeout"]:
                fail(f"server {name} did not listen within {self.cfg['start_timeout']} s")
            time.sleep(0.05)
        return int(open(ready).read())

    def log_tail(self, name: str) -> str:
        with open(os.path.join(self.tmp, f"{name}.log"), "rb") as f:
            return f.read()[-3000:].decode("utf-8", "replace")

    def stop(self, name: str, timeout: float = 60.0) -> int:
        import signal

        proc, _ = self.procs.pop(name)
        if proc.poll() is None:
            proc.send_signal(signal.SIGTERM)
        try:
            return proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            fail(f"server {name} did not stop within {timeout} s of SIGTERM")

    def stop_all(self) -> None:
        for name in list(self.procs):
            proc, _ = self.procs.pop(name)
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def _launch_diff(after: dict, before: dict) -> dict:
    return {n: c - before.get(n, 0) for n, c in after.items() if c - before.get(n, 0)}


def phase_20(torch, T, dev, p4, cfg, counts: PathCounts, card: str = "") -> dict:
    """The serving plane (module docstring, phase 20): 20a config 5 over two
    server processes, 20b the mixed stream through an in-process front door,
    20c the router's anchors and an auto-routed batch a op, 20d drain and
    restart. `p4`: phase 4's DPF, database, targets and keys. Returns the
    launches of the servers' kernels and the anchors measured."""
    import threading

    from distributed_point_functions_tpu_torch import gates, serving
    from distributed_point_functions_tpu_torch.ops import aes_cuda
    from distributed_point_functions_tpu_torch.parallel import pir
    from distributed_point_functions_tpu_torch.serving import server as server_mod

    out = {"server_launches": {}}
    with tempfile.TemporaryDirectory(prefix="dpf-phase20-") as tmp:
        servers = _Servers(cfg, tmp)
        try:
            _phase_20a_d(torch, T, dev, cfg, counts, servers, out, serving, pir, aes_cuda,
                         server_mod, threading, card)
        finally:
            servers.stop_all()
    print(card)
    _phase_20b(torch, T, dev, p4, cfg, counts, serving, gates, aes_cuda, pir)
    print(card)
    with tempfile.TemporaryDirectory(prefix="dpf-phase20c-") as tmp:
        out["anchors"] = _phase_20c(torch, T, dev, p4, cfg, serving, tmp)
    print(card)
    return out


def _phase_20a_d(torch, T, dev, cfg, counts, servers, out, serving, pir, aes_cuda, server_mod,
                 threading, card) -> None:
    from distributed_point_functions_tpu_torch.ops import supervisor
    from distributed_point_functions_tpu_torch.serving import frontdoor

    # -- 20a. BASELINE config 5 over two server processes.
    lds, nq, nreq = cfg["c5_log_domain"], cfg["c5_queries"], cfg["c5_requests"]
    per = nq // nreq
    name, db = server_mod._parse_pir_db(cfg["c5_db_spec"])
    rng = np.random.default_rng(SEED + 20)
    dpf = T.DistributedPointFunction.create(T.DpfParameters(lds, T.XorWrapper(128)))
    params = dpf.validator.parameters
    targets = [int(x) for x in rng.integers(0, 1 << lds, size=nq)]
    k0, k1 = dpf.generate_keys_batch(targets, [(1 << 128) - 1], seeds=rng.integers(
        0, 2**32, size=(nq, 2, 4), dtype=np.uint32))
    t0 = time.perf_counter()
    ports = [servers.start(f"party{p}", wait=False) for p in (0, 1)]
    ports = [servers.wait_ready(f"party{p}") for p in (0, 1)]
    start_s = time.perf_counter() - t0
    policy = serving.RetryPolicy(attempts=4, attempt_timeout=cfg["request_timeout"],
                                 connect_attempts=480, connect_backoff=0.25, seed=0)
    endpoints = [("127.0.0.1", p) for p in ports]
    clients = [serving.TwoServerClient(endpoints, policy=policy) for _ in range(nreq)]
    stats = lambda i: clients[0].clients[i].stats(timeout=60)
    t0 = time.perf_counter()
    warm = clients[0].pir(params, (k0[:per], k1[:per]), name, deadline=cfg["request_timeout"])
    warm_s = time.perf_counter() - t0
    if not np.array_equal(warm[0] ^ warm[1], db[targets[:per]]):
        fail("config 5 over two servers: the warm-up answers do not reconstruct")
    print(f"phase 20a, BASELINE config 5 over two server processes (2^{lds} x XorWrapper(128), "
          f"{nq} queries as {nreq} concurrent requests of {per}, key chunk {cfg['c5_chunk']}, "
          f"mode fold (the PIR default), width target {nq}, max wait {cfg['c5_wait_ms']:.0f} ms): servers "
          f"listening {start_s:.1f} s after start; the warm-up request (the card's kernel "
          f"library, the database's lane layout and the probe's host oracle) {warm_s:.2f} s",
          flush=True)
    for c in clients:
        for dc in c.clients:
            dc.connect()
    before = [stats(i) for i in (0, 1)]
    answers = [None] * nreq
    lat = [0.0] * nreq
    errors = []
    barrier = threading.Barrier(nreq)

    def one(i):
        try:
            barrier.wait()
            t = time.perf_counter()
            s = slice(i * per, (i + 1) * per)
            answers[i] = clients[i].pir(params, (k0[s], k1[s]), name,
                                        deadline=cfg["request_timeout"])
            lat[i] = time.perf_counter() - t
        except BaseException as exc:  # noqa: BLE001 (reported below)
            errors.append(exc)

    threads = [threading.Thread(target=one, args=(i,)) for i in range(nreq)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if errors:
        fail(f"config 5 over two servers: {errors[0]!r}")
    after = [stats(i) for i in (0, 1)]
    rec = np.concatenate([a[0] ^ a[1] for a in answers])
    if not np.array_equal(rec, db[targets]):
        fail(f"config 5 over two servers: {int((rec != db[targets]).any(axis=1).sum())} of {nq} "
             "answers do not reconstruct their record")
    batches = [a["batches"][len(b["batches"]):] for a, b in zip(after, before)]
    served = [_launch_diff(a["launches"], b["launches"]) for a, b in zip(after, before)]
    # The direct calls at the merged batches' widths, in this process: the
    # entry point the door's robust wrapper runs, its sentinel probe riding as
    # one more key (integrity._probe_pair, the key the wrapper appends; its
    # host-oracle check, which the servers made, is left out here), and
    # phase 18's call without the probe.
    from distributed_point_functions_tpu_torch.utils import integrity

    pdb = pir.prepare_pir_database(dpf, db, order="lane", device=dev)
    probe_pair, _ = integrity._probe_pair(dpf)
    direct, direct_s, chunked_s = [], [], []
    for party, keys in ((0, k0), (1, k1)):
        want = {}
        for b in batches[party]:
            merged = frontdoor._pad_keys(list(keys[: b["width"]]), True, chunk=cfg["c5_chunk"])
            counts_before = {k.name: k.launches for k in aes_cuda.KERNELS}
            sync(torch, dev)
            t = time.perf_counter()
            got = pir.pir_query_batch_chunked(dpf, merged + [probe_pair[party]], pdb,
                                              key_chunk=cfg["c5_chunk"], mode="fold",
                                              integrity=False, device=dev)
            sync(torch, dev)
            direct_s.append(time.perf_counter() - t)
            for n, c in _launch_diff({k.name: k.launches for k in aes_cuda.KERNELS},
                                     counts_before).items():
                want[n] = want.get(n, 0) + c
            served_rows = np.concatenate([a[party] for a in answers])[: b["width"]]
            if len(batches[party]) == 1 and not np.array_equal(got[: b["width"]], served_rows):
                fail(f"config 5, party {party}: the served answers differ from the direct call")
        direct.append(want)
        sync(torch, dev)
        t = time.perf_counter()
        pir.pir_query_batch_chunked(dpf, keys, pdb, key_chunk=cfg["c5_chunk"], mode="fold",
                                    integrity=False, device=dev)
        sync(torch, dev)
        chunked_s.append(time.perf_counter() - t)
    del pdb
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    for party in (0, 1):
        for n, c in served[party].items():
            out["server_launches"][n] = out["server_launches"].get(n, 0) + c
    p50, p95 = _serving_pcts(lat)
    print("phase 20a: every answer reconstructs its record (ra ^ rb == db[alpha]) and equals "
          "the direct call's on the merged batch")
    for party in (0, 1):
        print(f"phase 20a, party {party}: merged batches (requests, width, wall ms) "
              f"{[(b['requests'], b['width'], round(b['seconds'] * 1e3, 1)) for b in batches[party]]}; "
              f"launches {served[party]} = the direct calls' {direct[party]}")
    print(f"phase 20a: {nreq} requests in {wall * 1e3:.1f} ms = {nreq / wall:.1f} requests/s, "
          f"{nq / wall:.1f} queries/s a server pair; request latency p50 {p50:.1f} ms, p95 "
          f"{p95:.1f} ms; direct in this process at the merged width: pir_query_batch_chunked "
          f"with the probe key, unchecked, {[round(s * 1e3, 1) for s in direct_s]} ms, phase "
          f"18's call without it {[round(s * 1e3, 1) for s in chunked_s]} ms (parties 0 / 1; "
          "the two servers share the card while they serve)")
    if served != direct:
        fail(f"config 5 over two servers: served launches {served}, the direct robust calls "
             f"at the merged batches' widths {direct}")
    print(card)

    # -- 20d. Drain and restart of party 1.
    import signal

    proc, _ = servers.procs["party1"]
    points = targets[:per] + [int(x) for x in rng.integers(0, 1 << lds, size=60)]
    ea_before = clients[0].evaluate_at(params, (k0[:per], k1[:per]), points,
                                       deadline=cfg["request_timeout"])
    health = serving.DpfClient("127.0.0.1", ports[1], policy=policy).connect()
    before_b = stats(1)
    nd = cfg["drain_requests"]
    drained, derrors = [None] * nd, []

    dclients = [serving.DpfClient("127.0.0.1", ports[1], policy=serving.RetryPolicy(
        attempts=1, attempt_timeout=cfg["request_timeout"])).connect() for _ in range(nd)]

    def drain_one(i):
        try:
            drained[i] = dclients[i].pir(params, k1[i * per:(i + 1) * per], name)
        except BaseException as exc:  # noqa: BLE001 (reported below)
            derrors.append(exc)

    dthreads = [threading.Thread(target=drain_one, args=(i,)) for i in range(nd)]
    for t in dthreads:
        t.start()
    t0 = time.perf_counter()
    while health.health(timeout=30)["inflight"] < nd:
        if time.perf_counter() - t0 > 60:
            fail(f"20d: {nd} requests never were in flight on party 1 together")
        time.sleep(0.002)
    proc.send_signal(signal.SIGTERM)
    t_term = time.perf_counter()
    saw = None
    while True:
        try:
            h = health.health(timeout=30)
        except Exception:  # noqa: BLE001 (the drained server closed the connection)
            break
        if not h["ready"]:
            saw = h
            break
        time.sleep(0.005)
    for t in dthreads:
        t.join()
    for c in dclients + [health]:
        c.close()
    code = servers.stop("party1")
    drain_s = time.perf_counter() - t_term
    if derrors:
        fail(f"20d: a request in flight at SIGTERM failed: {derrors[0]!r}")
    for i, a in enumerate(drained):
        if not np.array_equal(a, answers[i][1]):
            fail("20d: a drained answer differs from 20a's")
    if saw is None or saw["status"] != "draining":
        fail(f"20d: party 1 never reported not-ready while draining (last health {saw})")
    if code != 0:
        fail(f"20d: party 1 exited with {code} after its drain")
    t0 = time.perf_counter()
    servers.start("party1", port=ports[1], wait=False)
    again = clients[0].evaluate_at(params, (k0[:per], k1[:per]), points,
                                   deadline=cfg["request_timeout"])
    restart_s = time.perf_counter() - t0
    if not all(np.array_equal(a, b) for a, b in zip(again, ea_before)):
        fail("20d: the EvaluateAt call carried across the restart differs from the one before")
    rec = again[0] ^ again[1]
    if not all((rec[i, j] == (0xFFFFFFFF if p == targets[i] else 0)).all()
               for i in range(per) for j, p in enumerate(points)):
        fail("20d: the EvaluateAt shares do not reconstruct")
    if servers.wait_ready("party1") != ports[1]:
        fail("20d: party 1 restarted on another port")
    end = [stats(0), clients[0].clients[1].stats(timeout=60)]
    for n, c in _launch_diff(end[0]["launches"], after[0]["launches"]).items():
        out["server_launches"][n] = out["server_launches"].get(n, 0) + c
    for n, c in end[1]["launches"].items():
        out["server_launches"][n] = out["server_launches"].get(n, 0) + c
    for n, c in _launch_diff(before_b["launches"], after[1]["launches"]).items():
        out["server_launches"][n] = out["server_launches"].get(n, 0) + c
    print(f"phase 20d: SIGTERM to party 1 with {nd} requests in flight: every one answered "
          f"(equal to 20a's), health reported {saw['status']!r} / ready {saw['ready']}, exit "
          f"code {code}, {drain_s:.2f} s from SIGTERM to exit; restarted on port {ports[1]}, "
          f"the client's retry carried its next call (EvaluateAt, {per} keys x {len(points)} "
          f"points) across the restart in {restart_s:.2f} s, equal to the same call before the "
          "SIGTERM and reconstructing")
    for c in clients:
        c.close()
    for p in (0, 1):
        if servers.stop(f"party{p}") != 0:
            fail(f"party {p} did not exit cleanly")
    for n, c in out["server_launches"].items():
        counts.total[n] = counts.total.get(n, 0) + c
    print(f"phases 20a and 20d: the servers' launches {out['server_launches']}")


def _stream_schedule(T, serving, gates, cfg, p4):
    """bench_serving.py's seeded mixed schedule (arrival offset s, Request),
    with one request a kind for the gate, PIR, heavy hitters and keygen."""
    from distributed_point_functions_tpu_torch.ops import hierarchical

    Request = serving.Request
    rng = np.random.default_rng(cfg["stream_seed"])
    lds, pool = cfg["stream_log_domain"], cfg["stream_pool"]
    dpf = T.DistributedPointFunction.create(T.DpfParameters(lds, T.Int(64)))
    dcf = T.DistributedComparisonFunction.create(lds, T.Int(64))
    alphas = [int(x) for x in rng.integers(0, 1 << lds, size=pool)]
    betas = [[int(x) for x in rng.integers(1, 1000, size=pool)]]
    keys_fd, _ = dpf.generate_keys_batch(alphas, betas, seeds=rng.integers(
        0, 2**32, size=(pool, 2, 4), dtype=np.uint32))
    nd = cfg["stream_dcf_keys"]
    keys_dcf, _ = dcf.generate_keys_batch(
        [int(rng.integers(0, 1 << lds)) for _ in range(nd)], [4242] * nd,
        seeds=rng.integers(0, 2**32, size=(nd, 2, 4), dtype=np.uint32))
    n = cfg["stream_requests"]
    gaps = rng.exponential(cfg["stream_gap_ms"] / 1e3, size=n)
    arrivals = np.cumsum(gaps) - gaps[0]
    sched = []
    for i in range(n):
        kind = rng.integers(0, 3)
        if kind == 0:
            sched.append(Request.full_domain(dpf, [keys_fd[i % pool]]))
        elif kind == 1:
            pts = [int(x) for x in rng.integers(0, 1 << lds, size=8)]
            sched.append(Request.evaluate_at(dpf, [keys_fd[i % pool]], pts))
        else:
            xs = [int(x) for x in rng.integers(0, 1 << lds, size=8)]
            sched.append(Request.dcf(dcf, [keys_dcf[i % nd]], xs))
    sched = list(zip(arrivals.tolist(), sched))
    # One request a kind, spread over the stream.
    span = float(arrivals[-1])
    g = gates.DReluGate.create(cfg["gate_log_group"])
    gkey = g.gen(int(rng.integers(0, g.n)), [int(rng.integers(0, 2))],
                 prng=gates.CounterRng(b"phase-20b"),
                 dcf_seeds=[(int(rng.integers(1, 2**62)), int(rng.integers(1, 2**62)))])[0]
    gxs = [int(x) for x in rng.integers(0, g.n, size=cfg["gate_inputs"])]
    hh_levels = cfg["hh_levels"]
    hdpf = T.DistributedPointFunction.create_incremental(
        [T.DpfParameters(i + 1, T.Int(64)) for i in range(hh_levels)])
    halphas = hierarchical.draw_random_finals(hh_levels, cfg["hh_keys"], rng)
    hkeys, _ = hdpf.generate_keys_batch(
        halphas, [[1] * cfg["hh_keys"]] * hh_levels,
        seeds=rng.integers(0, 2**32, size=(cfg["hh_keys"], 2, 4), dtype=np.uint32))
    finals = hierarchical.draw_random_finals(hh_levels, cfg["hh_nonzeros"],
                                             np.random.default_rng(7))
    hplan = hierarchical.bitwise_hierarchy_plan(hh_levels, finals + halphas)
    kdpf = T.DistributedPointFunction.create(T.DpfParameters(cfg["keygen_log_domain"], T.Int(64)))
    nk = cfg["keygen_keys"]
    extra = [
        Request.gate(g, gkey, gxs),
        Request.pir(p4["dpf"], p4["keys"][0][: cfg["pir_keys"]], p4["db"]),
        Request.hierarchical(hdpf, hkeys, hplan, group=16),
        Request.keygen(kdpf, [int(x) for x in rng.integers(0, 1 << cfg["keygen_log_domain"],
                                                           size=nk)],
                       [[int(x) for x in rng.integers(1, 2**62, size=nk)]]),
    ]
    for frac, req in zip((0.2, 0.4, 0.6, 0.8), extra):
        sched.append((span * frac, req))
    sched.sort(key=lambda ar: ar[0])
    return sched


def _replay(schedule):
    import dataclasses

    from distributed_point_functions_tpu_torch.serving.batcher import ServedFuture

    return [(a, dataclasses.replace(r, future=ServedFuture())) for a, r in schedule]


def _direct_call(door, op, reqs, dev, served):
    """The merged batch's direct entry-point call: the robust wrapper the door
    runs, on the same padded keys and points (the door's key chunk, width
    target and warm PIR database). Returns each request's slice."""
    from distributed_point_functions_tpu_torch.ops import degrade, hierarchical, supervisor
    from distributed_point_functions_tpu_torch.serving import frontdoor as fd
    from distributed_point_functions_tpu_torch.serving import wire

    wt = door.batcher.width_target
    merged = [k for r in reqs for k in r.keys]
    r0 = reqs[0]
    if op == "full_domain":
        ck = door.key_chunk or 32
        out = supervisor.full_domain_evaluate_robust(
            r0.obj, fd._pad_keys(merged, True, chunk=ck), r0.hierarchy_level, key_chunk=ck,
            device=dev)
        return fd.FrontDoor._slice_rows(reqs, out)
    if op in ("evaluate_at", "dcf"):
        points, rows = fd._union([r.points for r in reqs])
        keys = fd._pad_keys(merged, True, floor=wt)
        points = fd._pad_points(points, True, floor=wt)
        if op == "evaluate_at":
            out = degrade.evaluate_at_robust(r0.obj, keys, points, r0.hierarchy_level, device=dev)
        else:
            out = supervisor.batch_evaluate_robust(r0.obj, keys, points, device=dev)
        return fd.FrontDoor._slice_cols(reqs, np.asarray(out), rows)
    if op == "gate":
        xs, rows = fd._union([r.points for r in reqs])
        out = supervisor.gate_batch_eval_robust(r0.obj, r0.keys[0],
                                                fd._pad_points(xs, True, floor=wt), device=dev)
        return [np.asarray(out)[cols] for cols in rows]
    if op == "pir":
        ck = door.key_chunk or 64
        pdb = door.cache.pir_db(r0.obj, r0.db, "lane", device=dev)
        out = supervisor.pir_query_batch_robust(r0.obj, fd._pad_keys(merged, True, chunk=ck), pdb,
                                                key_chunk=ck, device=dev)
        return fd.FrontDoor._slice_rows(reqs, out)
    if op == "hierarchical":
        ctx = hierarchical.BatchedContext.create(r0.obj, fd._pad_keys(merged, True))
        outs = supervisor.evaluate_levels_fused_robust(ctx, r0.plan, r0.group, device=dev)
        res, start = [], 0
        for r in reqs:
            res.append([o[start : start + len(r.keys)] for o in outs])
            start += len(r.keys)
        return res
    # keygen: the served pairs' own seeds reproduce them.
    from distributed_point_functions_tpu_torch.core import uint128

    pairs = [wire.keygen_keys_from_arrays(b) for b in served]
    seeds = np.array([[uint128.to_limbs(a.seed), uint128.to_limbs(b.seed)]
                      for k0, k1 in pairs for a, b in zip(k0, k1)], dtype=np.uint32)
    alphas = [a for r in reqs for a in r.points]
    cols = [[b for r in reqs for b in r.betas[lv]] for lv in range(len(r0.betas))]
    k0, k1 = supervisor.generate_keys_robust(r0.obj, alphas, cols, mode="megakernel",
                                             seeds=seeds, device=dev)
    blobs = wire.keygen_result_arrays(k0, k1, r0.obj.validator.parameters)
    res, off = [], 0
    for r in reqs:
        kr = len(r.points)
        res.append(blobs[off:off + kr] + blobs[len(alphas) + off:len(alphas) + off + kr])
        off += kr
    return res


def _same(a, b) -> bool:
    if isinstance(a, list):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return np.array_equal(np.asarray(a), np.asarray(b))


def _phase_20b(torch, T, dev, p4, cfg, counts, serving, gates, aes_cuda, pir) -> None:
    from distributed_point_functions_tpu_torch.ops import evaluator, hierarchical, keygen_batch

    sched = _stream_schedule(T, serving, gates, cfg, p4)
    mix = collections.Counter(r.op for _, r in sched)
    door_kw = dict(engine="device", max_wait_ms=cfg["stream_wait_ms"],
                   width_target=cfg["stream_width"], key_chunk=cfg["stream_chunk"], device=dev)
    record = []

    def serve(schedule, log):
        """The schedule through one front door: (door, wall, latencies)."""
        door = serving.FrontDoor(**door_kw)
        if log is not None:
            orig = door._run

            def recording_run(reqs, engine, mode, union=None):
                before = {k.name: k.launches for k in aes_cuda.KERNELS}
                res = orig(reqs, engine, mode, union)
                sync(torch, dev)
                log.append(dict(op=reqs[0].op, reqs=list(reqs), out=res, launches=_launch_diff(
                    {k.name: k.launches for k in aes_cuda.KERNELS}, before)))
                return res

            door._run = recording_run
        with door:
            t0 = time.perf_counter()
            futures = []
            for arrival, req in schedule:
                now = time.perf_counter() - t0
                if now < arrival:
                    time.sleep(arrival - now)
                futures.append(door.submit(req))
            for f in futures:
                f.result(timeout=cfg["request_timeout"])
            wall = time.perf_counter() - t0
        lat = [f.completed_at - (t0 + a) for f, (a, _) in zip(futures, schedule)]
        return door, wall, lat

    def naive(schedule):
        t0 = time.perf_counter()
        lat = []
        for arrival, req in schedule:
            now = time.perf_counter() - t0
            if now < arrival:
                time.sleep(arrival - now)
            keys, pts = list(req.keys), list(req.points)
            if req.op == "full_domain":
                evaluator.full_domain_evaluate(req.obj, keys, key_chunk=cfg["stream_chunk"],
                                               device=dev)
            elif req.op == "evaluate_at":
                evaluator.evaluate_at_batch(req.obj, keys, pts, device=dev)
            elif req.op == "dcf":
                req.obj.batch_evaluate(keys, pts, device=dev)
            elif req.op == "gate":
                req.obj.batch_eval(keys[0], pts, device=dev)
            elif req.op == "pir":
                pir.pir_query_batch_chunked(req.obj, keys, req.db, key_chunk=cfg["stream_chunk"],
                                            device=dev)
            elif req.op == "hierarchical":
                ctx = hierarchical.BatchedContext.create(req.obj, keys)
                hierarchical.evaluate_levels_fused(ctx, req.plan, req.group, device=dev)
            else:
                keygen_batch.generate_keys_batch(req.obj, pts, req.betas, device=dev)
            sync(torch, dev)
            lat.append((time.perf_counter() - t0) - arrival)
        return time.perf_counter() - t0, lat

    # Warm both arms untimed: the probes' host oracles, the database layouts.
    t0 = time.perf_counter()
    serve(_replay(sched), None)
    naive([(0.0, r) for _, r in _replay(sched) if r.op in ("pir", "hierarchical", "gate")])
    warm_s = time.perf_counter() - t0
    need = (aes_cuda.K2, aes_cuda.K4, aes_cuda.K6, aes_cuda.K9)
    counts.start()
    door, door_wall, door_lat = serve(_replay(sched), record)
    door_launches = counts.end("20b, the mixed stream through the front door", need)
    counts.start()
    naive_wall, naive_lat = naive(_replay(sched))
    naive_launches = counts.end("20b, the mixed stream one request at a time", need)
    # Every merged batch against the direct call on the same merged batch.
    for b in record:
        before = {k.name: k.launches for k in aes_cuda.KERNELS}
        want = _direct_call(door, b["op"], b["reqs"], dev, b["out"])
        sync(torch, dev)
        got_launches = _launch_diff({k.name: k.launches for k in aes_cuda.KERNELS}, before)
        if not _same(b["out"], want):
            fail(f"20b: a merged {b['op']} batch of {len(b['reqs'])} requests differs from the "
                 "direct call on the same merged batch")
        if got_launches != b["launches"]:
            fail(f"20b: a merged {b['op']} batch launched {b['launches']}, the direct call "
                 f"{got_launches}")
    widths = collections.Counter()
    for b in record:
        widths[(b["op"], sum(r.width for r in b["reqs"]))] += 1
    n = len(sched)
    p50, p95 = _serving_pcts(door_lat)
    q50, q95 = _serving_pcts(naive_lat)
    print(f"phase 20b, bench_serving.py's mixed stream ({n} requests: {dict(mix)}; log-domain "
          f"{cfg['stream_log_domain']}, width {cfg['stream_width']}, max wait "
          f"{cfg['stream_wait_ms']:.0f} ms, key chunk {cfg['stream_chunk']}, undelayed) through "
          f"FrontDoor(engine='device') on {dev}; warm-up {warm_s:.2f} s")
    print(f"phase 20b: front door {n / door_wall:.1f} requests/s ({door_wall * 1e3:.1f} ms), "
          f"latency p50 {p50:.1f} ms, p95 {p95:.1f} ms, {len(record)} merged batches; one "
          f"request at a time {n / naive_wall:.1f} requests/s ({naive_wall * 1e3:.1f} ms), "
          f"p50 {q50:.1f} ms, p95 {q95:.1f} ms; launches door {door_launches}, one at a time "
          f"{naive_launches}")
    print("phase 20b: batch widths (op, width): count "
          + ", ".join(f"{op} {w}: {c}" for (op, w), c in sorted(widths.items())))
    print("phase 20b: the front door's batches in order (op, width, wall ms): "
          + ", ".join(f"{b['op']} {b['width']} {b['seconds'] * 1e3:.1f}" for b in door.batches))
    print(f"phase 20b: every answer equals the direct entry-point call on the same merged batch, "
          f"bit for bit, at the same launch counts, in all {len(record)} batches")


def _phase_20c(torch, T, dev, p4, cfg, serving, tmp) -> dict:
    """20c: the router's anchors. Each op forced onto each device mode at
    phase 20's configurations and onto the host engine at a small shape,
    one warm batch and then the measured one; the rate is the router's own
    reading of that batch (CostModel.observe at this run's dispatch prior).
    Then auto-routed batches on these anchors, their decision records, and
    the learned state through a calibration file."""
    from distributed_point_functions_tpu_torch.ops import evaluator, hierarchical
    from distributed_point_functions_tpu_torch.serving import frontdoor
    from distributed_point_functions_tpu_torch.serving import router as router_mod
    from distributed_point_functions_tpu_torch.utils import telemetry

    Request = serving.Request
    rng = np.random.default_rng(SEED + 21)
    seeds = lambda n: rng.integers(0, 2**32, size=(n, 2, 4), dtype=np.uint32)

    # The dispatch prior: one key at one point, its launch and its pull.
    d1 = T.DistributedPointFunction.create(T.DpfParameters(20, T.Int(64)))
    k1, _ = d1.generate_keys_batch([5], [[1]], seeds=seeds(1))
    times = []
    for _ in range(cfg["dispatch_reps"] + 1):
        sync(torch, dev)
        t = time.perf_counter()
        evaluator.evaluate_at_batch(d1, k1, [5], mode="walkkernel", device=dev)
        times.append(time.perf_counter() - t)
    prior = statistics.median(times[1:])

    def dpf_keys(lds, n, vt=None):
        dpf = T.DistributedPointFunction.create(T.DpfParameters(lds, vt or T.Int(64)))
        alphas = [int(a) for a in rng.integers(0, 1 << min(lds, 62), size=n)]
        beta = (1 << 128) - 1 if vt is not None else [int(b) for b in rng.integers(1, 2**62, size=n)]
        return dpf, dpf.generate_keys_batch(alphas, [beta], seeds=seeds(n))[0]

    def hh(levels, n):
        hdpf = T.DistributedPointFunction.create_incremental(
            [T.DpfParameters(i + 1, T.Int(64)) for i in range(levels)])
        alphas = hierarchical.draw_random_finals(levels, n, rng)
        keys, _ = hdpf.generate_keys_batch(alphas, [[1] * n] * levels, seeds=seeds(n))
        finals = hierarchical.draw_random_finals(levels, cfg["hh_nonzeros"],
                                                 np.random.default_rng(7))
        return [Request.hierarchical(hdpf, keys, hierarchical.bitwise_hierarchy_plan(
            levels, finals + alphas), group=16)]

    def ea(lds, n, p):
        dpf, keys = dpf_keys(lds, n)
        return [Request.evaluate_at(dpf, keys, [int(x) for x in rng.integers(0, 1 << lds, size=p)])]

    def dcf_reqs(lds, n, p):
        dcf = T.DistributedComparisonFunction.create(lds, T.Int(64))
        keys, _ = dcf.generate_keys_batch([int(a) for a in rng.integers(0, 1 << lds, size=n)],
                                          [int(b) for b in rng.integers(1, 2**62, size=n)],
                                          seeds=seeds(n))
        return [Request.dcf(dcf, keys, [int(x) for x in rng.integers(0, 1 << lds, size=p)])]

    def kg(lds, n):
        dpf = T.DistributedPointFunction.create(T.DpfParameters(lds, T.Int(64)))
        return [Request.keygen(dpf, [int(a) for a in rng.integers(0, 1 << lds, size=n)],
                               [[int(b) for b in rng.integers(1, 2**62, size=n)]])]

    def pir_host(lds, n):
        dpf, keys = dpf_keys(lds, n, T.XorWrapper(128))
        db = rng.integers(0, 2**32, size=(1 << lds, 4), dtype=np.uint32)
        return [Request.pir(dpf, keys, db)]

    (fd_dev, fd_host), (ea_dev, ea_host) = cfg["anchor_fd"], cfg["anchor_ea"]
    (dcf_dev, dcf_host), (hh_dev, hh_host) = cfg["anchor_dcf"], cfg["anchor_hh"]
    kg_dev, kg_host = cfg["anchor_kg"]
    cases = {  # op: (device modes, device requests, host requests, door key chunk)
        "full_domain": (("levels",), [Request.full_domain(*dpf_keys(*fd_dev))],
                        [Request.full_domain(*dpf_keys(*fd_host))], None),
        "evaluate_at": (("walk", "walkkernel"), ea(*ea_dev), ea(*ea_host), None),
        "dcf": (("walk", "walkkernel"), dcf_reqs(*dcf_dev), dcf_reqs(*dcf_host), None),
        "pir": (("fold", "megakernel"),
                [Request.pir(p4["dpf"], p4["keys"][0], p4["db"])],
                pir_host(*cfg["anchor_pir_host"]), KEY_CHUNK),
        "hierarchical": (("fused", "hierkernel"), hh(*hh_dev), hh(*hh_host), None),
        "keygen": (("perlevel", "megakernel"), kg(*kg_dev), kg(*kg_host), None),
    }

    def fresh(reqs):
        return _replay([(0.0, r) for r in reqs])

    anchors, rows = {}, []
    for op, (modes, dev_reqs, host_reqs, ck) in cases.items():
        for engine, mode, reqs in ([("device", m, dev_reqs) for m in modes]
                                   + [("host", None, host_reqs)]):
            door = serving.FrontDoor(engine=engine, mode=mode, device=dev, key_chunk=ck,
                                     max_wait_ms=1.0)
            # A first batch warms the mode (the probe's oracle, its layouts), uncounted.
            for _ in range(2):
                door.serve([r for _, r in fresh(reqs)], timeout=cfg["request_timeout"])
            b = door.batches[-1]
            union = (frontdoor._union([r.points for r in reqs]) if op in ("evaluate_at", "dcf")
                     else None)
            w = door._workload(reqs, union)
            model = router_mod.CostModel(dispatch_seconds=prior, anchors={})
            model.observe(w, engine, mode, b["seconds"])
            (rate,) = model.learned.values()
            anchors[(op, engine, mode)] = {w.value_kind: rate}
            rows.append((op, engine, mode, w.value_kind, w.work_items(engine), b["seconds"],
                         rate))
    for op, engine, mode, kind, items, secs, rate in rows:
        committed = router_mod.ANCHORS.get((op, engine, mode), {}).get(kind)
        print(f"phase 20c, anchor {op} {engine}{'/' + mode if mode else ''} ({kind}): "
              f"{items:.6g} items in {secs * 1e3:.2f} ms = {rate:.4e} items/s"
              + (f" (router.py: {committed:.4e})" if committed else " (router.py: none)"))
    print(f"phase 20c, dispatch prior (evaluate_at_batch, one key, one point, walkkernel, "
          f"median of {cfg['dispatch_reps']}): {prior * 1e3:.4f} ms (router.py: "
          f"{router_mod.DISPATCH_SECONDS_PRIOR * 1e3:.4f} ms)")
    print("phase 20c, anchors as router.py writes them: " + repr(
        {k: {kk: float(f"{vv:.4g}") for kk, vv in v.items()} for k, v in anchors.items()}))

    # Auto-routed batches on this run's anchors, and the calibration file.
    calib = os.path.join(tmp, "router_calib.json")
    router = router_mod.Router(model=router_mod.CostModel(dispatch_seconds=prior,
                                                          anchors=anchors), calibration=calib)
    for op, (modes, dev_reqs, host_reqs, ck) in cases.items():
        for what, reqs in (("wide", dev_reqs), ("small", host_reqs)):
            door = serving.FrontDoor(router=router, device=dev, key_chunk=ck, max_wait_ms=1.0)
            with telemetry.capture() as tel:
                door.serve([r for _, r in fresh(reqs)], timeout=cfg["request_timeout"])
            (rec,) = tel.decision_records(source="router")
            d = rec["data"]
            print(f"phase 20c, auto-routed {op} ({what}): decision(source='router') choice "
                  f"{d['choice']}, predicted {d['predicted_ms']} ms, costs {d['costs_ms']}, "
                  f"ran in {door.batches[-1]['seconds'] * 1e3:.2f} ms")
    router.save_calibration()
    back = router_mod.Router(model=router_mod.CostModel(anchors=anchors), calibration=calib)
    if back.model.state() != router.model.state():
        fail("20c: the calibration file did not read back to the same state")
    state = router.model.state()
    print(f"phase 20c: the learned state ({len(state['learned'])} rates, dispatch EWMA "
          f"{state['dispatch_ewma']}) written to a calibration file and read back equal")
    return anchors


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a CUDA card")
    try:
        import distributed_point_functions_tpu_torch as T
        from distributed_point_functions_tpu_torch.ops import (
            aes_cuda, aes_torch, backend_torch, evaluator, value_codec,
        )
        from distributed_point_functions_tpu_torch.dcf import batch as dcf_batch
        from distributed_point_functions_tpu_torch.ops import hier_cases, hierarchical, keygen_batch
        from distributed_point_functions_tpu_torch.parallel import pir
    except ImportError as e:
        fail(f"the port is not in this checkout: {e}")

    from distributed_point_functions_tpu_torch.utils import integrity

    events = EventLog(integrity)
    dev = torch.device("cuda")
    key_planes = {
        t: int(np.count_nonzero(backend_torch._rk_np(t))) for t in ("left", "right", "value")
    }
    key_planes["left_or_right"] = int(np.count_nonzero(
        backend_torch._rk_np("left") | backend_torch._rk_np("right")))
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
          f"{sys.version.split()[0]}, {kind} x{torch.cuda.device_count()}")

    # -- 1. build ---------------------------------------------------------
    t0 = time.perf_counter()
    aes_cuda.library()
    print(f"build: csrc/{' + csrc/'.join(aes_cuda.SOURCES)} for sm_90a in "
          f"{time.perf_counter() - t0:.1f} s")
    if sys.argv[1:] == ["--phase", "20"]:
        # Phase 20 alone (a development aid; the check runs every phase):
        # phase 4's database and queries made the way phase 4 makes them.
        rng = np.random.default_rng(SEED)
        pdpf = T.DistributedPointFunction.create(T.DpfParameters(LOG_DOMAIN, T.XorWrapper(128)))
        db = rng.integers(0, 2**32, size=(1 << LOG_DOMAIN, 4), dtype=np.uint32)
        targets = [int(a) for a in rng.integers(0, 1 << LOG_DOMAIN, size=PIR_QUERIES)]
        keys = pdpf.generate_keys_batch(targets, [(1 << 128) - 1], seeds=rng.integers(
            0, 2**32, size=(PIR_QUERIES, 2, 4), dtype=np.uint32))
        served = PathCounts(aes_cuda)
        phase_20(torch, T, dev, dict(dpf=pdpf, db=db, targets=targets, keys=keys), PHASE20,
                 served, card)
        print(f"phase 20: launches {served.total}")
        print(card)
        return
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
    rnd = word_source(torch, g)
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
        args = expand_args(rnd, k, w)
        hold("K2", aes_cuda.expand_one_level(*args), backend_torch.expand_one_level(*args))
        hold("K3", aes_cuda.expand_and_hash_last_level(*args),
             backend_torch.expand_and_hash_last_level(*args))
        hold("K4", aes_cuda.hash_value_planes(args[0]),
             backend_torch.hash_value_planes(args[0]))
    print(f"kernels vs plain at W = 1, 3, 1037 (exact): {checks}")

    rows = {}
    args = expand_args(rnd, KEY_CHUNK, max_w)
    planes2 = rnd(KEY_CHUNK, 128, 2 * max_w)
    out_bytes = planes_bytes(KEY_CHUNK, 2 * max_w)
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
        ms, device_ms = launch_ms(torch, call, out_bytes)
        plain_ms = time_ms(torch, plain, 2)
        b_ms, b_by = bound_ms(*cost)
        rows[name] = dict(kernel=kern, ms=ms, device_ms=device_ms, plain_ms=plain_ms,
                          bound_ms=b_ms, bound_by=b_by)
        print(f"{name} at K={KEY_CHUNK}, W={max_w if name != 'K4' else 2 * max_w}: "
              f"{ms:.4f} ms (device {device_ms:.4f} ms; plain {plain_ms:.2f} ms, "
              f"bound {b_ms:.4f} ms by {b_by}); {kern.ptxas}")
    del args, planes2
    print_ptxas("K2/K3", (aes_cuda.K2, aes_cuda.K3))
    # K5 against its plain version: a tiny ragged plan (one-word slabs,
    # fold width 4), a multi-slab plan with a database, and 8 keys at the
    # main path's full plan; then timed at the main path's chunk.
    def mk_plan(lds, vt, budget=evaluator.MEGAKERNEL_BUDGET):
        d = T.DistributedPointFunction.create(T.DpfParameters(lds, vt))
        return evaluator.plan_megakernel(d, budget=budget)

    def mk_args(plan, k, bits, with_db):
        levels = plan.levels_a + plan.levels_b
        lpe = bits // 32
        return (rnd(k, 128, plan.entry_words), rnd(k, plan.entry_words),
                rnd(k, levels, 128), rnd(k, levels), rnd(k, levels),
                rnd(k, 128 // bits, lpe),
                rnd((128 // bits) * lpe * 32, plan.num_slabs * plan.final_words)
                if with_db else None)

    main_plan = mk_plan(LOG_DOMAIN, T.Int(64))
    for plan, k, vt, party, with_db in (
        (mk_plan(12, T.Int(64), 16384), 5, T.Int(64), 1, False),
        (mk_plan(16, T.XorWrapper(128)), 5, T.XorWrapper(128), 0, True),
        (main_plan, 8, T.Int(64), 1, False),
    ):
        bits = vt.bitsize
        kw = dict(plan=plan, bits=bits, party=party,
                  xor_group=isinstance(vt, T.XorWrapper), keep=128 // bits)
        a = mk_args(plan, k, bits, with_db)
        hold("K5", aes_cuda.megakernel_fold(*a, **kw), backend_torch.megakernel_fold(*a, **kw))
        print(f"K5 == plain at K={k}, {vt}, party {party}, db {with_db}: {plan}")
    kw = dict(plan=main_plan, bits=64, party=0, xor_group=False, keep=2)
    a = mk_args(main_plan, KEY_CHUNK, 64, False)
    want = backend_torch.megakernel_fold(*a, **kw)
    hold("K5", aes_cuda.megakernel_fold(*a, **kw), want)
    hold("K5", aes_cuda.megakernel_fold(*a, **kw, blocks_per_key=1), want)
    ms = time_ms(torch, lambda: aes_cuda.megakernel_fold(*a, **kw), 5)
    plain_ms = time_ms(torch, lambda: backend_torch.megakernel_fold(*a, **kw), 1)
    b_ms, b_by = bound_ms(*megakernel_cost(key_planes, main_plan, KEY_CHUNK, 64, 2, 0, False, False))
    rows["K5"] = dict(kernel=aes_cuda.K5, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
    print(f"K5 at K={KEY_CHUNK}, log-domain {LOG_DOMAIN} Int(64) full plan: {ms:.4f} ms "
          f"(plain {plain_ms:.2f} ms, bound {b_ms:.4f} ms by {b_by}); {aes_cuda.K5.ptxas}")
    k5 = aes_cuda.K5.ptxas
    print(f"K5 ptxas: {k5.get('registers')} registers, {k5.get('spill_stores')} B spill "
          f"stores, {k5.get('spill_loads')} B spill loads")
    k5_probe(torch, a, kw, KEY_CHUNK, ms, dev, "the fold's plan")
    del a, want
    torch.cuda.empty_cache()

    def hold_expand(a):
        hold("K2", aes_cuda.expand_one_level(*a), backend_torch.expand_one_level(*a))
        hold("K3", aes_cuda.expand_and_hash_last_level(*a),
             backend_torch.expand_and_hash_last_level(*a))

    k2_times = k2_width_times(
        torch, aes_cuda, rnd, [1 << lv for lv in range(max(vt_levels.values()) - HOST_LEVELS)],
        hold_expand)
    k2_widths = {w: round(t[0], 4) for w, t in k2_times.items()}
    print(f"K2 and K3 == plain at every width of the fold (exact); K2 ms per input width "
          f"at K={KEY_CHUNK}: {json.dumps(k2_widths)}; device ms: "
          f"{json.dumps({w: round(t[1], 4) for w, t in k2_times.items()})}; bound ms: "
          + json.dumps({w: round(bound_ms(*expand_cost(key_planes, KEY_CHUNK, w, False))[0], 4)
                        for w in k2_widths}))
    torch.cuda.empty_cache()

    # -- 3. the main path: full-domain fold ---------------------------------
    rng = np.random.default_rng(SEED)
    dpf = T.DistributedPointFunction.create(T.DpfParameters(LOG_DOMAIN, T.Int(64)))
    alphas = [int(a) for a in rng.integers(0, 1 << LOG_DOMAIN, size=NUM_KEYS)]
    betas = [int(b) for b in rng.integers(1, 2**63, size=NUM_KEYS, dtype=np.uint64)]
    seeds = rng.integers(0, 2**32, size=(NUM_KEYS, 2, 4), dtype=np.uint32)
    t0 = time.perf_counter()
    keys = dpf.generate_keys_batch(alphas, [betas], seeds=seeds)
    fold_case = dict(dpf=dpf, keys=keys)  # phase 19 runs them again
    print(f"keygen: {NUM_KEYS} Int(64) key pairs at log-domain {LOG_DOMAIN} in "
          f"{time.perf_counter() - t0:.2f} s (host)")

    def fold_pass(party_keys, path):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = [
            fold[:valid]
            for valid, fold in evaluator.full_domain_fold_chunks(
                dpf, party_keys, key_chunk=KEY_CHUNK, fuse_last_hash=path == "fused",
                mode="megakernel" if path == "megakernel" else "fold",
            )
        ]
        folds = aes_torch.from_words(torch.cat(out))
        return folds, time.perf_counter() - t

    main_launches = {}
    results = {}
    chunks = NUM_KEYS // KEY_CHUNK
    path_kernels = {
        "default": (aes_cuda.K2, aes_cuda.K4),
        "fused": (aes_cuda.K2, aes_cuda.K3),
        "megakernel": (aes_cuda.K5,),
    }
    evals_per_s = {}
    for path, need in path_kernels.items():
        aes_cuda.reset_launch_counts()
        for party in (0, 1):
            results[(path, party)] = fold_pass(keys[party], path)
        counts = {k.name: k.launches for k in aes_cuda.KERNELS}
        for kern in need:
            if kern.launches == 0:
                fail(f"{path} path ran without launching {kern.name}")
            main_launches[kern.name] = main_launches.get(kern.name, 0) + kern.launches
        if path == "megakernel" and counts != {
            k.name: (2 * chunks if k is aes_cuda.K5 else 0) for k in aes_cuda.KERNELS
        }:
            fail(f"the megakernel path must launch K5 once per chunk and nothing "
                 f"else; launches {counts}")
        secs = [results[(path, p)][1] for p in (0, 1)]
        evals_per_s[path] = NUM_KEYS * 2**LOG_DOMAIN / min(secs)
        print(f"fold, {path} path: {NUM_KEYS} keys x 2^{LOG_DOMAIN} per party in "
              f"{secs[0]:.3f} s / {secs[1]:.3f} s = "
              f"{evals_per_s[path]:.4e} evals/s; launches {counts}")
    print(f"fold evals/s, megakernel / default path: "
          f"{evals_per_s['megakernel']:.4e} / {evals_per_s['default']:.4e}")
    # The AES work of one default-path pass, against the card's bound.
    levels = LOG_DOMAIN - 1 - HOST_LEVELS
    pass_gates = chunks * (
        sum(expand_cost(key_planes, KEY_CHUNK, 1 << lv, False)[1] for lv in range(levels))
        + hash_cost(key_planes, KEY_CHUNK, 1 << levels)[1]
    )
    pass_bound, _ = bound_ms(0, pass_gates)
    print(f"fold pass: {pass_gates:.4e} two-input gates of AES work, bound "
          f"{pass_bound:.1f} ms by operations")
    for party in (0, 1):
        for path in ("fused", "megakernel"):
            if not np.array_equal(results[("default", party)][0], results[(path, party)][0]):
                fail(f"default and {path} folds differ (party {party})")
        # The plain path on the card, for the first 8 keys of the first chunk.
        kb = evaluator.KeyBatch.from_keys(dpf, keys[party][:8], device=dev)
        ch = evaluator._prepare_chunk(kb, 8, HOST_LEVELS, 64)
        want = aes_torch.from_words(evaluator._fold_chunk(
            ch, None, LOG_DOMAIN - 1 - HOST_LEVELS, 64, party, False, 2, False,
            ops=backend_torch,
        ))
        if not np.array_equal(results[("default", party)][0][:8], want):
            fail(f"kernel folds differ from the plain path on the card (party {party})")
    print("fold: default == fused == megakernel for every key; kernels == plain "
          "path for 8 keys per party")

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
    mk_chunk_ms = time_ms(torch, lambda: evaluator._megakernel_fold_chunk(
        ch, None, main_plan, 64, 0, False, 2), 3)
    print(f"one chunk ({KEY_CHUNK} keys): host prep + upload {prep_s * 1e3:.1f} ms, "
          f"device {chunk_ms:.1f} ms of which pack + K2 x {levels} + K4 "
          f"{kern_ms:.1f} ms, unpack/correct/fold {chunk_ms - kern_ms:.1f} ms; "
          f"megakernel mode device {mk_chunk_ms:.1f} ms (pack, K5, final XOR)")
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
    t = time.perf_counter()
    prepared_mk = pir.prepare_pir_database(pdpf, db, order="megakernel")
    print(f"PIR: the same database in megakernel order ({prepared_mk.plan}) "
          f"prepared in {time.perf_counter() - t:.2f} s")
    # K5 against its plain version at the PIR path's own shape: its plan,
    # its database rows and a full chunk of queries.
    pplan = prepared_mk.plan
    kw = dict(plan=pplan, bits=128, party=1, xor_group=True, keep=1)
    a = mk_args(pplan, PIR_QUERIES, 128, False)[:6] + (prepared_mk.lane_db,)
    want = backend_torch.megakernel_fold(*a, **kw)
    hold("K5", aes_cuda.megakernel_fold(*a, **kw), want)
    hold("K5", aes_cuda.megakernel_fold(*a, **kw, blocks_per_key=1), want)
    ms = time_ms(torch, lambda: aes_cuda.megakernel_fold(*a, **kw), 5)
    plain_ms = time_ms(torch, lambda: backend_torch.megakernel_fold(*a, **kw), 1)
    b_ms, b_by = bound_ms(*megakernel_cost(key_planes, pplan, PIR_QUERIES, 128, 1, 1, True, True))
    print(f"K5 == plain at K={PIR_QUERIES}, log-domain {LOG_DOMAIN} XorWrapper(128) PIR "
          f"plan with the database: {ms:.4f} ms (plain {plain_ms:.2f} ms, bound "
          f"{b_ms:.4f} ms by {b_by})")
    k5_probe(torch, a, kw, PIR_QUERIES, ms, dev, "the PIR plan")
    del a, want
    pir_answers = {}
    for mode, pdb, need in (("fold", prepared, (aes_cuda.K2, aes_cuda.K4)),
                            ("megakernel", prepared_mk, (aes_cuda.K5,))):
        aes_cuda.reset_launch_counts()
        answers = []
        for q in (qa, qb):
            torch.cuda.synchronize()
            t = time.perf_counter()
            answers.append(pir.pir_query_batch_chunked(
                pdpf, q, pdb, key_chunk=KEY_CHUNK if mode == "megakernel" else 64,
                mode=mode,
            ))
            secs = time.perf_counter() - t
            print(f"PIR, mode {mode}: {PIR_QUERIES} queries in {secs:.3f} s = "
                  f"{PIR_QUERIES / secs:.1f} queries/s")
        for kern in need:
            if kern.launches == 0:
                fail(f"PIR mode {mode} ran without launching {kern.name}")
            main_launches[kern.name] = main_launches.get(kern.name, 0) + kern.launches
        if mode == "megakernel" and aes_cuda.K5.launches != 2 * (PIR_QUERIES // KEY_CHUNK):
            fail(f"PIR mode megakernel: {aes_cuda.K5.launches} K5 launches, one per "
                 "chunk expected")
        rec = answers[0] ^ answers[1]
        if not np.array_equal(rec, db[targets]):
            bad = int((rec != db[targets]).any(axis=1).sum())
            fail(f"PIR mode {mode}: {bad} of {PIR_QUERIES} answers do not "
                 "reconstruct their record")
        pir_answers[mode] = answers
    for a, b in zip(pir_answers["fold"], pir_answers["megakernel"]):
        if not np.array_equal(a, b):
            fail("PIR answers of mode fold and mode megakernel differ")
    print(f"PIR: all {PIR_QUERIES} answers reconstruct (ra ^ rb == db[alpha]) in "
          f"both modes, and the modes agree; main-path launches {main_launches}")

    # Phase 18 runs mode walk on this database against these answers.
    p4 = dict(dpf=pdpf, db=db, targets=targets, keys=(qa, qb), fold=pir_answers["fold"])
    del prepared, prepared_mk
    torch.cuda.empty_cache()

    # -- 5. the walk kernels K6 and K7 against their plain versions ----------
    # Full width: EvaluateAt's main path, 1024 keys x 4096 points = 128 words
    # at log-domain 32, where Int(64) packs 2 elements a block: 31 levels.
    ew = EVAL_POINTS // 32
    elevels = EVAL_LOG_DOMAIN - 1

    def walk_level_args(k, w):
        return rnd(k, 128, w), rnd(k, w), rnd(w), rnd(k, 128), rnd(k), rnd(k)

    def walk_mk_args(k, w, levels, bits, keep):
        return (rnd(k, 128), rnd(levels, w), rnd(k, levels, 128), rnd(k, levels),
                rnd(k, levels), rnd(k, 128 // bits, bits // 32), rnd(keep, w))

    for k, w in ((5, 1), (5, 3), (KEY_CHUNK, 1000 + 37)):
        a = walk_level_args(k, w)
        hold("K6", aes_cuda.walk_level(*a), backend_torch.walk_level(*a))
        hold("K4", aes_cuda.hash_value_planes(a[0]), backend_torch.hash_value_planes(a[0]))
    # K7 runs eight (key, word) items a warp: every K x W here but the
    # last leaves a warp that straddles the end.
    walk_cases = (
        (T.Int(32), 4, 1, 5, 1, 3), (T.Int(64), 2, 0, 5, 3, 5), (T.Int(64), 1, 1, 5, 37, 2),
        (T.XorWrapper(128), 1, 1, 5, 3, 4), (T.Int(128), 1, 0, 5, 37, 6),
        (T.Int(64), 2, 1, 5, 1037, 3), (T.Int(64), 2, 1, 7, 13, 4), (T.Int(32), 2, 0, 3, 8, 2),
    )
    for vt, keep, party, k, w, levels in walk_cases:
        kw = dict(bits=vt.bitsize, party=party, xor_group=isinstance(vt, T.XorWrapper), keep=keep)
        a = walk_mk_args(k, w, levels, vt.bitsize, keep)
        hold("K7", aes_cuda.walk_megakernel(*a, **kw), backend_torch.walk_megakernel(*a, **kw))
    print(f"K6 and K4 == plain at K x W = 5 x 1, 5 x 3, {KEY_CHUNK} x 1037 (5 and 15 "
          f"items leave a warp of 8 items part-filled); K7 == plain at {len(walk_cases)} "
          "shapes (Int(32) keep 4 and 2, Int(64) keep 1 and 2, XorWrapper(128), Int(128), "
          "both parties; K x W = 5, 15, 185, 5185, 91 items, not a multiple of a warp's 8, "
          "and 24)")

    a = walk_level_args(EVAL_KEYS, ew)
    hold("K6", aes_cuda.walk_level(*a), backend_torch.walk_level(*a))
    ms, device_ms = launch_ms(torch, lambda: aes_cuda.walk_level(*a), a[0].numel() * 4)
    plain_ms = time_ms(torch, lambda: backend_torch.walk_level(*a), 2)
    b_ms, b_by = bound_ms(*walk_level_cost(key_planes, EVAL_KEYS, ew))
    rows["K6"] = dict(kernel=aes_cuda.K6, ms=ms, device_ms=device_ms,
                      plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
    print(f"K6 at K={EVAL_KEYS}, W={ew}: {ms:.4f} ms (device "
          f"{device_ms:.4f} ms; plain {plain_ms:.2f} ms, bound {b_ms:.4f} ms by {b_by}); "
          f"{aes_cuda.K6.ptxas}")
    planes_w = a[0]
    hold("K4", aes_cuda.hash_value_planes(planes_w), backend_torch.hash_value_planes(planes_w))
    ms, device_ms = launch_ms(torch, lambda: aes_cuda.hash_value_planes(planes_w),
                             planes_w.numel() * 4)
    plain_ms = time_ms(torch, lambda: backend_torch.hash_value_planes(planes_w), 2)
    b_ms, b_by = bound_ms(*hash_cost(key_planes, EVAL_KEYS, ew))
    rows["K4 walk"] = dict(kernel=aes_cuda.K4, ms=ms, device_ms=device_ms,
                           plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
    print(f"K4 at the walk's shape K={EVAL_KEYS}, W={ew}: {ms:.4f} ms (device "
          f"{device_ms:.4f} ms; plain {plain_ms:.2f} ms, bound {b_ms:.4f} ms by {b_by})")
    print_ptxas("K4", (aes_cuda.K4,))
    print_ptxas("K6", (aes_cuda.K6,))
    del a, planes_w
    kw = dict(bits=64, party=1, xor_group=False, keep=2)
    a = walk_mk_args(EVAL_KEYS, ew, elevels, 64, 2)
    hold("K7", aes_cuda.walk_megakernel(*a, **kw), backend_torch.walk_megakernel(*a, **kw))
    plain_ms = time_ms(torch, lambda: backend_torch.walk_megakernel(*a, **kw), 1)
    ms, device_ms = launch_ms(torch, lambda: aes_cuda.walk_megakernel(*a, **kw),
                              4 * EVAL_KEYS * 64 * ew, 5)
    b_ms, b_by = bound_ms(*walk_megakernel_cost(key_planes, EVAL_KEYS, ew, elevels, 64, 2, 1, False))
    rows["K7"] = dict(kernel=aes_cuda.K7, ms=ms, device_ms=device_ms, plain_ms=plain_ms,
                      bound_ms=b_ms, bound_by=b_by)
    print(f"K7 at K={EVAL_KEYS}, W={ew}, L={elevels}, Int(64) keep 2, party 1: {ms:.4f} ms "
          f"(device {device_ms:.4f} ms; plain {plain_ms:.2f} ms, bound {b_ms:.4f} ms by {b_by}); "
          f"{aes_cuda.K7.ptxas}")
    del a
    torch.cuda.empty_cache()

    # -- 6. the main path: batched EvaluateAt ---------------------------------
    edpf = T.DistributedPointFunction.create(T.DpfParameters(EVAL_LOG_DOMAIN, T.Int(64)))
    if edpf.validator.hierarchy_to_tree[0] != elevels:
        fail(f"log-domain {EVAL_LOG_DOMAIN} Int(64) should have {elevels} tree levels")
    ealphas = [int(x) for x in rng.integers(0, 1 << EVAL_LOG_DOMAIN, size=EVAL_KEYS)]
    ebetas = [int(b) for b in rng.integers(1, 2**63, size=EVAL_KEYS, dtype=np.uint64)]
    eseeds = rng.integers(0, 2**32, size=(EVAL_KEYS, 2, 4), dtype=np.uint32)
    t = time.perf_counter()
    ekeys = edpf.generate_keys_batch(ealphas, [ebetas], seeds=eseeds)
    print(f"keygen: {EVAL_KEYS} Int(64) key pairs at log-domain {EVAL_LOG_DOMAIN} in "
          f"{time.perf_counter() - t:.2f} s (host)")
    points = ealphas + [
        int(x) for x in rng.integers(0, 1 << EVAL_LOG_DOMAIN, size=EVAL_POINTS - EVAL_KEYS)
    ]
    walk_kernels = {"walk": (aes_cuda.K6, aes_cuda.K4), "walkkernel": (aes_cuda.K7,)}
    want_counts = {
        "walk": {aes_cuda.K6.name: 2 * elevels, aes_cuda.K4.name: 2},
        "walkkernel": {aes_cuda.K7.name: 2},
    }
    evals = {}
    walk_launches = {}
    for mode, need in walk_kernels.items():
        aes_cuda.reset_launch_counts()
        secs = []
        for party in (0, 1):
            torch.cuda.synchronize()
            t = time.perf_counter()
            evals[(mode, party)] = evaluator.evaluate_at_batch(
                edpf, ekeys[party], points, mode=mode)
            secs.append(time.perf_counter() - t)
        counts = {k.name: k.launches for k in aes_cuda.KERNELS}
        for kern in need:
            if kern.launches == 0:
                fail(f"EvaluateAt mode {mode} ran without launching {kern.name}")
            main_launches[kern.name] = main_launches.get(kern.name, 0) + kern.launches
            walk_launches[kern.name] = walk_launches.get(kern.name, 0) + kern.launches
        if counts != {k.name: want_counts[mode].get(k.name, 0) for k in aes_cuda.KERNELS}:
            fail(f"EvaluateAt mode {mode}: launches {counts}, expected "
                 f"{want_counts[mode]} for one chunk per party")
        rates = [EVAL_KEYS * EVAL_POINTS / x for x in secs]
        print(f"EvaluateAt, mode {mode}: {EVAL_KEYS} keys x {EVAL_POINTS} points per party in "
              f"{secs[0]:.3f} s / {secs[1]:.3f} s = {rates[0]:.4e} / {rates[1]:.4e} "
              f"points/s; launches {counts}")
    hit = np.array(ealphas)[:, None] == np.array(points)[None, :]
    beta_at = np.where(hit, np.array(ebetas, np.uint64)[:, None], np.uint64(0))
    for mode in walk_kernels:
        total = (evaluator.values_to_numpy(evals[(mode, 0)], 64)
                 + evaluator.values_to_numpy(evals[(mode, 1)], 64))
        if not np.array_equal(total, beta_at):
            bad = int((total != beta_at).sum())
            fail(f"EvaluateAt mode {mode}: {bad} share pairs do not reconstruct")
    t = time.perf_counter()
    for party in (0, 1):
        if not np.array_equal(evals[("walk", party)], evals[("walkkernel", party)]):
            fail(f"EvaluateAt modes walk and walkkernel differ (party {party})")
        for i in range(ORACLE_KEYS):
            host = np.array(edpf.evaluate_at(ekeys[party][i], 0, points), dtype=np.uint64)
            if not np.array_equal(evaluator.values_to_numpy(evals[("walk", party)][i], 64), host):
                fail(f"EvaluateAt differs from the host dpf.evaluate_at (key {i}, party {party})")
    print(f"EvaluateAt: every share pair reconstructs (r0 + r1 == beta at alpha, 0 elsewhere) "
          f"in both modes, the modes agree, and the host dpf.evaluate_at equals them for "
          f"{ORACLE_KEYS} keys per party ({time.perf_counter() - t:.2f} s on the host)")
    # Where one pass's time goes (party 0): host preparation through the
    # entry point's own helpers, then each mode's device part on the
    # prepared chunk, held against the entry point's result.
    torch.cuda.synchronize()
    t = time.perf_counter()
    kb = evaluator.KeyBatch.from_keys(edpf, ekeys[0], device=dev)
    wch = evaluator.prepare_walk_chunk(kb, 64)
    wpts = {mode: evaluator.prepare_walk_points(edpf, points, mode=mode, device=dev)
            for mode in walk_kernels}
    torch.cuda.synchronize()
    eprep_s = time.perf_counter() - t
    pass_ms = {}
    for mode, wp in wpts.items():
        pass_ms[mode] = time_ms(torch, lambda: evaluator.evaluate_walk_chunk(wch, wp), 3)
        got = evaluator.evaluate_walk_chunk(wch, wp)
        if not np.array_equal(aes_torch.from_words(got), evals[(mode, 0)]):
            fail(f"the timed {mode} chunk differs from the entry point's result")
    print(f"one EvaluateAt pass ({EVAL_KEYS} keys, party 0): host KeyBatch + tables + upload "
          f"{eprep_s * 1e3:.1f} ms; device, mode walk {pass_ms['walk']:.2f} ms (K6 x {elevels} "
          f"+ K4 + unpack/correct/select), mode walkkernel {pass_ms['walkkernel']:.2f} ms (K7 "
          f"+ transpose) at {wpts['walkkernel'].path_masks.shape[1]} lane words")
    del evals, wch, got
    # The codec walk: IntModN(64) keys (a tree as deep as the domain, one
    # element a block), one K6 launch a level and one K4.
    mrng = np.random.default_rng(SEED + CODEC_WALK_LOG_DOMAIN)
    mdpf = T.DistributedPointFunction.create(
        T.DpfParameters(CODEC_WALK_LOG_DOMAIN, T.IntModN(64, C3_MODULUS)))
    malphas = [int(x) for x in mrng.integers(0, 1 << CODEC_WALK_LOG_DOMAIN,
                                             size=CODEC_WALK_KEYS)]
    mbetas = [int(x) % C3_MODULUS for x in mrng.integers(1, 2**63, size=CODEC_WALK_KEYS)]
    mkeys = mdpf.generate_keys_batch(
        malphas, [mbetas], seeds=mrng.integers(0, 2**32, size=(CODEC_WALK_KEYS, 2, 4),
                                               dtype=np.uint32))
    mpoints = malphas + [int(x) for x in mrng.integers(
        0, 1 << CODEC_WALK_LOG_DOMAIN, size=CODEC_WALK_POINTS - CODEC_WALK_KEYS)]
    mlevels = mdpf.validator.hierarchy_to_tree[0]
    aes_cuda.reset_launch_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    mvals = [evaluator.evaluate_at_batch(mdpf, mkeys[p], mpoints) for p in (0, 1)]
    codec_walk_s = time.perf_counter() - t
    counts = {k.name: k.launches for k in aes_cuda.KERNELS}
    want = {aes_cuda.K6.name: 2 * mlevels, aes_cuda.K4.name: 2}
    if counts != {k.name: want.get(k.name, 0) for k in aes_cuda.KERNELS}:
        fail(f"the codec walk: launches {counts}, expected {want}")
    codec_walk_launches = counts
    for kern in (aes_cuda.K6, aes_cuda.K4):
        main_launches[kern.name] = main_launches.get(kern.name, 0) + kern.launches
    total = (evaluator.values_to_numpy(mvals[0], 64).astype(object)
             + evaluator.values_to_numpy(mvals[1], 64).astype(object)) % C3_MODULUS
    mhit = np.array(malphas)[:, None] == np.array(mpoints)[None, :]
    if not np.array_equal(total, np.where(mhit, np.array(mbetas, dtype=object)[:, None], 0)):
        fail("the codec walk: share pairs do not reconstruct mod N")
    for party in (0, 1):
        for i in range(2):
            host = mdpf.evaluate_at(mkeys[party][i], 0, mpoints)
            if list(evaluator.values_to_numpy(mvals[party][i], 64)) != host:
                fail(f"the codec walk differs from the host dpf.evaluate_at (key {i}, "
                     f"party {party})")
    print(f"EvaluateAt's codec walk: {CODEC_WALK_KEYS} IntModN(64, 2^64 - 59) key pairs at "
          f"log-domain {CODEC_WALK_LOG_DOMAIN} x {CODEC_WALK_POINTS} points holding every alpha, "
          f"mode walk, both parties in {codec_walk_s:.3f} s; launches {counts}; (r0 + r1) mod N "
          f"== beta at alpha and 0 elsewhere, and the host dpf.evaluate_at equals 2 keys a party")
    del mvals, mkeys
    torch.cuda.empty_cache()

    # -- 7. K7's DCF form against its plain version --------------------------
    # BASELINE config 4: log-domain 24, so the DCF's incremental DPF has 24
    # hierarchy levels on 23 tree levels, every depth capturing; 512 points
    # are W = 16 words.
    dlevels = DCF_LOG_DOMAIN - 1
    dw = DCF_POINTS // 32

    def dcf_mk_args(k, w, levels, bits, keep):
        rows = (levels + 1) * keep
        return (rnd(k, 128), rnd(levels, w), rnd(k, levels, 128), rnd(k, levels),
                rnd(k, levels), rnd(k, rows, bits // 32), rnd(rows, w))

    dcf_cases = (
        (T.Int(32), 4, 1, 1, (True, False, True)), (T.Int(64), 2, 0, 3, (False, True, True, True)),
        (T.Int(64), 1, 1, 37, (True, True, False, True, True, False)),
        (T.Int(64), 2, 1, 1, (True,) * 5), (T.XorWrapper(128), 1, 1, 3, (True, False, True, True)),
        (T.Int(128), 1, 0, 37, (True, True, False, True)), (T.Int(128), 1, 1, 3, (True,) * 4),
        (T.Int(32), 2, 0, 37, (False, True, True, True, False)),
    )
    for vt, keep, party, w, captures in dcf_cases:
        kw = dict(bits=vt.bitsize, party=party, xor_group=isinstance(vt, T.XorWrapper),
                  keep=keep, captures=captures)
        a = dcf_mk_args(5, w, len(captures) - 1, vt.bitsize, keep)
        hold("K7 DCF", aes_cuda.walk_megakernel(*a, **kw), backend_torch.walk_megakernel(*a, **kw))
    print(f"K7 DCF form == plain at {len(dcf_cases)} shapes (W = 1, 3, 37 at K = 5: 5, 15 "
          "and 185 items, each leaving a warp that straddles the end; Int(32) keep 4 and 2, "
          "Int(64) keep 1 and 2, XorWrapper(128), Int(128), both parties, captures with "
          "depths that do not capture)")
    a = walk_level_args(DCF_KEYS, dw)
    hold("K6", aes_cuda.walk_level(*a), backend_torch.walk_level(*a))
    ms, device_ms = launch_ms(torch, lambda: aes_cuda.walk_level(*a), a[0].numel() * 4)
    plain_ms = time_ms(torch, lambda: backend_torch.walk_level(*a), 2)
    b_ms, b_by = bound_ms(*walk_level_cost(key_planes, DCF_KEYS, dw))
    rows["K6 dcf"] = dict(kernel=aes_cuda.K6, ms=ms, device_ms=device_ms,
                          plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
    print(f"K6 at the DCF's shape K={DCF_KEYS}, W={dw}: {ms:.4f} ms (device "
          f"{device_ms:.4f} ms; plain {plain_ms:.2f} ms, bound {b_ms:.4f} ms by {b_by})")
    planes_d = a[0]
    hold("K4", aes_cuda.hash_value_planes(planes_d), backend_torch.hash_value_planes(planes_d))
    ms, device_ms = launch_ms(torch, lambda: aes_cuda.hash_value_planes(planes_d),
                             planes_d.numel() * 4)
    plain_ms = time_ms(torch, lambda: backend_torch.hash_value_planes(planes_d), 2)
    b_ms, b_by = bound_ms(*hash_cost(key_planes, DCF_KEYS, dw))
    rows["K4 dcf"] = dict(kernel=aes_cuda.K4, ms=ms, device_ms=device_ms,
                          plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
    print(f"K4 at the DCF's shape K={DCF_KEYS}, W={dw}: {ms:.4f} ms (device "
          f"{device_ms:.4f} ms; plain {plain_ms:.2f} ms, bound {b_ms:.4f} ms by {b_by})")
    del a, planes_d
    dcaps = (True,) * (dlevels + 1)
    kw = dict(bits=64, party=1, xor_group=False, keep=2, captures=dcaps)
    a = dcf_mk_args(DCF_KEYS, dw, dlevels, 64, 2)
    hold("K7 DCF", aes_cuda.walk_megakernel(*a, **kw), backend_torch.walk_megakernel(*a, **kw))
    plain_ms = time_ms(torch, lambda: backend_torch.walk_megakernel(*a, **kw), 1)
    ms, device_ms = launch_ms(torch, lambda: aes_cuda.walk_megakernel(*a, **kw),
                              4 * DCF_KEYS * 64 * dw)
    b_ms, b_by = bound_ms(*walk_megakernel_cost(key_planes, DCF_KEYS, dw, dlevels, 64, 2, 1,
                                                False, dcaps))
    rows["K7 DCF"] = dict(kernel=aes_cuda.K7_DCF, ms=ms, device_ms=device_ms, plain_ms=plain_ms,
                          bound_ms=b_ms, bound_by=b_by)
    print(f"K7 DCF form at K={DCF_KEYS}, W={dw}, L={dlevels}, Int(64) keep 2, party 1, "
          f"{dlevels + 1} captures: {ms:.4f} ms (device {device_ms:.4f} ms; plain "
          f"{plain_ms:.2f} ms, bound {b_ms:.4f} ms by {b_by}); {aes_cuda.K7_DCF.ptxas}")
    print_ptxas("K7", (aes_cuda.K7, aes_cuda.K7_DCF))
    del a
    torch.cuda.empty_cache()

    # -- 8. the main path: DCF BatchEvaluate, BASELINE config 4 --------------
    dcf = T.DistributedComparisonFunction.create(DCF_LOG_DOMAIN, T.Int(64))
    dv = dcf.dpf.validator
    if dv.hierarchy_to_tree[-1] != dlevels:
        fail(f"a log-domain-{DCF_LOG_DOMAIN} DCF should have {dlevels} tree levels")
    # 256 alphas, each the point of two keys; the points are every alpha
    # and every alpha - 1 (a fresh point where alpha is 0): 512 in all.
    drng = np.random.default_rng(SEED + DCF_LOG_DOMAIN)
    distinct = [int(x) for x in drng.choice(1 << DCF_LOG_DOMAIN, size=DCF_KEYS // 2,
                                            replace=False)]
    dalphas = distinct + distinct
    dbetas = [int(b) for b in drng.integers(1, 2**63, size=DCF_KEYS, dtype=np.uint64)]
    dseeds = drng.integers(0, 2**32, size=(DCF_KEYS, 2, 4), dtype=np.uint32)
    t = time.perf_counter()
    dkeys = dcf.generate_keys_batch(dalphas, dbetas, seeds=dseeds)
    print(f"keygen: {DCF_KEYS} Int(64) DCF key pairs at log-domain {DCF_LOG_DOMAIN} in "
          f"{time.perf_counter() - t:.2f} s (host)")
    below = [a - 1 if a > 0 else (1 << DCF_LOG_DOMAIN) - 1 for a in distinct]
    xs = distinct + below
    if len(set(xs)) != DCF_POINTS:
        fail(f"the DCF points should be {DCF_POINTS} distinct points")
    dcf_kernels = {"walk": (aes_cuda.K6, aes_cuda.K4), "walkkernel": (aes_cuda.K7_DCF,)}
    dcf_counts = {
        "walk": {aes_cuda.K6.name: 2 * dlevels, aes_cuda.K4.name: 2 * (dlevels + 1)},
        "walkkernel": {aes_cuda.K7_DCF.name: 2},
    }
    shares = {}
    dcf_launches = {}
    dcf_rates = {}
    for mode, need in dcf_kernels.items():
        aes_cuda.reset_launch_counts()
        secs = []
        for party in (0, 1):
            torch.cuda.synchronize()
            t = time.perf_counter()
            shares[(mode, party)] = dcf_batch.batch_evaluate(dcf, dkeys[party], xs, mode=mode)
            secs.append(time.perf_counter() - t)
        counts = {k.name: k.launches for k in aes_cuda.KERNELS}
        for kern in need:
            if kern.launches == 0:
                fail(f"DCF mode {mode} ran without launching {kern.name}")
            main_launches[kern.name] = main_launches.get(kern.name, 0) + kern.launches
            dcf_launches[kern.name] = dcf_launches.get(kern.name, 0) + kern.launches
        if counts != {k.name: dcf_counts[mode].get(k.name, 0) for k in aes_cuda.KERNELS}:
            fail(f"DCF mode {mode}: launches {counts}, expected {dcf_counts[mode]} for one "
                 "chunk per party")
        dcf_rates[mode] = [DCF_KEYS * DCF_POINTS / x for x in secs]
        print(f"DCF, mode {mode}: {DCF_KEYS} keys x {DCF_POINTS} points per party in "
              f"{secs[0]:.3f} s / {secs[1]:.3f} s = {dcf_rates[mode][0]:.4e} / "
              f"{dcf_rates[mode][1]:.4e} comparisons/s; launches {counts}")
    lt = np.array(xs)[None, :] < np.array(dalphas)[:, None]
    want_sum = np.where(lt, np.array(dbetas, np.uint64)[:, None], np.uint64(0))
    for mode in dcf_kernels:
        total = (evaluator.values_to_numpy(shares[(mode, 0)], 64)
                 + evaluator.values_to_numpy(shares[(mode, 1)], 64))
        if not np.array_equal(total, want_sum):
            bad = int((total != want_sum).sum())
            fail(f"DCF mode {mode}: {bad} share pairs do not reconstruct [x < alpha] * beta")
    t = time.perf_counter()
    # Host oracle: the 4 keys' own alphas and alphas - 1, and 8 other points.
    opoints = sorted({i for key in range(ORACLE_KEYS)
                      for i in (key % (DCF_KEYS // 2), DCF_KEYS // 2 + key % (DCF_KEYS // 2))}
                     | set(range(100, 100 + DCF_ORACLE_POINTS - 2 * ORACLE_KEYS)))
    for party in (0, 1):
        if not np.array_equal(shares[("walk", party)], shares[("walkkernel", party)]):
            fail(f"DCF modes walk and walkkernel differ (party {party})")
        for i in range(ORACLE_KEYS):
            host = np.array([dcf.evaluate(dkeys[party][i], xs[j]) for j in opoints], np.uint64)
            got = evaluator.values_to_numpy(shares[("walk", party)][i, opoints], 64)
            if not np.array_equal(got, host):
                fail(f"DCF differs from the host dcf.evaluate (key {i}, party {party})")
    print(f"DCF: every share pair reconstructs (r0 + r1 == beta where x < alpha, 0 elsewhere) "
          f"in both modes, the modes agree, and the host dcf.evaluate equals them for "
          f"{ORACLE_KEYS} keys at {len(opoints)} points per party "
          f"({time.perf_counter() - t:.2f} s on the host)")
    # Where one pass's time goes (party 0): the host steps of batch_evaluate,
    # then each mode's device part on the prepared chunk, held against the
    # entry point's result.
    torch.cuda.synchronize()
    t = time.perf_counter()
    dbatch, dcorr = dcf_batch.prepare_keys(dcf, dkeys[0], device=dev)
    dch = dcf_batch.prepare_chunk(dbatch, dcorr, np.arange(DCF_KEYS))
    torch.cuda.synchronize()
    dkeys_s = time.perf_counter() - t
    dprep_s, dpass_ms = {}, {}
    for mode in dcf_kernels:
        t = time.perf_counter()
        dp = dcf_batch.prepare_points(dcf, xs, mode=mode, device=dev)
        torch.cuda.synchronize()
        dprep_s[mode] = time.perf_counter() - t
        dpass_ms[mode] = time_ms(torch, lambda: dcf_batch.evaluate_chunk(dch, dp), 3)
        got = dcf_batch.evaluate_chunk(dch, dp)
        if not np.array_equal(aes_torch.from_words(got), shares[(mode, 0)]):
            fail(f"the timed DCF {mode} chunk differs from the entry point's result")
    print(f"one DCF pass ({DCF_KEYS} keys x {DCF_POINTS} points, party 0): host KeyBatch + "
          f"corrections + upload {dkeys_s * 1e3:.1f} ms, point tables + upload "
          f"{dprep_s['walk'] * 1e3:.1f} ms (walk) / {dprep_s['walkkernel'] * 1e3:.1f} ms "
          f"(walkkernel); device, mode walk {dpass_ms['walk']:.2f} ms (K6 x {dlevels} + "
          f"(K4 + capture) x {dlevels + 1}), mode walkkernel {dpass_ms['walkkernel']:.2f} ms "
          f"(K7 DCF form + transpose) at {dp.path_masks.shape[1]} lane words")
    print(f"DCF comparisons/s, walk / walkkernel (parties 0 / 1): "
          f"{dcf_rates['walk'][0]:.4e} / {dcf_rates['walk'][1]:.4e}, "
          f"{dcf_rates['walkkernel'][0]:.4e} / {dcf_rates['walkkernel'][1]:.4e}")
    del shares, dch, got
    torch.cuda.empty_cache()

    # -- 9. K8 against its plain version -------------------------------------
    # The heavy-hitters configuration first (host): its keys, its plan and
    # the hierkernel windows, whose full-width tables K8 is held at.
    hdpf = T.DistributedPointFunction.create_incremental(
        [T.DpfParameters(i + 1, T.Int(64)) for i in range(HH_LEVELS)])
    hrng = np.random.default_rng(SEED + HH_LEVELS)
    halphas = hierarchical.draw_random_finals(HH_LEVELS, HH_KEYS, hrng)
    hbetas = [[int(b) for b in hrng.integers(1, 2**63, size=HH_KEYS, dtype=np.uint64)]
              for _ in range(HH_LEVELS)]
    hseeds = hrng.integers(0, 2**32, size=(HH_KEYS, 2, 4), dtype=np.uint32)
    t = time.perf_counter()
    hkeys = hdpf.generate_keys_batch(halphas, hbetas, seeds=hseeds)
    hkeygen_s = time.perf_counter() - t
    finals = hierarchical.draw_random_finals(HH_LEVELS, HH_NONZEROS, np.random.default_rng(7))
    t = time.perf_counter()
    hplan = hierarchical.bitwise_hierarchy_plan(HH_LEVELS, finals + halphas)
    hplan_s = time.perf_counter() - t
    hprepared = {mode: hierarchical.prepare_levels_fused(
        hierarchical.BatchedContext.create(hdpf, hkeys[0]), hplan, HH_GROUP, mode, device=dev)
        for mode in hierarchical.MODES}
    windows = hprepared["hierkernel"].hier_windows
    hh_values = sum(int(g.shape[0]) for win in windows for g in win.gsels)
    print(f"heavy hitters: {HH_KEYS} Int(64) key pairs of {HH_LEVELS} hierarchy levels in "
          f"{hkeygen_s:.2f} s, the plan of {HH_NONZEROS} leaves in {hplan_s:.2f} s (host); "
          f"{hh_values} values a key; {len(windows)} windows, "
          f"{[w.plan for w in windows[:1]]}, state_cap {windows[0].state_cap}")

    def hier_plain(a, kw):  # K8's plain version takes its operands but the parent table
        return backend_torch.hier_window(*a[:3], *a[4:], **kw)

    # Windows of real small hierarchies (ops/hier_cases.py): Int(32)
    # keeping 2 and 4, Int(64), Int(128), XorWrapper(128), both parties, a
    # zero-level first step, steps of two and three tree levels, words that
    # straddle segments, pad lanes, corrections that carry through every limb.
    for name in hier_cases.CASES:
        case = hier_cases.window_case(name, device=dev)
        hold("K8", aes_cuda.hier_megakernel(*case["args"], **case["kw"]),
             hier_plain(case["args"], case["kw"]))
    print(f"K8 == plain on {len(hier_cases.CASES)} windows of small hierarchies "
          f"({'; '.join(hier_cases.CASES)})")
    # Window 4 of the configuration (levels 64-79, in the U128 regime): its
    # tables, the keys' own tables, and an entry state of random context
    # seeds and control bits, which K8 reads through the parent table and the
    # plain version gathers through entry_pos.
    win = windows[4]
    lo, hi = win.start_level, win.start_level + win.depth
    wpw, n_rows = win.plan.padded_words, win.sel.shape[0]
    keep_g = hprepared["hierkernel"].hier_keep
    slots = win.sel.reshape(n_rows // keep_g, keep_g, wpw)
    hot = int(functools.reduce(torch.bitwise_or, slots.unbind(1)).ne(0).sum())
    seg0 = win.segments[0]
    entry_read = int(win.parent[seg0[0]:seg0[0] + seg0[1]].unique().numel())
    hctx = hierarchical.BatchedContext.create(hdpf, hkeys[1][:HH_CHUNK])
    hlk = hierarchical.prepare_level_keys(hctx, hprepared["hierkernel"])
    kw = dict(segments=win.segments, state_cap=win.state_cap, bits=64, party=1,
              xor_group=False, keep=keep_g)

    def window_args(k, j=4, lk=hlk):
        wj = windows[j]
        lj, hj = wj.start_level, wj.start_level + wj.depth
        control = torch.randint(0, 2, (k, wj.state_cap), dtype=torch.int32, device=dev,
                                generator=g)
        return [rnd(k, wj.state_cap, 4), control, wj.entry_pos, wj.parent, wj.path,
                lk.cw[:k, lj:hj].contiguous(), lk.ccl[:k, lj:hj].contiguous(),
                lk.ccr[:k, lj:hj].contiguous(), lk.corrections[j][:k].contiguous(), wj.sel]

    a = window_args(4)
    hold("K8", aes_cuda.hier_megakernel(*a, **kw), hier_plain(a, kw))
    a = window_args(HH_CHUNK)
    hold("K8", aes_cuda.hier_megakernel(*a, **kw), hier_plain(a, kw))
    ms = time_ms(torch, lambda: aes_cuda.hier_megakernel(*a, **kw), 5)
    plain_ms = time_ms(torch, lambda: hier_plain(a, kw), 1)
    b_ms, b_by = bound_ms(*hier_megakernel_cost(key_planes, HH_CHUNK, win.segments, hot,
                                                entry_read, wpw, n_rows, win.state_cap, 64,
                                                keep_g, 1, False))
    rows["K8"] = dict(kernel=aes_cuda.K8, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
    walked = sum((-(-(b + n) // 32) - b // 32) * ld for b, n, _, ld in win.segments)
    print(f"K8 == plain on window 4 of the configuration at K = 4 and {HH_CHUNK}; at "
          f"K={HH_CHUNK}, W={wpw}, L={win.depth}, {len(win.segments)} segments ({walked} walked "
          f"segment words, {hot} hot slot words, {entry_read} entry lanes read), Int(64) keep 2, "
          f"party 1: {ms:.4f} ms (plain {plain_ms:.2f} ms, bound {b_ms:.4f} ms by {b_by}); "
          f"{aes_cuda.K8.ptxas}")
    # Every window of the configuration at the main path's chunk: where the
    # K8 launches of a pass go.
    per_window, per_bound = [], []
    for j, wj in enumerate(windows):
        aj = window_args(HH_CHUNK, j)
        kj = dict(kw, segments=wj.segments, state_cap=wj.state_cap)
        per_window.append(time_ms(torch, lambda: aes_cuda.hier_megakernel(*aj, **kj), 3))
        sj = wj.sel.reshape(wj.sel.shape[0] // keep_g, keep_g, wpw)
        hot_j = int(functools.reduce(torch.bitwise_or, sj.unbind(1)).ne(0).sum())
        s0 = wj.segments[0]
        read_j = int(wj.parent[s0[0]:s0[0] + s0[1]].unique().numel())
        per_bound.append(bound_ms(*hier_megakernel_cost(
            key_planes, HH_CHUNK, wj.segments, hot_j, read_j, wpw, wj.sel.shape[0],
            wj.state_cap, 64, keep_g, 1, False))[0])
    print(f"K8 per window at K={HH_CHUNK}: {', '.join(f'{t:.4f}' for t in per_window)} ms "
          f"(sum {sum(per_window):.4f} ms a key chunk); bound "
          f"{', '.join(f'{t:.4f}' for t in per_bound)} ms")
    # Timing only (the outputs are not the window's): what the scattered
    # parent loads cost (every lane's parent lane 0: the same arithmetic,
    # one parent a segment), and all keys in one launch (more warps a depth).
    zero_parent = torch.zeros_like(win.parent)
    a0 = a[:3] + [zero_parent] + a[4:]
    ms_zero = time_ms(torch, lambda: aes_cuda.hier_megakernel(*a0, **kw), 5)
    del a0
    hlk_all = hierarchical.prepare_level_keys(
        hierarchical.BatchedContext.create(hdpf, hkeys[1]), hprepared["hierkernel"])
    a_all = window_args(HH_KEYS, lk=hlk_all)
    ms_all = time_ms(torch, lambda: aes_cuda.hier_megakernel(*a_all, **kw), 3)
    print(f"K8 at window 4, timing only: every parent lane 0 {ms_zero:.4f} ms at K={HH_CHUNK} "
          f"(the table's: {ms:.4f}); all {HH_KEYS} keys in one launch {ms_all:.4f} ms "
          f"({ms_all / HH_KEYS * HH_CHUNK:.4f} ms a {HH_CHUNK} keys)")
    del a, a_all, hlk_all
    # K2 and K4 at mode "fused"'s widest step: all keys, the parents' words.
    fw = max(step.pos.shape[0] for step in hprepared["fused"].steps) // 32
    a = expand_args(rnd, HH_KEYS, fw)
    hold("K2", aes_cuda.expand_one_level(*a), backend_torch.expand_one_level(*a))
    ms, device_ms = launch_ms(torch, lambda: aes_cuda.expand_one_level(*a),
                             planes_bytes(HH_KEYS, 2 * fw))
    plain_ms = time_ms(torch, lambda: backend_torch.expand_one_level(*a), 2)
    b_ms, b_by = bound_ms(*expand_cost(key_planes, HH_KEYS, fw, False))
    rows["K2 hh"] = dict(kernel=aes_cuda.K2, ms=ms, device_ms=device_ms,
                         plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
    print(f"K2 at the hierarchy's shape K={HH_KEYS}, W={fw}: {ms:.4f} ms (device "
          f"{device_ms:.4f} ms; plain {plain_ms:.2f} ms, bound {b_ms:.4f} ms by {b_by})")
    planes_h = rnd(HH_KEYS, 128, 2 * fw)
    hold("K4", aes_cuda.hash_value_planes(planes_h), backend_torch.hash_value_planes(planes_h))
    ms, device_ms = launch_ms(torch, lambda: aes_cuda.hash_value_planes(planes_h),
                             planes_h.numel() * 4)
    plain_ms = time_ms(torch, lambda: backend_torch.hash_value_planes(planes_h), 2)
    b_ms, b_by = bound_ms(*hash_cost(key_planes, HH_KEYS, 2 * fw))
    rows["K4 hh"] = dict(kernel=aes_cuda.K4, ms=ms, device_ms=device_ms,
                         plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
    print(f"K4 at the hierarchy's shape K={HH_KEYS}, W={2 * fw}: {ms:.4f} ms (device "
          f"{device_ms:.4f} ms; plain {plain_ms:.2f} ms, bound {b_ms:.4f} ms by {b_by})")
    del a, planes_h, hlk
    torch.cuda.empty_cache()

    # -- 10. the main path: heavy hitters ------------------------------------
    tree_levels = hdpf.validator.hierarchy_to_tree[-1]
    chunks_hh = -(-HH_KEYS // HH_CHUNK)
    hh_counts = {
        "fused": {aes_cuda.K2.name: 2 * tree_levels, aes_cuda.K4.name: 2 * HH_LEVELS},
        "hierkernel": {aes_cuda.K8.name: 2 * len(windows) * chunks_hh},
    }
    hh_kernels = {"fused": (aes_cuda.K2, aes_cuda.K4), "hierkernel": (aes_cuda.K8,)}
    hh_out, hh_launches, hh_rates = {}, {}, {}
    for mode, need in hh_kernels.items():
        aes_cuda.reset_launch_counts()
        secs = []
        for party in (0, 1):
            ctx = hierarchical.BatchedContext.create(hdpf, hkeys[party])
            torch.cuda.synchronize()
            t = time.perf_counter()
            hh_out[(mode, party)] = hierarchical.evaluate_levels_fused(
                ctx, hplan, group=HH_GROUP, mode=mode, key_chunk=HH_CHUNK)
            secs.append(time.perf_counter() - t)
        counts = {k.name: k.launches for k in aes_cuda.KERNELS}
        for kern in need:
            if kern.launches == 0:
                fail(f"heavy hitters mode {mode} ran without launching {kern.name}")
            main_launches[kern.name] = main_launches.get(kern.name, 0) + kern.launches
            hh_launches[kern.name] = hh_launches.get(kern.name, 0) + kern.launches
        if counts != {k.name: hh_counts[mode].get(k.name, 0) for k in aes_cuda.KERNELS}:
            fail(f"heavy hitters mode {mode}: launches {counts}, expected {hh_counts[mode]}")
        hh_rates[mode] = [HH_KEYS * hh_values / x for x in secs]
        print(f"heavy hitters, mode {mode}: {HH_KEYS} keys x {hh_values} values per party in "
              f"{secs[0]:.3f} s / {secs[1]:.3f} s = {hh_rates[mode][0]:.4e} / "
              f"{hh_rates[mode][1]:.4e} values/s; launches {counts}")
    t = time.perf_counter()
    leaves = sorted(set(finals + halphas))
    for h in range(HH_LEVELS):
        cols = []
        if h == 0:
            cols = [a >> (HH_LEVELS - 1) for a in halphas]
        else:
            parents = sorted({f >> (HH_LEVELS - h) for f in leaves})
            for a in halphas:
                prefix = a >> (HH_LEVELS - h - 1)
                cols.append(2 * bisect.bisect_left(parents, prefix >> 1) + (prefix & 1))
        betas_h = np.array(hbetas[h], np.uint64)
        for mode in hh_kernels:
            total = (evaluator.values_to_numpy(hh_out[(mode, 0)][h], 64)
                     + evaluator.values_to_numpy(hh_out[(mode, 1)][h], 64))
            total[np.arange(HH_KEYS), cols] -= betas_h
            if total.any():
                fail(f"heavy hitters mode {mode}: level {h}: {int((total != 0).sum())} share "
                     "pairs do not reconstruct")
    for party in (0, 1):
        if not all(np.array_equal(a, b) for a, b in zip(hh_out[("fused", party)],
                                                        hh_out[("hierkernel", party)])):
            fail(f"heavy hitters modes fused and hierkernel differ (party {party})")
    check_s = time.perf_counter() - t
    t = time.perf_counter()
    cctx = hierarchical.BatchedContext.create(hdpf, hkeys[0][:HH_CPU_KEYS])
    cpu_out = hierarchical.evaluate_levels_fused(cctx, hplan, mode="fused", device="cpu")
    if not all(np.array_equal(a, b[:HH_CPU_KEYS]) for a, b in zip(cpu_out, hh_out[("fused", 0)])):
        fail("heavy hitters: the port's CPU path differs from the card")
    print(f"heavy hitters: every level's share pairs reconstruct (r0 + r1 == beta at alpha's "
          f"prefix, 0 at the other candidates) in both modes and the modes agree "
          f"({check_s:.2f} s on the host); the CPU path (mode fused) on {HH_CPU_KEYS} keys equals "
          f"the card ({time.perf_counter() - t:.2f} s)")
    del cpu_out
    # Where one pass's time goes (party 0): the entry point's steps.
    for mode in hh_kernels:
        ctx = hierarchical.BatchedContext.create(hdpf, hkeys[0])
        torch.cuda.synchronize()
        t = time.perf_counter()
        prepared = hierarchical.prepare_levels_fused(ctx, hplan, HH_GROUP, mode, device=dev)
        torch.cuda.synchronize()
        prep_s = time.perf_counter() - t
        t = time.perf_counter()
        lk = hierarchical.prepare_level_keys(ctx, prepared)
        torch.cuda.synchronize()
        keys_s = time.perf_counter() - t
        dev_ms = time_ms(torch, lambda: hierarchical.advance(ctx, prepared, lk, HH_CHUNK), 3)
        outs = hierarchical.advance(ctx, prepared, lk, HH_CHUNK)[0]
        torch.cuda.synchronize()
        t = time.perf_counter()
        pulled = hierarchical.pull(outs)
        pull_s = time.perf_counter() - t
        if not all(np.array_equal(a, b) for a, b in zip(pulled, hh_out[(mode, 0)])):
            fail(f"the timed heavy-hitters {mode} pass differs from the entry point's result")
        print(f"one heavy-hitters pass, mode {mode} ({HH_KEYS} keys, party 0): host prepare "
              f"(plan tables, upload) {prep_s * 1e3:.1f} ms, KeyBatch + corrections + upload "
              f"{keys_s * 1e3:.1f} ms; device {dev_ms:.2f} ms (CUDA events over advance); pull "
              f"{pull_s * 1e3:.1f} ms")
        del outs, pulled, lk, prepared
    print(f"heavy hitters values/s, fused / hierkernel (parties 0 / 1): "
          f"{hh_rates['fused'][0]:.4e} / {hh_rates['fused'][1]:.4e}, "
          f"{hh_rates['hierkernel'][0]:.4e} / {hh_rates['hierkernel'][1]:.4e}")
    # Phase 17 holds its level-by-level run against mode fused's outputs.
    hh = dict(dpf=hdpf, keys=hkeys, plan=hplan, fused=[hh_out[("fused", p)] for p in (0, 1)])
    del hh_out
    torch.cuda.empty_cache()

    # -- 11. K9 and K2's one-key view against their plain versions -----------
    # BM_KeyGeneration's batches first (host): the draws of
    # benchmarks/bench_keygen.py, depth by depth from one generator.
    krng = np.random.default_rng(KG_SEED)
    kg = {}
    for depth in KG_DEPTHS:
        kdpf = T.DistributedPointFunction.create(T.DpfParameters(depth, T.Int(64)))
        kalphas = [int.from_bytes(krng.bytes(16), "little") % (1 << depth)
                   for _ in range(KG_KEYS)]
        kbetas = [int(x) for x in krng.integers(1, 1 << 62, size=KG_KEYS)]
        kseeds = krng.integers(0, 2**32, size=(KG_KEYS, 2, 4), dtype=np.uint32)
        kg[depth] = (kdpf, kalphas, kbetas, kseeds)

    def keygen_mk_args(w, levels):
        return rnd(128, w), rnd(128, w), rnd(levels, w)

    # K9 runs two key words a warp: an odd W leaves a warp that straddles
    # the end.
    k9_cases = ((1, (True, True)), (3, (True, False, True, True)),
                (37, (False, True, False, False, True, True)), (3, (False,) * 5 + (True,)),
                (8, (True, False, False, True)), (5, (True,) * 3))
    for w, captures in k9_cases:
        a = keygen_mk_args(w, len(captures) - 1)
        hold("K9", aes_cuda.keygen_megakernel(*a, captures=captures),
             backend_torch.keygen_megakernel(*a, captures=captures))
    print(f"K9 == plain at {len(k9_cases)} shapes (W = 1, 3, 37, 5: odd numbers of key words, "
          "and 8; 1-5 levels; depths that do and do not capture)")
    k9_batches = {name: keygen_batch.prepare_megakernel_batch(
        kg[d][0], kg[d][1], [kg[d][2]], seeds=kg[d][3], device=dev)
        for name, d in (("K9", 20), ("K9 d128", 128))}
    walpha = [int(x) for x in np.random.default_rng(SEED + 128).integers(
        0, 2**63, size=KG_WIDE_KEYS, dtype=np.uint64)]
    k9_batches["K9 wide"] = keygen_batch.prepare_megakernel_batch(
        kg[128][0], walpha, [1], seeds=np.random.default_rng(SEED).integers(
            0, 2**32, size=(KG_WIDE_KEYS, 2, 4), dtype=np.uint32), device=dev)
    dcf_kg = T.DistributedComparisonFunction.create(DCF_LOG_DOMAIN, T.Int(64))
    k9_batches["K9 dcf"] = keygen_batch.prepare_megakernel_batch(
        dcf_kg.dpf, [x >> 1 for x in dalphas], [0] * DCF_LOG_DOMAIN, seeds=dseeds, device=dev)
    b = k9_batches["K9"]
    hold("K9", keygen_batch.megakernel_outputs(b), backend_torch.keygen_megakernel(
        b.planes0, b.planes1, b.path_masks, captures=b.captures))
    for name, b in k9_batches.items():
        wp, levels, slots = b.planes0.shape[1], b.path_masks.shape[0], sum(b.captures)
        ms, device_ms = launch_ms(torch, lambda: keygen_batch.megakernel_outputs(b),
                                  4 * wp * (levels * 130 + slots * 257), 5)
        plain_ms = None  # the plain version at the timing-only width: not run
        if name != "K9 wide":
            plain_ms = time_ms(torch, lambda: backend_torch.keygen_megakernel(
                b.planes0, b.planes1, b.path_masks, captures=b.captures), 1)
        b_ms, b_by = bound_ms(*keygen_megakernel_cost(key_planes, wp, levels, slots))
        rows[name] = dict(kernel=aes_cuda.K9, ms=ms, device_ms=device_ms, plain_ms=plain_ms,
                          bound_ms=b_ms, bound_by=b_by)
        print(f"{name} at {b.k} keys (W={wp}), L={levels}, {slots} captures: {ms:.4f} ms "
              f"(device {device_ms:.4f} ms; bound {b_ms:.4f} ms by {b_by}, "
              f"{b_ms / ms * 100:.1f} %; per-warp issue floor "
              f"{keygen_warp_floor_ms(levels, slots):.4f} ms; plain "
              f"{'not run' if plain_ms is None else f'{plain_ms:.2f} ms'})"
              + (f"; {aes_cuda.K9.ptxas}" if name == "K9" else ""))
    print_ptxas("K9", (aes_cuda.K9,))
    del k9_batches, b
    # K2's one-key view (the legacy [128, W] kernel) at micro_tpu's width.
    a = [t[0] for t in expand_args(rnd, 1, LEGACY_W)]
    hold("K2 legacy", aes_cuda.expand_one_level_single(*a),
         backend_torch.expand_one_level_single(*a))
    ms, device_ms = launch_ms(torch, lambda: aes_cuda.expand_one_level_single(*a),
                             planes_bytes(1, 2 * LEGACY_W))
    plain_ms = time_ms(torch, lambda: backend_torch.expand_one_level_single(*a), 2)
    b_ms, b_by = bound_ms(*expand_cost(key_planes, 1, LEGACY_W, False))
    rows["K2 legacy"] = dict(kernel=aes_cuda.K2, ms=ms, device_ms=device_ms,
                             plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
    print(f"K2 one-key view == plain at W={LEGACY_W}: {ms:.4f} ms (device "
          f"{device_ms:.4f} ms; plain {plain_ms:.2f} ms, bound {b_ms:.4f} ms by {b_by})")
    del a
    torch.cuda.empty_cache()

    # -- 12. the main path: batched keygen ----------------------------------
    class TimedPrg(keygen_batch.DeviceKeygenPrg):
        """Mode perlevel's provider, timing its calls: each uploads, packs,
        launches and pulls, so its time is the level loop's card side."""

        seconds = 0.0

        def expand(self, flat, want_value):
            t = time.perf_counter()
            out = super().expand(flat, want_value)
            self.seconds += time.perf_counter() - t
            return out

        def value_hash(self, inputs):
            t = time.perf_counter()
            out = super().value_hash(inputs)
            self.seconds += time.perf_counter() - t
            return out

    kg_cases = {f"log-domain {d}": (kg[d][0], kg[d][1], [kg[d][2]], kg[d][3]) for d in KG_DEPTHS}
    kg_cases["DCF config 4"] = (dcf_kg, dalphas, dbetas, dseeds)
    kg_kernels = {"megakernel": (aes_cuda.K9,), "perlevel": (aes_cuda.K2, aes_cuda.K4),
                  "numpy-threaded": ()}
    kg_launches, kg_rates = {}, {}
    for case, (obj, al, be, sd) in kg_cases.items():
        is_dcf = case.startswith("DCF")
        v = (obj.dpf if is_dcf else obj).validator
        levels = v.tree_levels_needed - 1
        captures = v.num_hierarchy_levels
        t = time.perf_counter()
        want = obj.generate_keys_batch(al, be, seeds=sd)  # the host numpy dealer
        host_s = time.perf_counter() - t
        rates = {"numpy": len(al) / host_s}
        want_counts = {"megakernel": {aes_cuda.K9.name: 1},
                       "perlevel": {aes_cuda.K2.name: levels, aes_cuda.K4.name: captures},
                       "numpy-threaded": {}}
        for mode, need in kg_kernels.items():
            aes_cuda.reset_launch_counts()
            torch.cuda.synchronize()
            t = time.perf_counter()
            if is_dcf:
                got = obj.generate_keys_batch(al, be, seeds=sd, mode=mode)
            else:
                got = keygen_batch.generate_keys_batch(obj, al, be, mode=mode, seeds=sd)
            secs = time.perf_counter() - t
            counts = {k.name: k.launches for k in aes_cuda.KERNELS}
            for kern in need:
                if kern.launches == 0:
                    fail(f"keygen {case}, mode {mode} ran without launching {kern.name}")
                main_launches[kern.name] = main_launches.get(kern.name, 0) + kern.launches
                key = (kern.name, mode)
                kg_launches[key] = kg_launches.get(key, 0) + kern.launches
            if counts != {k.name: want_counts[mode].get(k.name, 0) for k in aes_cuda.KERNELS}:
                fail(f"keygen {case}, mode {mode}: launches {counts}, expected "
                     f"{want_counts[mode]}")
            for party in (0, 1):
                if got[party] != want[party]:
                    bad = sum(a != b for a, b in zip(got[party], want[party]))
                    fail(f"keygen {case}, mode {mode}: {bad} keys of party {party} differ from "
                         "the host dealer's")
            rates[mode] = len(al) / secs
            if (case, mode) == ("log-domain 20", "megakernel"):
                e2e_keys = got
            del got
        kg_rates[case] = rates
        print(f"keygen {case} ({len(al)} keys, {levels} levels, {captures} captures): keys "
              f"equal the host dealer's in every mode; keys/s " + ", ".join(
                  f"{m} {r:.4e}" for m, r in rates.items()))
        # Where the time goes: mode megakernel's steps, mode perlevel's card side.
        dpf_k = obj.dpf if is_dcf else obj
        betas_k = be if not is_dcf else None
        if is_dcf:
            betas_k = [[b if (a >> (DCF_LOG_DOMAIN - i - 1)) & 1 else 0 for a, b in zip(al, be)]
                       for i in range(DCF_LOG_DOMAIN)]
        al_k = [a >> 1 for a in al] if is_dcf else al
        torch.cuda.synchronize()
        t = time.perf_counter()
        kb = keygen_batch.prepare_megakernel_batch(dpf_k, al_k, betas_k, seeds=sd, device=dev)
        torch.cuda.synchronize()
        prep_s = time.perf_counter() - t
        dev_ms = time_ms(torch, lambda: keygen_batch.megakernel_outputs(kb), 3)
        outs = keygen_batch.megakernel_outputs(kb)
        torch.cuda.synchronize()
        t = time.perf_counter()
        outs = [aes_torch.from_words(o) for o in outs]
        pull_s = time.perf_counter() - t
        t = time.perf_counter()
        records = keygen_batch.megakernel_records(kb, *outs)
        rec_s = time.perf_counter() - t
        t = time.perf_counter()
        keys_k = keygen_batch.assemble_megakernel_keys(kb, records)
        asm_s = time.perf_counter() - t
        if [list(p) for p in keys_k] != [[x.key for x in p] if is_dcf else list(p) for p in want]:
            fail(f"keygen {case}: the timed megakernel steps differ from the host dealer")
        prg = TimedPrg(dev)
        t = time.perf_counter()
        dpf_k.generate_keys_batch(al_k, betas_k, seeds=sd, prg=prg)
        pl_s = time.perf_counter() - t
        print(f"  mode megakernel: host pack + upload {prep_s * 1e3:.1f} ms, device (K9) "
              f"{dev_ms:.2f} ms, pull {pull_s * 1e3:.1f} ms, unpack + typed corrections "
              f"{rec_s * 1e3:.1f} ms, assembly {asm_s * 1e3:.1f} ms; mode perlevel: "
              f"{pl_s * 1e3:.1f} ms, of which pack + K2/K4 + pull {prg.seconds * 1e3:.1f} ms")
        del outs, records, keys_k, kb, want
    torch.cuda.empty_cache()

    # -- 13. end to end: K9's keys through EvaluateAt ------------------------
    e2e_dpf, e2e_alphas, e2e_betas, _ = kg[20]
    e2e_points = e2e_alphas + [int(x) for x in np.random.default_rng(SEED + 20).integers(
        0, 1 << 20, size=KG_E2E_POINTS)]
    t = time.perf_counter()
    e2e = [evaluator.evaluate_at_batch(e2e_dpf, e2e_keys[p], e2e_points, mode="walkkernel")
           for p in (0, 1)]
    total = evaluator.values_to_numpy(e2e[0], 64) + evaluator.values_to_numpy(e2e[1], 64)
    hit = np.array(e2e_alphas)[:, None] == np.array(e2e_points)[None, :]
    if not np.array_equal(total, np.where(hit, np.array(e2e_betas, np.uint64)[:, None],
                                          np.uint64(0))):
        fail("the megakernel keys do not reconstruct beta at alpha and 0 elsewhere")
    print(f"end to end: {KG_KEYS} megakernel key pairs at log-domain 20 through "
          f"evaluate_at_batch(mode='walkkernel') at their {KG_KEYS} alphas and "
          f"{KG_E2E_POINTS} other points: r0 + r1 == beta at alpha, 0 elsewhere "
          f"({time.perf_counter() - t:.2f} s)")
    del e2e, e2e_keys, kg
    torch.cuda.empty_cache()

    # -- 14. the codec path's kernels at its shapes, and the codec on the card
    c3_domains = [C3_STEP * (i + 1) for i in range(C3_LEVELS)]

    def c3_chunk(level):
        return max(1, min(C3_KEYS, C3_CHUNK_LEAVES >> c3_domains[level]))

    # Level 0 (a tree of 3 levels): 8 host lanes padded to one word, K4 at
    # W = 1 with the pad lanes zero; level 1: one device level, K2 at W = 1.
    pad = torch.zeros(C3_KEYS, 24, 4, dtype=torch.int32, device=dev)
    p1 = aes_torch.pack_to_planes(torch.cat([rnd(C3_KEYS, 8, 4), pad], dim=1))
    hold("K4", aes_cuda.hash_value_planes(p1), backend_torch.hash_value_planes(p1))
    a = (p1, rnd(C3_KEYS, 1) & 0xFF, rnd(C3_KEYS, 128), rnd(C3_KEYS), rnd(C3_KEYS))
    hold("K2", aes_cuda.expand_one_level(*a), backend_torch.expand_one_level(*a))
    # The widest shapes: level 7's last K2 (a chunk of keys, 2^18 words in)
    # and K4 at 2^19 words.
    k7 = c3_chunk(C3_LEVELS - 1)
    w_in = 1 << (c3_domains[-1] - HOST_LEVELS - 1)
    for name, kern, k, w, make, call, plain, cost in (
        ("K2 c3", aes_cuda.K2, k7, w_in, lambda k, w: expand_args(rnd, k, w),
         lambda a: aes_cuda.expand_one_level(*a), lambda a: backend_torch.expand_one_level(*a),
         lambda k, w: expand_cost(key_planes, k, w, False)),
        ("K4 c3", aes_cuda.K4, 2, 2 * w_in, lambda k, w: rnd(k, 128, w),
         aes_cuda.hash_value_planes, backend_torch.hash_value_planes,
         lambda k, w: hash_cost(key_planes, k, w)),
    ):
        a = make(k, w)
        hold(name.split()[0], call(a), plain(a))
        ms, device_ms = launch_ms(torch, lambda: call(a),
                                  planes_bytes(k, 2 * w if kern is aes_cuda.K2 else w), 5)
        plain_ms = time_ms(torch, lambda: plain(a), 1)
        b_ms, b_by = bound_ms(*cost(k, w))
        rows[name] = dict(kernel=kern, ms=ms, device_ms=device_ms, plain_ms=plain_ms,
                          bound_ms=b_ms, bound_by=b_by)
        print(f"{name.split()[0]} at config 3's widest shape K={k}, W={w}: {ms:.4f} ms (device "
              f"{device_ms:.4f} ms; plain {plain_ms:.2f} ms, bound {b_ms:.4f} ms by {b_by})")
        del a
    torch.cuda.empty_cache()
    # K6 on the full-domain walk's path masks: a tree of 3 levels (W = 1)
    # and 37 words of a tree of 11; then timed at the walk's widest shape
    # in phase 15, level 4: all keys, 2^10 words.
    for levels, w in ((3, 1), (11, 37)):
        masks = evaluator._upload(evaluator._walk_path_masks(levels)[:, :w], dev)
        for lvl in range(levels):
            a = walk_level_args(C3_KEYS, w)
            a = a[:2] + (masks[lvl],) + a[3:]
            hold("K6", aes_cuda.walk_level(*a), backend_torch.walk_level(*a))
    wlevels = c3_domains[4]
    w_walk = 1 << (wlevels - 5)
    masks = evaluator._upload(evaluator._walk_path_masks(wlevels), dev)
    a = walk_level_args(c3_chunk(4), w_walk)
    a = a[:2] + (masks[wlevels - 1],) + a[3:]
    hold("K6", aes_cuda.walk_level(*a), backend_torch.walk_level(*a))
    ms, device_ms = launch_ms(torch, lambda: aes_cuda.walk_level(*a), a[0].numel() * 4)
    plain_ms = time_ms(torch, lambda: backend_torch.walk_level(*a), 2)
    b_ms, b_by = bound_ms(*walk_level_cost(key_planes, c3_chunk(4), w_walk))
    rows["K6 c3"] = dict(kernel=aes_cuda.K6, ms=ms, device_ms=device_ms, plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=b_by)
    print(f"K6 at the full-domain walk's shape K={c3_chunk(4)}, W={w_walk}: {ms:.4f} ms (device "
          f"{device_ms:.4f} ms; plain {plain_ms:.2f} ms, bound {b_ms:.4f} ms by {b_by})")
    del a, masks
    # The codec on the card: correct_values over a K4 stream (one launch a
    # value block) against the same functions on the CPU, both parties.
    crng = np.random.default_rng(SEED + 14)
    codec_types = {
        "IntModN(64, 2^64-59)": T.IntModN(64, C3_MODULUS),
        "IntModN(128, 2^80-65)": T.IntModN(128, 2**80 - 65),
        "Tuple(5 x Int(32))": T.TupleType(*[T.Int(32)] * 5),
        "Tuple(Int(32), Tuple(IntModN(64), Int(32)))": T.TupleType(
            T.Int(32), T.TupleType(T.IntModN(64, C3_MODULUS), T.Int(32))),
    }
    for vname, vt in codec_types.items():
        blocks = T.DistributedPointFunction.create(
            T.DpfParameters(10, vt)).validator.blocks_needed[0]
        spec = value_codec.build_spec(vt, blocks)
        kk, w = 5, 37
        planes, control = rnd(kk, 128, w), rnd(kk, w)
        corr = [np.stack(c) for c in zip(*(
            value_codec.correction_limbs(spec, [sample_value(vt, crng) for _ in range(spec.epb)])
            for _ in range(kk)))]
        for party in (0, 1):
            aes_cuda.reset_launch_counts()
            got = value_codec.correct_values(
                backend_torch.hash_value_stream(planes, blocks, aes_cuda.hash_value_planes),
                backend_torch.unpack_mask_device(control),
                [evaluator._upload(c, dev)[:, None] for c in corr], spec, party)
            if aes_cuda.K4.launches != blocks:
                fail(f"the {vname} stream launched K4 {aes_cuda.K4.launches} times, not {blocks}")
            want = value_codec.correct_values(
                backend_torch.hash_value_stream(planes.cpu(), blocks),
                backend_torch.unpack_mask_device(control.cpu()),
                [evaluator._upload(c, "cpu")[:, None] for c in corr], spec, party)
            torch.cuda.synchronize()
            if not all(torch.equal(g.cpu(), w_) for g, w_ in zip(got, want)):
                fail(f"the codec on the card differs from the CPU for {vname}, party {party}")
    print("K2 and K4 == plain at config 3's W = 1 (K = 256, the pad lanes of a tree of 3) and "
          "widest shapes, K6 == plain on the full-domain walk's path masks (W = 1, 37, "
          f"{w_walk}); correct_values over a K4 stream on the card == the CPU for "
          f"{', '.join(codec_types)} (one K4 launch a value block), both parties")
    torch.cuda.empty_cache()

    # -- 15. the main path: BASELINE config 3 ---------------------------------
    c3vt = T.IntModN(64, C3_MODULUS)
    c3dpf = T.DistributedPointFunction.create_incremental(
        [T.DpfParameters(d, c3vt) for d in c3_domains])
    c3rng = np.random.default_rng(C3_SEED)
    c3_alphas = [int(x) for x in c3rng.integers(0, 1 << c3_domains[-1], size=C3_KEYS)]
    c3_betas = [[int(x) % C3_MODULUS for x in c3rng.integers(1, 1 << 63, size=C3_KEYS)]
                for _ in range(C3_LEVELS)]
    t = time.perf_counter()
    c3keys = c3dpf.generate_keys_batch(
        c3_alphas, c3_betas,
        seeds=c3rng.integers(0, 2**32, size=(C3_KEYS, 2, 4), dtype=np.uint32))
    print(f"keygen: {C3_KEYS} key pairs of BASELINE config 3 ({C3_LEVELS} IntModN(64, 2^64 - 59) "
          f"levels at log-domains {c3_domains}) in {time.perf_counter() - t:.2f} s (host dealer)")
    n_hi, n_lo = C3_MODULUS >> 32, C3_MODULUS & 0xFFFFFFFF

    def c3_check(level, lo, valid, v0, v1):
        """(v0 + v1) mod N is beta_level at alpha's prefix and 0 elsewhere,
        on the card: the exact sum is below 2N, so it must be the target or
        the target plus N."""
        a, b = value_codec.unsigned(v0[:valid]), value_codec.unsigned(v1[:valid])
        s_lo = a[..., 0] + b[..., 0]
        s_hi = a[..., 1] + b[..., 1] + (s_lo >> 32)
        s_lo &= 0xFFFFFFFF
        del a, b
        ok = ((s_hi == 0) & (s_lo == 0)) | ((s_hi == n_hi) & (s_lo == n_lo))
        shift = c3_domains[-1] - c3_domains[level]
        rows_ = torch.arange(valid, device=dev)
        cols = torch.tensor([x >> shift for x in c3_alphas[lo: lo + valid]], device=dev)
        ok[rows_, cols] = True
        if not bool(ok.all()):
            fail(f"config 3 level {level}: {int((~ok).sum())} share pairs do not reconstruct "
                 "0 off alpha's prefix")
        his, los = s_hi[rows_, cols].tolist(), s_lo[rows_, cols].tolist()
        for i, (h, l) in enumerate(zip(his, los)):
            if ((h << 32) | l) % C3_MODULUS != c3_betas[level][lo + i]:
                fail(f"config 3 level {level}, key {lo + i}: the shares at alpha's prefix do "
                     "not reconstruct beta")

    def c3_pass(level, mode, keys, **kw):
        if not isinstance(keys, evaluator.PreparedKeyBatch):
            kw["device"] = dev
        return evaluator.full_domain_evaluate_chunks(
            c3dpf, keys, hierarchy_level=level, key_chunk=kw.pop("key_chunk", c3_chunk(level)),
            mode=mode, **kw)

    def same_chunks(what, got, want):
        """Chunk by chunk: every item of `got` equal to the stored `want`."""
        got = list(got)
        if len(got) != len(want) or not all(
                gv == wv and torch.equal(g, w_) for (gv, g), (wv, w_) in zip(got, want)):
            fail(f"config 3: {what} differs")

    def count_path(what, need):
        counts = {k.name: k.launches for k in aes_cuda.KERNELS}
        if any(counts[k.name] == 0 for k in need) or any(
                n for name, n in counts.items() if name not in {k.name for k in need}):
            fail(f"config 3 {what}: launches {counts}, expected {[k.name for k in need]} only")
        return counts

    c3_launches = {k.name: 0 for k in aes_cuda.KERNELS}
    walk_launches_c3 = {k.name: 0 for k in aes_cuda.KERNELS}
    c3_total = dict(wall=0.0, host=0.0, k2=0.0, k4=0.0, fin=0.0, evals=0)
    c3_peak = 0
    for level in range(C3_LEVELS):
        chunk = c3_chunk(level)
        domain = 1 << c3_domains[level]
        n_chunks = -(-C3_KEYS // chunk)
        # The main path: both parties' chunks side by side, each pair
        # checked on the card; party 0's kept where a later check reads it.
        keep_out = level < C3_LEVELS - 1
        stored = []
        aes_cuda.reset_launch_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        lo = 0
        for (valid, v0), (_, v1) in zip(c3_pass(level, "fused", c3keys[0]),
                                        c3_pass(level, "fused", c3keys[1])):
            c3_check(level, lo, valid, v0, v1)
            lo += valid
            if keep_out:
                stored.append((valid, v0))
            del v0, v1
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        peak = torch.cuda.max_memory_allocated()
        c3_peak = max(c3_peak, peak)
        for name, n in count_path("fused", (aes_cuda.K2, aes_cuda.K4)
                                  if c3dpf.validator.hierarchy_to_tree[level] > HOST_LEVELS
                                  else (aes_cuda.K4,)).items():
            c3_launches[name] += n
        # Where the time goes (party 0, the entry point's steps): the
        # level's KeyBatch on the host, then its first chunk step by step,
        # held against the main path's first chunk.
        torch.cuda.synchronize()
        t = time.perf_counter()
        batch = evaluator.KeyBatch.from_keys(c3dpf, c3keys[0], level, device=dev)
        kb_s = time.perf_counter() - t
        vf = evaluator._values_of(batch, c3dpf, level)
        stop = batch.num_levels
        host_levels = min(HOST_LEVELS, stop)
        t = time.perf_counter()
        ch = evaluator._prepare_chunk(batch.take(np.arange(chunk)), chunk, host_levels, 0)
        order = evaluator._order_on_device(ch.m, ch.seeds.shape[1], stop - host_levels,
                                           batch.device)
        torch.cuda.synchronize()
        prep_s = time.perf_counter() - t
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        planes, control = evaluator._expand_chunk(ch, stop - host_levels)
        ev[1].record()
        hashed = aes_cuda.hash_value_planes(planes)
        ev[2].record()
        del planes
        # hash_value_stream of one value block: the unpack of the hash.
        out = evaluator._finalize(aes_torch.unpack_from_planes(hashed), control, ch.corr,
                                  order, vf)
        ev[3].record()
        ev[3].synchronize()
        del hashed, control, batch
        k2_ms, k4_ms, fin_ms = (ev[i].elapsed_time(ev[i + 1]) for i in range(3))
        first = next(iter(c3_pass(level, "fused", c3keys[0][:chunk])))[1]
        if not torch.equal(out[:, :domain], first):
            fail(f"config 3 level {level}: the timed chunk differs from the entry point's")
        del out, first, ch, order
        scale = 2 * n_chunks
        host_s = 2 * kb_s + scale * prep_s
        rate = 2 * C3_KEYS * domain / wall
        print(f"config 3 level {level} (log-domain {c3_domains[level]}, tree {stop}, key chunk "
              f"{chunk}): both parties {wall * 1e3:.1f} ms wall = {rate:.4e} evals/s; host: "
              f"KeyBatch {kb_s * 1e3:.2f} ms a party, pre-expansion + upload {prep_s * 1e3:.2f} "
              f"ms a chunk; a chunk's device (party 0): K2 x {stop - host_levels} {k2_ms:.3f} "
              f"ms, K4 {k4_ms:.3f} ms, finalize (unpack, mod N, correction, gather) "
              f"{fin_ms:.3f} ms; x {scale} chunks: host {host_s * 1e3:.1f}, K2 "
              f"{k2_ms * scale:.1f}, K4 {k4_ms * scale:.1f}, finalize {fin_ms * scale:.1f} ms; "
              f"peak {peak / 2**30:.2f} GiB")
        for key, val in (("wall", wall * 1e3), ("host", host_s * 1e3),
                         ("k2", k2_ms * scale), ("k4", k4_ms * scale), ("fin", fin_ms * scale)):
            c3_total[key] += val
        c3_total["evals"] += 2 * C3_KEYS * domain
        # The other paths, each held chunk by chunk against the main path.
        if level <= 4:
            aes_cuda.reset_launch_counts()
            same_chunks(f"mode walk at level {level}", c3_pass(level, "walk", c3keys[0]), stored)
            for name, n in count_path(f"mode walk, level {level}",
                                      (aes_cuda.K6, aes_cuda.K4)).items():
                walk_launches_c3[name] += n
        if level == 5:
            aes_cuda.reset_launch_counts()
            pieces = list(c3_pass(level, "fused", c3keys[0], host_levels=HOST_LEVELS + 1,
                                  lane_slab=32))
            count_path("lane_slab", (aes_cuda.K2, aes_cuda.K4))
            joined = [(pieces[i][0], torch.cat([pieces[i][1], pieces[i + 1][1]], dim=1))
                      for i in range(0, len(pieces), 2)]
            same_chunks("lane_slab = 32 at host_levels 6", joined, stored)
            del pieces, joined
            prepared = evaluator.PreparedKeyBatch(c3dpf, c3keys[0], level, key_chunk=chunk,
                                                  device=dev)
            for _ in range(2):
                aes_cuda.reset_launch_counts()
                same_chunks("a PreparedKeyBatch replay", c3_pass(level, "fused", prepared,
                                                                 key_chunk=None), stored)
                count_path("PreparedKeyBatch", (aes_cuda.K2, aes_cuda.K4))
            del prepared
        if level == 6:
            aes_cuda.reset_launch_counts()
            same_chunks("mode levels at level 6", c3_pass(level, "levels", c3keys[0]), stored)
            count_path("mode levels", (aes_cuda.K2, aes_cuda.K4))
        # The host dpf.evaluate_at, 2 keys of each party at 16 points.
        for party in (0, 1):
            pts = [c3_alphas[i] >> (c3_domains[-1] - c3_domains[level]) for i in range(C3_CPU_KEYS)]
            pts += [int(x) for x in c3rng.integers(0, domain, size=C3_CPU_POINTS - len(pts))]
            on_card = next(iter(c3_pass(level, "fused", c3keys[party][:C3_CPU_KEYS],
                                        key_chunk=C3_CPU_KEYS)))[1]
            on_card = evaluator.values_to_numpy(aes_torch.from_words(on_card[:, pts]), 64)
            for i in range(C3_CPU_KEYS):
                if list(on_card[i]) != c3dpf.evaluate_at(c3keys[party][i], level, pts):
                    fail(f"config 3 level {level}: the host dpf.evaluate_at differs from the "
                         f"card (key {i}, party {party})")
        del stored
        torch.cuda.empty_cache()
    for kern in (aes_cuda.K2, aes_cuda.K4):
        main_launches[kern.name] = main_launches.get(kern.name, 0) + c3_launches[kern.name]
    for kern in (aes_cuda.K6, aes_cuda.K4):
        main_launches[kern.name] = main_launches.get(kern.name, 0) + walk_launches_c3[kern.name]
    print(card)
    c3_rest = c3_total["wall"] - sum(c3_total[k] for k in ("host", "k2", "k4", "fin"))
    print(f"config 3 total ({C3_KEYS} keys x {C3_LEVELS} levels, both parties, mode fused): "
          f"{c3_total['evals']:.4e} evaluations in {c3_total['wall']:.1f} ms wall = "
          f"{c3_total['evals'] / c3_total['wall'] * 1e3:.4e} evals/s; from the timed chunks: "
          f"host {c3_total['host']:.1f} ms, K2 {c3_total['k2']:.1f} ms, K4 {c3_total['k4']:.1f} "
          f"ms, finalize {c3_total['fin']:.1f} ms, the rest of the wall (the on-card checks, "
          f"launch gaps) {c3_rest:.1f} ms; peak {c3_peak / 2**30:.2f} GiB; launches "
          f"K2 {c3_launches[aes_cuda.K2.name]}, K4 {c3_launches[aes_cuda.K4.name]} (mode walk "
          f"at levels 0-4: K6 {walk_launches_c3[aes_cuda.K6.name]}, K4 "
          f"{walk_launches_c3[aes_cuda.K4.name]})")
    print("config 3: every share pair of every key reconstructs ((r0 + r1) mod N == beta at "
          "alpha's prefix, 0 elsewhere) at every level; mode walk equals fused at levels 0-4, "
          "lane_slab pieces and two PreparedKeyBatch replays at level 5, mode levels at level "
          f"6; the host dpf.evaluate_at equals the card for {C3_CPU_KEYS} keys a party at "
          f"{C3_CPU_POINTS} points a level")
    torch.cuda.empty_cache()

    # -- 16. the FSS gates at bench_gates.py's configuration -------------------
    from distributed_point_functions_tpu_torch import gates, protos
    from distributed_point_functions_tpu_torch.gates import framework as gate_fw

    # The gates' DCFs have log-domain 16: 15 tree levels, 16 capturing depths.
    glevels = GATE_LOG_GROUP - 1
    gcaps = (True,) * (glevels + 1)
    # Sigmoid: 16 sites an input, 32,768 points (W = 1024) and a tuple of 16
    # Int(32)s in nb = 4 value blocks, hashed as 4 W words a depth.
    sig_w, sig_nb = 16 * GATE_BATCH // 32, 4
    a = walk_level_args(1, sig_w)
    hold("K6", aes_cuda.walk_level(*a), backend_torch.walk_level(*a))
    ms, device_ms = launch_ms(torch, lambda: aes_cuda.walk_level(*a), a[0].numel() * 4)
    plain_ms = time_ms(torch, lambda: backend_torch.walk_level(*a), 2)
    b_ms, b_by = bound_ms(*walk_level_cost(key_planes, 1, sig_w))
    rows["K6 gates"] = dict(kernel=aes_cuda.K6, ms=ms, device_ms=device_ms, plain_ms=plain_ms,
                            bound_ms=b_ms, bound_by=b_by)
    print(f"K6 at the sigmoid gate's shape K=1, W={sig_w}: {ms:.4f} ms (device "
          f"{device_ms:.4f} ms; plain {plain_ms:.2f} ms, bound {b_ms:.4f} ms by {b_by})")
    planes_g = rnd(1, 128, sig_nb * sig_w)
    hold("K4", aes_cuda.hash_value_planes(planes_g), backend_torch.hash_value_planes(planes_g))
    ms, device_ms = launch_ms(torch, lambda: aes_cuda.hash_value_planes(planes_g),
                              planes_g.numel() * 4)
    plain_ms = time_ms(torch, lambda: backend_torch.hash_value_planes(planes_g), 2)
    b_ms, b_by = bound_ms(*hash_cost(key_planes, 1, sig_nb * sig_w))
    rows["K4 gates"] = dict(kernel=aes_cuda.K4, ms=ms, device_ms=device_ms, plain_ms=plain_ms,
                            bound_ms=b_ms, bound_by=b_by)
    print(f"K4 at the sigmoid capture's shape K=1, nb x W={sig_nb} x {sig_w}: {ms:.4f} ms "
          f"(device {device_ms:.4f} ms; plain {plain_ms:.2f} ms, bound {b_ms:.4f} ms by {b_by})")
    del a, planes_g
    # K7's DCF form at DReLU's shape (one Int(128) key, 2 sites an input:
    # 4,096 points, W = 128) and bit decomposition's (16 keys, 32 sites:
    # 65,536 points, W = 2048).
    for row, k, w, party in (("K7 DCF drelu", 1, 2 * GATE_BATCH // 32, 1),
                             ("K7 DCF bits", GATE_LOG_GROUP, 32 * GATE_BATCH // 32, 0)):
        kw = dict(bits=128, party=party, xor_group=False, keep=1, captures=gcaps)
        a = dcf_mk_args(k, w, glevels, 128, 1)
        hold("K7 DCF", aes_cuda.walk_megakernel(*a, **kw), backend_torch.walk_megakernel(*a, **kw))
        plain_ms = time_ms(torch, lambda: backend_torch.walk_megakernel(*a, **kw), 1)
        ms, device_ms = launch_ms(torch, lambda: aes_cuda.walk_megakernel(*a, **kw),
                                  4 * k * 128 * w)
        b_ms, b_by = bound_ms(*walk_megakernel_cost(key_planes, k, w, glevels, 128, 1, party,
                                                    False, gcaps))
        rows[row] = dict(kernel=aes_cuda.K7_DCF, ms=ms, device_ms=device_ms, plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=b_by)
        print(f"K7 DCF form at K={k}, W={w}, L={glevels}, Int(128), party {party}, "
              f"{glevels + 1} captures: {ms:.4f} ms (device {device_ms:.4f} ms; plain "
              f"{plain_ms:.2f} ms, bound {b_ms:.4f} ms by {b_by})")
        del a
    torch.cuda.empty_cache()

    # The gates, drawn as bench_gates.py draws them: per gate r_in, r_outs
    # and GATE_REPS input sets, the first evaluated; bit decomposition and
    # the scalar-payload ReLU after them from the same stream. Key material
    # is pinned (CounterRng, dcf_seeds) so that the dealer's modes compare.
    grng = np.random.default_rng(GATE_SEED)
    srng = np.random.default_rng(GATE_SEED + 1)
    walk_only = dcf_batch.MODES[:1]
    gate_defs = (
        ("drelu", gates.DReluGate.create(GATE_LOG_GROUP), dcf_batch.MODES, "megakernel"),
        ("relu", gates.ReluGate.create(GATE_LOG_GROUP, payload="vector"), walk_only,
         "megakernel"),
        ("sigmoid", gates.SigmoidGate.create(GATE_LOG_GROUP, frac_bits=GATE_FRAC_BITS,
                                             payload="vector"), walk_only, "perlevel"),
        ("tanh", gates.TanhGate.create(GATE_LOG_GROUP, frac_bits=GATE_FRAC_BITS,
                                       payload="vector"), walk_only, None),
        ("bits", gates.BitDecompositionGate.create(GATE_LOG_GROUP), dcf_batch.MODES, None),
        ("relu scalar", gates.ReluGate.create(GATE_LOG_GROUP, payload="scalar"),
         dcf_batch.MODES, None),
    )
    gate_launches = {k.name: 0 for k in aes_cuda.KERNELS}
    k7_gate_launches = {}
    gate_rows = []

    def gate_plaintext(name, gate, x_real):
        if name == "drelu":
            return [int(x_real < gate.n // 2)]
        if name == "bits":
            return [(x_real >> j) & 1 for j in range(gate.log_group_size)]
        return [gate.plaintext(x_real)]

    def gate_key_bytes(gate, key):
        return protos.serialize_gate_key(key, gate.dcf.dpf.validator.parameters)

    for name, gate, modes, dealer_mode in gate_defs:
        n = gate.n
        out_mod = 2 if name == "bits" else n
        r_in = int(grng.integers(0, n))
        r_outs = [int(r) for r in grng.integers(0, out_mod, size=gate.num_outputs)]
        xs_sets = [[int(x) for x in grng.integers(0, n, size=GATE_BATCH)]
                   for _ in range(GATE_REPS if name in ("drelu", "relu", "sigmoid", "tanh")
                                  else 1)]
        xs = xs_sets[0]
        seeds = [(int.from_bytes(srng.bytes(16), "little"),
                  int.from_bytes(srng.bytes(16), "little")) for _ in range(gate.num_components)]
        pin = b"chip-smoke-" + name.encode()
        t = time.perf_counter()
        keys = gate.gen(r_in, r_outs, prng=gates.CounterRng(pin), dcf_seeds=seeds)
        dealer_ms = (time.perf_counter() - t) * 1e3
        key_bytes = len(gate_key_bytes(gate, keys[0]))
        card_dealer = ""
        if dealer_mode is not None:
            aes_cuda.reset_launch_counts()
            torch.cuda.synchronize()
            t = time.perf_counter()
            card_keys = gate.gen(r_in, r_outs, prng=gates.CounterRng(pin), dcf_seeds=seeds,
                                 keygen_mode=dealer_mode)
            card_ms = (time.perf_counter() - t) * 1e3
            need = ((aes_cuda.K9,) if dealer_mode == "megakernel"
                    else (aes_cuda.K2, aes_cuda.K4))
            counts = {k.name: k.launches for k in aes_cuda.KERNELS}
            for kern in need:
                if kern.launches == 0:
                    fail(f"gate {name}: the {dealer_mode} dealer ran without launching {kern.name}")
                main_launches[kern.name] = main_launches.get(kern.name, 0) + kern.launches
            for party in (0, 1):
                if gate_key_bytes(gate, card_keys[party]) != gate_key_bytes(gate, keys[party]):
                    fail(f"gate {name}: the {dealer_mode} dealer's keys differ from the host "
                         f"dealer's (party {party})")
            card_dealer = (f"; dealer mode {dealer_mode} on the card {card_ms:.1f} ms, "
                           f"byte-identical, launches "
                           f"{ {k: v for k, v in counts.items() if v} }")
        outs = {}
        for mode in modes:
            aes_cuda.reset_launch_counts()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            secs = []
            for party in (0, 1):
                t = time.perf_counter()
                outs[(mode, party)] = gate.batch_eval(keys[party], xs, mode=mode)
                secs.append(time.perf_counter() - t)
            peak = torch.cuda.max_memory_allocated()
            counts = {k.name: k.launches for k in aes_cuda.KERNELS}
            want = ({aes_cuda.K6.name: 2 * glevels, aes_cuda.K4.name: 2 * (glevels + 1)}
                    if mode == "walk" else {aes_cuda.K7_DCF.name: 2})
            if counts != {k.name: want.get(k.name, 0) for k in aes_cuda.KERNELS}:
                fail(f"gate {name}, mode {mode}: launches {counts}, expected {want}")
            for kname, v in counts.items():
                main_launches[kname] = main_launches.get(kname, 0) + v
                gate_launches[kname] += v
            if mode == "walkkernel":
                k7_gate_launches[name] = counts[aes_cuda.K7_DCF.name]
            # Every input reconstructs to the plaintext of its unmasked value.
            bad = 0
            for i, x in enumerate(xs):
                x_real = (x - r_in) % n
                got = [(int(a) + int(b) - r) % out_mod for a, b, r in
                       zip(outs[(mode, 0)][i], outs[(mode, 1)][i], r_outs)]
                bad += got != gate_plaintext(name, gate, x_real)
            if bad:
                fail(f"gate {name}, mode {mode}: {bad} of {GATE_BATCH} inputs do not reconstruct")
            if mode != modes[0] and any(
                    outs[(mode, p)].tolist() != outs[(modes[0], p)].tolist() for p in (0, 1)):
                fail(f"gate {name}: modes {modes[0]} and {mode} differ")
            # Where party 0's pass goes: batch_eval's own step times (the
            # plan, the DCF's key and point tables with their upload, the
            # walk on the card, the pull, the Python ints, the combine).
            steps = {}
            shares = gate.batch_eval(keys[0], xs, mode=mode, timings=steps)
            if shares.tolist() != outs[(mode, 0)].tolist():
                fail(f"gate {name}, mode {mode}: the timed pass differs from the first")
            del shares
            dev_ms = steps.pop("walk_card") * 1e3
            steps = {k: v * 1e3 for k, v in steps.items() if not k.endswith("_card")}
            walks = gate.num_components * gate.num_sites * GATE_BATCH
            print(f"gate {name}, mode {mode}: {gate.num_components} component key(s) x "
                  f"{gate.payload_elems} element(s), {key_bytes} B a key; host dealer "
                  f"{dealer_ms:.1f} ms{card_dealer}; {GATE_BATCH} inputs x {gate.num_sites} "
                  f"sites, wall {secs[0] * 1e3:.1f} / {secs[1] * 1e3:.1f} ms (parties 0 / 1) = "
                  f"{GATE_BATCH / min(secs):.4e} gate evals/s, {walks / min(secs):.4e} DCF "
                  f"walks/s; party 0: plan {steps['plan']:.1f} ms, key + point tables and "
                  f"upload {steps['tables']:.1f} ms, walk {steps['walk']:.1f} ms of which "
                  f"the card {dev_ms:.3f} ms, pull "
                  f"{steps['pull']:.1f} ms, Python ints {steps['ints']:.1f} ms, combine "
                  f"{steps['combine']:.1f} ms; launches "
                  f"{ {k: v for k, v in counts.items() if v} }; peak {peak / 2**20:.1f} MiB "
                  f"({(peak - base) / 2**20:.1f} MiB above what was allocated before)")
            gate_rows.append(dict(gate=name, mode=mode, wall_ms=[x * 1e3 for x in secs],
                                  device_ms=dev_ms, dealer_ms=dealer_ms,
                                  peak_mib=(peak - base) / 2**20, **steps))
            card_dealer = ""
        # The host gate.eval (one DCF evaluation a component and site, each
        # a root walk a level) against batch_eval, party 0. Bit decomposition
        # takes 512 such evaluations an input (~50 s on a CPU core at
        # log-group 16); its combine reads 2 of the 32 sites of each bit's
        # key, so there the host DCF is held against the card's pass at
        # those 32 sites of one input (the combine is held by every input's
        # reconstruction above).
        t = time.perf_counter()
        if name == "bits":
            checked = 1
            pts = gate_fw.GatePlan.build(gate, xs[:1]).points
            on_card = evaluator.values_to_numpy(
                gate.dcf.batch_evaluate(keys[0].dcf_keys, pts, mode=modes[0]), 128)
            for j, dk in enumerate(keys[0].dcf_keys):
                for site in (2 * j, 2 * j + 1):
                    if gate.dcf.evaluate(dk, pts[site]) != on_card[j, site]:
                        fail(f"gate {name}: the host DCF differs from the card's at key {j}, "
                             f"site {site}")
            what = "the host DCF equals the card's pass at the 32 sites the combine reads"
        else:
            checked = GATE_ORACLE_INPUTS
            host = [gate.eval(keys[0], xs[i]) for i in range(checked)]
            if host != outs[(modes[0], 0)][:checked].tolist():
                fail(f"gate {name}: the host gate.eval differs from batch_eval")
            what = "the host gate.eval equals batch_eval"
        print(f"gate {name}: every input reconstructs (mod {out_mod}) to the plaintext, "
              f"the modes agree, and {what} for {checked} input(s) "
              f"({time.perf_counter() - t:.2f} s on the host)")
        del outs
        torch.cuda.empty_cache()

    # The secure-inference leg (examples/secure_relu_demo.py): one key pair
    # an activation from gen_bundle, each party's keys through the wire
    # format, each server's layer in one bundle_eval on the card.
    lrng = np.random.default_rng(LAYER_SEED)
    layer_gates = {name: gate for name, gate, _, _ in gate_defs if name in ("relu", "sigmoid")}
    for name, size in (("relu", RELU_LAYER), ("sigmoid", SIGMOID_LAYER)):
        gate = layer_gates[name]
        n = gate.n
        if name == "relu":
            x_real = [int(v) for v in lrng.integers(-(n // 2), n // 2, size=size)]
        else:
            lim = int(6.0 * (1 << GATE_FRAC_BITS))
            x_real = [int(v) for v in lrng.integers(-lim, lim + 1, size=size)]
        x_raw = [v % n for v in x_real]
        r_ins = [int(r) for r in lrng.integers(0, n, size=size)]
        r_outs = [int(r) for r in lrng.integers(0, n, size=size)]
        t = time.perf_counter()
        bundle = gate.gen_bundle(r_ins, [[r] for r in r_outs])
        dealer_s = time.perf_counter() - t
        params = gate.dcf.dpf.validator.parameters
        wires = [[protos.serialize_gate_key(k, params) for k in ks] for ks in bundle]
        masked = [(x + r) % n for x, r in zip(x_raw, r_ins)]
        aes_cuda.reset_launch_counts()
        torch.cuda.synchronize()
        secs, layer = [], []
        for party in (0, 1):
            t = time.perf_counter()
            parsed = [protos.parse_gate_key(b) for b in wires[party]]
            layer.append(gates.bundle_eval(gate, parsed, masked))
            secs.append(time.perf_counter() - t)
        counts = {k.name: k.launches for k in aes_cuda.KERNELS}
        want = {aes_cuda.K6.name: 2 * glevels, aes_cuda.K4.name: 2 * (glevels + 1)}
        if counts != {k.name: want.get(k.name, 0) for k in aes_cuda.KERNELS}:
            fail(f"{name} layer: launches {counts}, expected {want}")
        for kname, v in counts.items():
            main_launches[kname] = main_launches.get(kname, 0) + v
            gate_launches[kname] += v
        bad = sum((int(layer[0][b, 0]) + int(layer[1][b, 0]) - r_outs[b]) % n
                  != gate.plaintext(x_raw[b]) for b in range(size))
        if bad:
            fail(f"{name} layer: {bad} of {size} activations do not reconstruct")
        print(f"{name} layer: {size} activations, dealer (gen_bundle) {dealer_s * 1e3:.1f} ms, "
              f"{sum(map(len, wires[0])) / size:.0f} B a key on the wire; parse + bundle_eval "
              f"({size} keys x {size * gate.num_sites} points, one DCF pass) "
              f"{secs[0] * 1e3:.1f} / {secs[1] * 1e3:.1f} ms (servers A / B); launches "
              f"{ {k: v for k, v in counts.items() if v} }; the client's reconstruction equals "
              "the plaintext for every activation")
        del layer, bundle
    print(card)
    print("gates: " + json.dumps(gate_rows))
    torch.cuda.empty_cache()

    # -- 17. the EvaluationContext API; 18. PIR in natural order -------------------
    new_paths = PathCounts(aes_cuda)
    phase_17(torch, T, dev, hh, dict(dpf=c3dpf, keys=c3keys, alphas=c3_alphas, betas=c3_betas,
                                     domains=c3_domains), PHASE17, new_paths)
    del hh
    torch.cuda.empty_cache()
    print(card)
    phase_18(torch, T, dev, p4, PHASE18, new_paths)
    print(card)
    for name, n in new_paths.total.items():
        main_launches[name] = main_launches.get(name, 0) + n
    print(f"phases 17 and 18: launches {new_paths.total}")
    torch.cuda.empty_cache()

    # -- 19. the resilience layer ---------------------------------------------
    resilience = PathCounts(aes_cuda)
    phase_19(torch, T, dev, fold_case, p4,
             dict(PHASE19, fold_chunk=KEY_CHUNK, pir_chunk=KEY_CHUNK), resilience, events)
    print(card)
    for name, n in resilience.total.items():
        main_launches[name] = main_launches.get(name, 0) + n
    print(f"phase 19: launches {resilience.total}")
    events.check_all()
    torch.cuda.empty_cache()

    # -- 20. the serving plane ------------------------------------------------
    served = PathCounts(aes_cuda)
    phase_20(torch, T, dev, p4, PHASE20, served, card)
    for name, n in served.total.items():
        main_launches[name] = main_launches.get(name, 0) + n
    print(f"phase 20: launches {served.total}")
    torch.cuda.empty_cache()

    if "jax" in sys.modules:
        fail("JAX was imported")
    if any(m == "distributed_point_functions_tpu" or m.startswith("distributed_point_functions_tpu.")
           for m in sys.modules):
        fail("the JAX package was imported")

    # -- result -------------------------------------------------------------
    column_form = {k.name for k in (aes_cuda.K2, aes_cuda.K3, aes_cuda.K4, aes_cuda.K5,
                                    aes_cuda.K6, aes_cuda.K7, aes_cuda.K7_DCF, aes_cuda.K9)}
    kernels = [{
        "name": "K1 aes_rows, row form (device function inlined in K8; timed as K8 on window 4 "
                f"of the heavy hitters, K={HH_CHUNK})",
        "route": "cuda",
        "source": "distributed_point_functions_tpu_torch/csrc/aes_rows.cuh",
        "replaces": "distributed_point_functions_tpu/ops/aes_pallas.py:182",
        "launches": sum(n for name, n in main_launches.items() if name not in column_form),
        "max_abs_err": checks["K8"],
        "ms": rows["K8"]["ms"],
        "device_ms": rows["K8"].get("device_ms"),
        "plain_ms": rows["K8"]["plain_ms"],
        "bound_ms": rows["K8"]["bound_ms"],
        "bound_by": rows["K8"]["bound_by"],
        "library_ms": None,
    }]
    kernels.append({
        "name": "K1 column form, four threads a lane word (device function inlined in K2-K6, "
                "both forms of K7 and K9; timed as K5)",
        "route": "cuda",
        "source": "distributed_point_functions_tpu_torch/csrc/aes_quad.cuh",
        "replaces": "distributed_point_functions_tpu/ops/aes_pallas.py:182",
        "launches": sum(main_launches.get(name, 0) for name in column_form),
        "max_abs_err": checks["K5"],
        "ms": rows["K5"]["ms"],
        "device_ms": rows["K5"].get("device_ms"),
        "plain_ms": rows["K5"]["plain_ms"],
        "bound_ms": rows["K5"]["bound_ms"],
        "bound_by": rows["K5"]["bound_by"],
        "library_ms": None,
    })
    kernels.append({
        "name": "K1 per-lane key select (aes_quad.cuh QuadMaskedKey, in K6 and both forms of K7; "
                "aes_rows.cuh MaskedKey, inlined in K8; timed as K6)",
        "route": "cuda",
        "source": "distributed_point_functions_tpu_torch/csrc/aes_quad.cuh",
        "replaces": "distributed_point_functions_tpu/ops/aes_pallas.py:182",
        "launches": (walk_launches[aes_cuda.K6.name] + walk_launches[aes_cuda.K7.name]
                     + dcf_launches[aes_cuda.K6.name] + dcf_launches[aes_cuda.K7_DCF.name]
                     + hh_launches[aes_cuda.K8.name] + codec_walk_launches[aes_cuda.K6.name]
                     + walk_launches_c3[aes_cuda.K6.name] + gate_launches[aes_cuda.K6.name]
                     + gate_launches[aes_cuda.K7_DCF.name] + new_paths.total[aes_cuda.K6.name]
                     + served.total[aes_cuda.K6.name] + served.total[aes_cuda.K7.name]
                     + served.total[aes_cuda.K7_DCF.name] + served.total[aes_cuda.K8.name]),
        "max_abs_err": checks["K6"],
        "ms": rows["K6"]["ms"],
        "device_ms": rows["K6"].get("device_ms"),
        "plain_ms": rows["K6"]["plain_ms"],
        "bound_ms": rows["K6"]["bound_ms"],
        "bound_by": rows["K6"]["bound_by"],
        "library_ms": None,
    })
    shapes = {"K4 walk": ("EvaluateAt's shape", walk_launches),
              "K4 dcf": ("the DCF's shape", dcf_launches),
              "K6 dcf": ("the DCF's shape", dcf_launches),
              "K2 hh": ("the hierarchy's shape", hh_launches),
              "K4 hh": ("the hierarchy's shape", hh_launches),
              "K2 c3": ("config 3's widest shape", c3_launches),
              "K4 c3": ("config 3's widest shape", c3_launches),
              "K6 c3": ("the full-domain walk's shape, config 3", walk_launches_c3),
              "K4 gates": ("the sigmoid gate's capture, nb x W = 4 x 1024; launches: every "
                           "gate path", gate_launches),
              "K6 gates": ("the sigmoid gate's shape, K = 1, W = 1024; launches: every gate "
                           "path", gate_launches),
              "K7 DCF drelu": ("DReLU's shape, K = 1, W = 128, Int(128)",
                               {aes_cuda.K7_DCF.name: k7_gate_launches["drelu"]}),
              "K7 DCF bits": ("bit decomposition's shape, K = 16, W = 2048, Int(128)",
                              {aes_cuda.K7_DCF.name: k7_gate_launches["bits"]})}
    for name, line, source in (("K2", 315, "expand.cu"), ("K3", 421, "expand.cu"),
                               ("K4", 462, "expand.cu"), ("K4 walk", 462, "expand.cu"),
                               ("K4 dcf", 462, "expand.cu"),
                               ("K5", 872, "megakernel.cu"), ("K6", 522, "walk.cu"),
                               ("K6 dcf", 522, "walk.cu"),
                               ("K7", 1518, "walk_megakernel.cu"),
                               ("K7 DCF", 1518, "walk_megakernel.cu"),
                               ("K2 hh", 315, "expand.cu"), ("K4 hh", 462, "expand.cu"),
                               ("K8", 1393, "hier_megakernel.cu"),
                               ("K2 c3", 315, "expand.cu"), ("K4 c3", 462, "expand.cu"),
                               ("K6 c3", 522, "walk.cu"), ("K4 gates", 462, "expand.cu"),
                               ("K6 gates", 522, "walk.cu"),
                               ("K7 DCF drelu", 1518, "walk_megakernel.cu"),
                               ("K7 DCF bits", 1518, "walk_megakernel.cu")):
        r = rows[name]
        launches = main_launches.get(r["kernel"].name, 0)
        label = r["kernel"].name
        if name in shapes:
            shape, counts = shapes[name]
            launches = counts[r["kernel"].name]
            label += f" ({shape})"
        kernels.append({
            "name": label,
            "route": "cuda",
            "source": f"distributed_point_functions_tpu_torch/csrc/{source}",
            "replaces": f"distributed_point_functions_tpu/ops/aes_pallas.py:{line}",
            "launches": launches,
            "max_abs_err": checks["K7 DCF" if name.startswith("K7 DCF") else name.split()[0]],
            "ms": r["ms"],
            "device_ms": r.get("device_ms"),
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            "library_ms": None,
        })
    k9_total = kg_launches[(aes_cuda.K9.name, "megakernel")]
    for name, label, launches in (
        ("K9", "K9 keygen_megakernel (BM_KeyGeneration, 1024 keys, depth 20)", k9_total),
        ("K9 d128", "K9 keygen_megakernel (1024 keys, depth 128)", 1),
        ("K9 dcf", "K9 keygen_megakernel (BASELINE config 4's DCF dealer)", 1),
        ("K2 legacy", "K2 one-key view, the legacy [128, W] kernel (W = 8192; mode "
                      "perlevel's K2 launches go through it)",
         kg_launches[(aes_cuda.K2.name, "perlevel")]),
    ):
        r = rows[name]
        legacy = name == "K2 legacy"
        kernels.append({
            "name": label,
            "route": "cuda",
            "source": "distributed_point_functions_tpu_torch/csrc/"
                      + ("expand.cu" if legacy else "keygen_megakernel.cu"),
            "replaces": "distributed_point_functions_tpu/ops/aes_pallas.py:"
                        + ("105" if legacy else "1802"),
            "launches": launches,
            "max_abs_err": checks["K2 legacy" if legacy else "K9"],
            "ms": r["ms"],
            "device_ms": r.get("device_ms"),
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
