#!/usr/bin/env python3
"""Times the kernels that run K1's column form (K2-K6, both forms of K7 and
K9) of one or more checkouts of the port on the same card, in turns.

Run from the root of the repository, on a machine with a CUDA card, the
CUDA toolkit and PyTorch:

    python3 expand_times.py ROOT [ROOT ...]

Each ROOT is a checkout of this repository (for example ``.`` and an
unpacked ``git archive`` of its parent commit). The script first builds
each checkout's kernels, all at once, each in its own process, into that
checkout's ignored ``_build/``; then it times the checkouts in the order
ROOT..., then in reverse (parent, change, change, parent for two), each
pass in a fresh process that imports that checkout's package. Every pass
times with this checkout's chip_smoke.py (``launch_ms``, ``time_ms``,
``k2_width_times``), so both sides are measured alike: "ms" is one call
from the host, as chip_smoke.py's ``ms``, and "device_ms" the device time
of one launch from a CUDA graph's replay, on random words from a fixed
seed. A pass prints one JSON line: the checkout, the card's name and power
limit, each kernel's ptxas report and these times:

- K2 at K = 128 keys and every input width of the fold, W = 1 to 16,384
  (chip_smoke.py's per-width line; W = 16,384 is its widest shape);
- K2 at the heavy-hitters shape, K = 128, W = 317; K2's one-key view at
  W = 8,192 (benchmarks/micro_tpu.py's width);
- K3 at K = 128, W = 16,384; K4 at K = 128, W = 32,768 (the fold's and
  PIR's last width), at the hierarchy's shape (K = 128, W = 634), at
  EvaluateAt's (K = 1024, W = 128) and at BASELINE config 4's DCF (K = 512,
  W = 16); K5 at the fold's plan (log-domain 20, Int(64), K = 128; ms
  only);
- K6, one walk level, at EvaluateAt's shape and at the DCF's;
- K7 at EvaluateAt's shape (K = 1024, W = 128, L = 31, Int(64) keep 2,
  party 1) and its DCF form at BASELINE config 4's (K = 512, W = 16, L =
  23, 24 captures);
- K9 at BM_KeyGeneration's 1024 keys (W = 32) at depths 20 and 128 (L = 19
  and 127, one capture), at config 4's DCF dealer (W = 16, L = 23, 24
  captures) and at 16,384 keys, depth 128 (W = 512).

The last line is a table of each kernel's times per checkout and pass.
Imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

from chip_smoke import (
    KEY_CHUNK, LEGACY_W, SEED, card_line, expand_args, k2_width_times, launch_ms,
    planes_bytes, time_ms, word_source,
)

WIDTHS = [1 << i for i in range(15)]
HH_W = 317


def load(root: Path):
    """The package of checkout `root` (and its kernels, built)."""
    sys.path.insert(0, str(root.resolve()))
    import distributed_point_functions_tpu_torch as T
    from distributed_point_functions_tpu_torch.ops import aes_cuda, evaluator

    if not Path(T.__file__).resolve().is_relative_to(root.resolve()):
        raise SystemExit(f"imported {T.__file__}, not the package of {root}")
    aes_cuda.library()
    return T, aes_cuda, evaluator


def timings(root: Path) -> dict:
    import torch

    T, aes_cuda, evaluator = load(root)
    dev = torch.device("cuda")
    rnd = word_source(torch, torch.Generator(device=dev).manual_seed(SEED))
    times = {f"K2 W={w}": t for w, t in k2_width_times(torch, aes_cuda, rnd, WIDTHS).items()}

    def run(name, fn, out_bytes, reps=10):
        times[name] = launch_ms(torch, fn, out_bytes, reps)

    a = expand_args(rnd, KEY_CHUNK, HH_W)
    run(f"K2 hh W={HH_W}", lambda: aes_cuda.expand_one_level(*a), planes_bytes(KEY_CHUNK, 2 * HH_W))
    a = [x[0] for x in expand_args(rnd, 1, LEGACY_W)]
    run(f"K2 one-key W={LEGACY_W}", lambda: aes_cuda.expand_one_level_single(*a),
        planes_bytes(1, 2 * LEGACY_W))
    a = expand_args(rnd, KEY_CHUNK, WIDTHS[-1])
    run(f"K3 W={WIDTHS[-1]}", lambda: aes_cuda.expand_and_hash_last_level(*a),
        planes_bytes(KEY_CHUNK, 2 * WIDTHS[-1]), 5)
    del a
    planes = rnd(KEY_CHUNK, 128, 2 * WIDTHS[-1])
    run(f"K4 W={2 * WIDTHS[-1]}", lambda: aes_cuda.hash_value_planes(planes),
        planes_bytes(KEY_CHUNK, 2 * WIDTHS[-1]), 5)
    planes = rnd(KEY_CHUNK, 128, 2 * HH_W)
    run(f"K4 hh W={2 * HH_W}", lambda: aes_cuda.hash_value_planes(planes),
        planes_bytes(KEY_CHUNK, 2 * HH_W))
    for k, w in ((1024, 128), (512, 16)):
        a = (rnd(k, 128, w), rnd(k, w), rnd(w), rnd(k, 128), rnd(k), rnd(k))
        run(f"K4 K={k} W={w}", lambda: aes_cuda.hash_value_planes(a[0]), planes_bytes(k, w))
        run(f"K6 K={k} W={w}", lambda: aes_cuda.walk_level(*a), planes_bytes(k, w))
    del planes, a
    dpf = T.DistributedPointFunction.create(T.DpfParameters(20, T.Int(64)))
    plan = evaluator.plan_megakernel(dpf, budget=evaluator.MEGAKERNEL_BUDGET)
    levels = plan.levels_a + plan.levels_b
    mk = (rnd(KEY_CHUNK, 128, plan.entry_words), rnd(KEY_CHUNK, plan.entry_words),
          rnd(KEY_CHUNK, levels, 128), rnd(KEY_CHUNK, levels), rnd(KEY_CHUNK, levels),
          rnd(KEY_CHUNK, 2, 2))
    kw = dict(plan=plan, bits=64, party=0, xor_group=False, keep=2)
    k5_ms = time_ms(torch, lambda: aes_cuda.megakernel_fold(*mk, **kw), 5)
    del mk
    for name, k, w, levels, captures in (("K7", 1024, 128, 31, None),
                                         ("K7 DCF", 512, 16, 23, (True,) * 24)):
        rows = 2 if captures is None else 2 * (levels + 1)
        a = (rnd(k, 128), rnd(levels, w), rnd(k, levels, 128), rnd(k, levels), rnd(k, levels),
             rnd(k, rows, 2), rnd(rows, w))
        kw = dict(bits=64, party=1, xor_group=False, keep=2, captures=captures)
        run(f"{name} K={k} W={w} L={levels}", lambda: aes_cuda.walk_megakernel(*a, **kw),
            4 * k * 64 * w, 5)
    for keys, levels, slots in ((1024, 19, 1), (1024, 127, 1), (512, 23, 24), (16384, 127, 1)):
        w = keys // 32
        a = (rnd(128, w), rnd(128, w), rnd(levels, w))
        captures = (False,) * (levels + 1 - slots) + (True,) * slots
        run(f"K9 keys={keys} L={levels} captures={slots}",
            lambda: aes_cuda.keygen_megakernel(*a, captures=captures),
            4 * w * (levels * 130 + slots * 257), 5)
    del a
    kernels = (aes_cuda.K2, aes_cuda.K3, aes_cuda.K4, aes_cuda.K5, aes_cuda.K6, aes_cuda.K7,
               aes_cuda.K7_DCF, aes_cuda.K9)
    return {"root": str(root), "card": card_line(),
            "ms": {**{k: round(t[0], 4) for k, t in times.items()},
                   "K5 fold plan": round(k5_ms, 4)},
            "device_ms": {k: round(t[1], 4) for k, t in times.items()},
            "ptxas": {k.name: k.ptxas for k in kernels}}


def main() -> None:
    if len(sys.argv) >= 3 and sys.argv[1] in ("--build", "--time"):
        root = Path(sys.argv[2])
        if sys.argv[1] == "--build":
            load(root)
        else:
            print(json.dumps(timings(root)), flush=True)
        return
    roots = [Path(r) for r in sys.argv[1:]]
    if not roots:
        raise SystemExit(__doc__)
    me = str(Path(__file__).resolve())
    builds = [subprocess.Popen([sys.executable, me, "--build", str(r)]) for r in roots]
    if any(p.wait() for p in builds):
        raise SystemExit("a build failed")
    table = {}
    for root in roots + roots[::-1]:
        line = subprocess.run([sys.executable, me, "--time", str(root)], check=True,
                              capture_output=True, text=True, timeout=1200).stdout.strip()
        print(line, flush=True)
        result = json.loads(line.splitlines()[-1])
        for kind in ("ms", "device_ms"):
            for name, ms in result[kind].items():
                table.setdefault(f"{name} {kind}", {}).setdefault(str(root), []).append(ms)
    print(json.dumps(table))


if __name__ == "__main__":
    main()
