#!/usr/bin/env python3
"""Times the fold's and PIR's wall of one or more checkouts of the port on
the same card, in turns.

Run from the root of the repository, on a machine with a CUDA card, the
CUDA toolkit and PyTorch:

    python3 fold_walls.py ROOT [ROOT ...]

Each ROOT is a checkout of this repository (for example ``.`` and an
unpacked ``git archive`` of its parent commit). As in expand_times.py, the
checkouts' kernels are built first, all at once, each into its own ignored
``_build/``; then each checkout is timed in a fresh process in the order
ROOT..., then in reverse (parent, change, change, parent for two). A pass
runs bench.py's configuration (bench.py:105-120: log-domain 20, Int(64),
1024 keys a party, key chunk 128; chip_smoke.py's SEED) through
``full_domain_fold_chunks`` in modes fold and megakernel with each
checkout's defaults, the folds kept on the card and pulled once at the end
(chip_smoke.py phase 3's consumer), and phase 4's PIR (2^20 x
XorWrapper(128), 128 queries a server, key chunk 128) through
``pir_query_batch_chunked`` in modes fold (key chunk 64) and megakernel,
which pulls every chunk's answers. Each wall is a host clock around one
call of party 0 and one of party 1, after a synchronize, three times; a
pass prints one JSON line with the card's name and power limit and every
wall, and the last line is a table of the best wall per path, checkout
and pass. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

from chip_smoke import KEY_CHUNK, LOG_DOMAIN, NUM_KEYS, PIR_QUERIES, SEED, card_line

REPS = 3


def load(root: Path):
    """The package of checkout `root` (and its kernels, built)."""
    sys.path.insert(0, str(root.resolve()))
    import distributed_point_functions_tpu_torch as T
    from distributed_point_functions_tpu_torch.ops import aes_cuda

    if not Path(T.__file__).resolve().is_relative_to(root.resolve()):
        raise SystemExit(f"imported {T.__file__}, not the package of {root}")
    aes_cuda.library()
    return T


def walls(root: Path) -> dict:
    import torch

    T = load(root)
    from distributed_point_functions_tpu_torch.ops import aes_torch, evaluator
    from distributed_point_functions_tpu_torch.parallel import pir

    rng = np.random.default_rng(SEED)
    dpf = T.DistributedPointFunction.create(T.DpfParameters(LOG_DOMAIN, T.Int(64)))
    keys = dpf.generate_keys_batch(
        [int(a) for a in rng.integers(0, 1 << LOG_DOMAIN, size=NUM_KEYS)],
        [[int(b) for b in rng.integers(1, 2**63, size=NUM_KEYS, dtype=np.uint64)]],
        seeds=rng.integers(0, 2**32, size=(NUM_KEYS, 2, 4), dtype=np.uint32))
    pdpf = T.DistributedPointFunction.create(T.DpfParameters(LOG_DOMAIN, T.XorWrapper(128)))
    db = rng.integers(0, 2**32, size=(1 << LOG_DOMAIN, 4), dtype=np.uint32)
    targets = [int(a) for a in rng.integers(0, 1 << LOG_DOMAIN, size=PIR_QUERIES)]
    queries = pdpf.generate_keys_batch(
        targets, [(1 << 128) - 1],
        seeds=rng.integers(0, 2**32, size=(PIR_QUERIES, 2, 4), dtype=np.uint32))
    dbs = {mode: pir.prepare_pir_database(pdpf, db, order=order)
           for mode, order in (("fold", "lane"), ("megakernel", "megakernel"))}

    def fold(party_keys, mode):
        out = [f[:v] for v, f in evaluator.full_domain_fold_chunks(
            dpf, party_keys, key_chunk=KEY_CHUNK, mode=mode)]
        return aes_torch.from_words(torch.cat(out))

    def answer(q, mode):
        return pir.pir_query_batch_chunked(pdpf, q, dbs[mode],
                                           key_chunk=KEY_CHUNK if mode == "megakernel" else 64,
                                           mode=mode)

    out = {}
    for name, call, batches in (("fold fold", lambda k: fold(k, "fold"), keys),
                                ("fold megakernel", lambda k: fold(k, "megakernel"), keys),
                                ("PIR fold", lambda q: answer(q, "fold"), queries),
                                ("PIR megakernel", lambda q: answer(q, "megakernel"), queries)):
        call(batches[0])  # warm-up
        results, times = [], []
        for _ in range(REPS):
            for party in (0, 1):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                results.append(call(batches[party]))
                times.append((time.perf_counter() - t0) * 1e3)
        if name.startswith("PIR") and not np.array_equal(results[0] ^ results[1], db[targets]):
            raise SystemExit(f"{name}: the answers do not reconstruct")
        out[name] = [round(t, 2) for t in times]
    return {"root": str(root), "card": card_line(), "wall_ms": out}


def main() -> None:
    if len(sys.argv) >= 3 and sys.argv[1] in ("--build", "--time"):
        root = Path(sys.argv[2])
        if sys.argv[1] == "--build":
            load(root)
        else:
            print(json.dumps(walls(root)), flush=True)
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
        for name, times in result["wall_ms"].items():
            table.setdefault(name, {}).setdefault(str(root), []).append(min(times))
    print(json.dumps(table))


if __name__ == "__main__":
    main()
