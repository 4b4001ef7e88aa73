"""Runs the sparse-histogram experiment over the reference's published
grid: 2^20 nonzeros of the three distributions of ``gen_data`` at 2^32 and
2^128, each hierarchical (expansion factor 4) and direct, 3 iterations, on
each engine, one ``synthetic_data_benchmarks`` process a row, as a user
runs it.

    python -m distributed_point_functions_tpu_torch.experiments.sweep [--out rows.jsonl]

Engine ``device`` runs on the card (the CLI's default device); ``host`` is
``--engine host --device cpu``, the native AES-NI host engine on one
thread. Missing fixtures are generated first, into the package's
``experiments/data/``. Each row's JSON (the CLI's last line, with the
process's wall) goes to ``--out``; the card's name and power limit
(``nvidia-smi``) and the host CPU head the output. Exits 1 if any row
failed.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

from . import gen_data

_CLI = "distributed_point_functions_tpu_torch.experiments.synthetic_data_benchmarks"
LOG_DOMAINS = (32, 128)
NUM_NONZEROS = 1 << 20
NUM_ITERATIONS = 3
MAX_EXPANSION_FACTOR = 4
ENGINES = ("device", "host")
DATA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default="", help="a JSON-lines file the rows are appended to")
    args = ap.parse_args(argv)
    from .. import native
    from ..utils.devices import card_line

    print(f"# card: {card_line()}; host CPU: {native.cpu_model()}", flush=True)
    os.makedirs(DATA_DIR, exist_ok=True)
    failed = 0
    out = open(args.out, "a") if args.out else None
    try:
        for lds in LOG_DOMAINS:
            for skew in gen_data.SKEWS:
                path = os.path.join(DATA_DIR, gen_data.fixture_name(lds, NUM_NONZEROS, skew))
                if not os.path.exists(path):
                    t0 = time.perf_counter()
                    gen_data.write_fixture(DATA_DIR, lds, NUM_NONZEROS, skew)
                    print(f"# wrote {path} in {time.perf_counter() - t0:.1f} s", flush=True)
                for engine in ENGINES:
                    for only in (False, True):
                        cmd = [sys.executable, "-m", _CLI, "--input", path,
                               "--log_domain_size", str(lds), "--num_iterations",
                               str(NUM_ITERATIONS), "--max_expansion_factor",
                               str(MAX_EXPANSION_FACTOR)]
                        cmd += ["--only_nonzeros"] if only else []
                        cmd += ["--engine", "host", "--device", "cpu"] if engine == "host" else []
                        t0 = time.perf_counter()
                        res = subprocess.run(cmd, capture_output=True, text=True)
                        wall = time.perf_counter() - t0
                        lines = res.stdout.strip().splitlines()
                        if res.returncode or not lines:
                            failed += 1
                            print(f"FAILED ({res.returncode}): {' '.join(cmd[2:])}\n"
                                  + res.stderr[-3000:], flush=True)
                            continue
                        row = dict(json.loads(lines[-1]), process_seconds=wall)
                        print(json.dumps(row), flush=True)
                        if out:
                            out.write(json.dumps(row) + "\n")
                            out.flush()
    finally:
        if out:
            out.close()
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
