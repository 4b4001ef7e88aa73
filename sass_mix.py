#!/usr/bin/env python3
"""Counts the SASS instructions of the port's CUDA kernels, loop by loop.

Run from the root of the repository, on a machine with the CUDA toolkit
(``nvcc`` and ``cuobjdump``) and PyTorch:

    python3 sass_mix.py [--out DIR] [source.cu ...]

Each source under distributed_point_functions_tpu_torch/csrc/ (by default
megakernel.cu, expand.cu, walk.cu, walk_megakernel.cu and
keygen_megakernel.cu) is
compiled by ``nvcc`` for sm_90a into a
cubin under DIR (by default the ignored
distributed_point_functions_tpu_torch/_build/sass/, with the round-key
headers the extension build generates), disassembled by ``cuobjdump
-sass`` (the listing kept beside the cubin), and for every ``__global__``
kernel the script prints its instruction count and, for each loop of at
least 100 instructions (a backward branch and the code it jumps back
over: the AES round loops), the loop's size and its opcode mix. Instruction counts per round loop, times
the hashes a kernel runs, say how many instructions it must issue. Imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import collections
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CSRC = ROOT / "distributed_point_functions_tpu_torch" / "csrc"
LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)\s*([^;]*);")
MIN_LOOP = 100


def build(source: str, out: Path) -> str:
    """The SASS listing of csrc/`source` compiled for sm_90a into `out`."""
    sys.path.insert(0, str(ROOT))
    from distributed_point_functions_tpu_torch.ops import aes_cuda

    include = out / "include"
    include.mkdir(parents=True, exist_ok=True)
    aes_cuda.write_key_headers(include)
    cubin = out / (Path(source).stem + ".cubin")
    subprocess.run(
        ["nvcc", "-cubin", "-O3", "-std=c++17", "-gencode=arch=compute_90a,code=sm_90a",
         "-Xptxas", "-v", "-I", str(include), "-I", str(CSRC), "-o", str(cubin),
         str(CSRC / source)],
        check=True, timeout=600,
    )
    listing = subprocess.run(["cuobjdump", "-sass", str(cubin)], check=True, timeout=120,
                             capture_output=True, text=True).stdout
    cubin.with_suffix(".sass").write_text(listing)
    return listing


def functions(listing: str):
    """(name, [(address, opcode, operands)]) for each function of a listing."""
    name, body = None, []
    for line in listing.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            if name is not None:
                yield name, body
            name, body = m.group(1), []
            continue
        m = LINE.search(line)
        if m and name is not None:
            body.append((int(m.group(1), 16), m.group(3), m.group(4)))
    if name is not None:
        yield name, body


def mix(instructions) -> str:
    counts = collections.Counter(op.split(".")[0] for _, op, _ in instructions)
    return ", ".join(f"{op} {n}" for op, n in counts.most_common(12))


def report(name: str, body) -> None:
    print(f"{name}: {len(body)} instructions")
    loops = set()
    for addr, op, args in body:
        if op.startswith("BRA"):
            m = re.search(r"0x([0-9a-f]+)", args)
            if m and int(m.group(1), 16) < addr:
                loops.add((int(m.group(1), 16), addr))
    for start, end in sorted(loops):
        inside = [i for i in body if start <= i[0] <= end]
        if len(inside) >= MIN_LOOP:
            print(f"  loop {start:#x}-{end:#x}: {len(inside)} instructions: {mix(inside)}")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", type=Path,
                        default=ROOT / "distributed_point_functions_tpu_torch" / "_build" / "sass",
                        help="directory for the cubins and listings")
    parser.add_argument("sources", nargs="*", default=["megakernel.cu", "expand.cu", "walk.cu",
                                                       "walk_megakernel.cu",
                                                       "keygen_megakernel.cu"])
    args = parser.parse_args()
    for source in args.sources:
        print(f"== {source}")
        for name, body in functions(build(source, args.out)):
            report(name, body)


if __name__ == "__main__":
    main()
