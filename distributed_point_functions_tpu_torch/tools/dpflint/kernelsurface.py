"""kernel-surface checker: the port's counterpart of ``mosaic-opset``.

The JAX package's ``mosaic-opset`` keeps each Pallas kernel body inside the
op set the hardware proved, because the kernels could not be run in CI.
The port's kernels cannot run in CI either (no card, no ``nvcc``), and what
stands in for a run there is the g++ build: ``tests/test_torch_kernels.py``
compiles the kernels' ``__device__`` bodies from their headers with g++ and
holds them bit-exact against the plain PyTorch versions. That proof covers
a kernel only while the kernel's work lives in those headers. So:

* every ``__global__`` in ``csrc/*.cu`` calls (directly, or through the
  ``.cu`` file's own ``__device__`` helpers) a ``__device__`` function
  defined in a header that the g++ harness includes, directly or through
  the headers those include;
* PyTorch's headers (``torch/``, ``ATen/``, ``c10/``) are included in
  ``csrc/binding.cpp`` alone, so the ``.cu`` files build with ``nvcc`` in
  seconds and the headers with g++ at all;
* every host function declared in ``csrc/expand.h`` (the launchers) is
  called exactly once in ``binding.cpp``: one binding, no second path.

All three are hard violations; nothing here is pinned.
"""

from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import Dict, List, Set, Tuple

from . import csource
from .core import CSRC, KERNEL_TEST, Finding, Module, Pins, module_at

NAME = "kernel-surface"

BINDING = "binding.cpp"
LAUNCHERS = "expand.h"
TORCH_HEADERS = ("torch/", "ATen/", "c10/")


def harness_headers(modules: List[Module]) -> Set[str]:
    """The headers the g++ harness of the kernel test includes: the quoted
    #includes of its string constants that hold C++ (``_HARNESS``)."""
    mod = module_at(modules, KERNEL_TEST)
    out: Set[str] = set()
    if mod is None:
        return out
    for node in mod.nodes:
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            out.update(m.group(1) for m in re.finditer(r'#include\s+"([^"]+)"', node.value))
    return out


def _reaches(name: str, local: Dict[str, str], covered: Set[str], seen: Set[str]) -> bool:
    if name in covered:
        return True
    if name in seen or name not in local:
        return False
    seen.add(name)
    return any(_reaches(c, local, covered, seen) for c in csource.calls(local[name]))


def check(modules: List[Module], root: Path) -> Tuple[List[Finding], Pins, Dict[str, int]]:
    violations: List[Finding] = []
    csrc = root / CSRC
    if not csrc.is_dir():
        return violations, {}, {}

    # Rule 1: each kernel reaches a header body the g++ harness builds.
    reachable = csource.include_closure(csrc, harness_headers(modules))
    covered: Set[str] = set()
    for header in reachable:
        covered.update(csource.device_functions(csource.read(csrc / header)))
    for cu in sorted(csrc.glob("*.cu")):
        text = csource.read(cu)
        local = csource.device_functions(text)
        rel = f"{CSRC}/{cu.name}"
        for kernel, line, body in csource.global_kernels(text):
            if not any(_reaches(c, local, covered, set()) for c in csource.calls(body)):
                violations.append(Finding(
                    NAME, rel, line,
                    f"__global__ {kernel} calls no __device__ body from a header that the "
                    f"g++ build of {KERNEL_TEST} includes",
                    hint="move the kernel's work into a __device__ function in a *_rows.cuh / "
                    "*_quad.cuh header and include it in the test's _HARNESS, so the plain "
                    "versions hold it on the CPU",
                ))

    # Rule 2: PyTorch's headers in binding.cpp alone.
    for path in sorted(csrc.iterdir()):
        if path.suffix not in (".cu", ".cuh", ".h", ".cpp", ".cc") or path.name == BINDING:
            continue
        for _, header, line in csource.includes(csource.read(path)):
            if header.startswith(TORCH_HEADERS):
                violations.append(Finding(
                    NAME, f"{CSRC}/{path.name}", line,
                    f"#include <{header}> outside {BINDING}",
                    hint=f"keep PyTorch's headers in csrc/{BINDING}: the kernels and their "
                    "bodies build with nvcc alone and with g++",
                ))

    # Rule 3: each launcher of expand.h bound once.
    binding = csource.read(csrc / BINDING)
    header = csource.read(csrc / LAUNCHERS)
    for launcher, line in csource.declarations(header):
        n = len(re.findall(rf"\bdpf::{re.escape(launcher)}\s*\(", binding))
        if n != 1:
            violations.append(Finding(
                NAME, f"{CSRC}/{LAUNCHERS}", line,
                f"host launcher dpf::{launcher} is called {n} times in {BINDING}, not once",
                hint="bind each launcher once, from one binding function; add a new kernel's "
                "launcher to expand.h and its binding to binding.cpp",
            ))
    return violations, {}, {}
