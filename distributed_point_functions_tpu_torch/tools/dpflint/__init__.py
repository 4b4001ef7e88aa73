"""dpflint for the port: AST-enforced invariants of
``distributed_point_functions_tpu_torch``.

The JAX package's ``tools/dpflint`` encodes that package's disciplines as
AST checks; this package does the same for the port, with the JAX
checkers' semantics where a discipline carries over and a counterpart
where it was about Pallas or XLA:

  error-taxonomy  no bare RuntimeError/ValueError in the library (JAX's)
  env-discipline  DPF_TPU_* reads go through utils/envflags; every flag
                  named in README; other os.environ touches pinned (JAX's)
  lock-discipline shared mutable state in the threaded modules mutated
                  only under the owning lock (JAX's, the port's modules)
  kernel-surface  every __global__ calls a header body the g++ test
                  builds; PyTorch headers in binding.cpp alone; each
                  launcher bound once (for mosaic-opset)
  plain-parity    every launching binding has a counted wrapper, a plain
                  version for CPU tensors and a chip_smoke.py row (for
                  replay-parity)
  build-budget    one cpp_extension.load and one g++ build, pinned; no
                  load_inline, no torch.compile (for compile-budget)
  port-isolation  no jax / JAX-package import anywhere in the package; no
                  wrapper falls back to a plain version or the CPU

Run: ``python -m distributed_point_functions_tpu_torch.tools.dpflint``
(pure stdlib: imports neither torch nor jax).
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Optional, Tuple

from . import (
    buildbudget, envdiscipline, isolation, kernelsurface, lockdiscipline, plainparity,
    taxonomy,
)
from .core import Baseline, Finding, Module, collect_modules, compare_pins

DEFAULT_BASELINE = Path(__file__).resolve().parent / "baseline.json"

#: checker name -> (runner, new-occurrence hint)
_CHECKERS = {
    taxonomy.NAME: (lambda mods, root: taxonomy.check(mods), ""),
    envdiscipline.NAME: (
        lambda mods, root: envdiscipline.check(mods, root),
        "non-DPF os.environ touches are pinned; migrate to utils/envflags or pin "
        "deliberately",
    ),
    lockdiscipline.NAME: (
        lambda mods, root: lockdiscipline.check(mods),
        "mutate shared state under the owning lock's `with` block (the JAX "
        "package's integrity._hooks race class)",
    ),
    kernelsurface.NAME: (lambda mods, root: kernelsurface.check(mods, root), ""),
    plainparity.NAME: (lambda mods, root: plainparity.check(mods, root), ""),
    buildbudget.NAME: (
        lambda mods, root: buildbudget.check(mods),
        "each build site costs its build at first use in every process; add the "
        "kernel to csrc/ and the one load in ops/aes_cuda.py instead",
    ),
    isolation.NAME: (lambda mods, root: isolation.check(mods), ""),
}

CHECKER_NAMES = tuple(_CHECKERS)


def run(
    root: Path,
    baseline: Optional[Baseline] = None,
    checkers: Optional[Tuple[str, ...]] = None,
    modules: Optional[List[Module]] = None,
) -> Tuple[List[Finding], Baseline]:
    """Runs the checkers over `root`. Returns (findings, observed pins).
    `baseline=None` compares against empty pins (every pin is new)."""
    baseline = baseline or {}
    if modules is None:
        modules = collect_modules(root)
    findings: List[Finding] = []
    observed: Baseline = {}
    for name in checkers or CHECKER_NAMES:
        runner, hint = _CHECKERS[name]
        violations, pins, pin_lines = runner(modules, root)
        findings.extend(violations)
        observed[name] = pins
        findings.extend(compare_pins(name, pins, baseline.get(name, {}), pin_lines, hint))
    findings.sort(key=lambda f: (f.path, f.line, f.checker))
    return findings, observed
