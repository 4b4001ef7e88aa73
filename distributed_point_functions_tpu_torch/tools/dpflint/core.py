"""dpflint core for the port: module collection, findings, and baseline
semantics.

The same semantics as the JAX package's ``tools/dpflint/core.py``, on the
port's package. Pure stdlib ``ast`` and text scans of ``csrc/``: the lint
costs seconds and never imports torch or jax, so it runs where neither is
installed.

Scope
-----
Most checkers hold the port's *library*: ``distributed_point_functions_tpu_torch/``
without its ``tools/``, ``experiments/``, ``examples/`` and ``_build/``, as
the JAX rules leave out the repo's tools and scripts (which sit outside the
JAX package). ``port-isolation`` and ``build-budget`` hold the whole
package.

Baseline semantics
------------------
Checkers report two kinds of results:

* **violations**: hard failures (a bare ``raise ValueError`` in the
  library, a ``__global__`` with no header body, a jax import). A baseline
  cannot pin them.
* **pins**: watch-list occurrences that are known and deliberate (the
  multihost launcher's environment reads, the stream's ``*_locked``
  helpers, the two build sites). Pins are compared EXACTLY against
  ``baseline.json``:

    - a pin absent from the baseline (or a count above it) is a NEW
      occurrence -> finding;
    - a baseline entry that no longer matches the tree (or a count below
      it) is STALE -> finding, so the baseline tracks the tree.

  ``python -m distributed_point_functions_tpu_torch.tools.dpflint
  --update-baseline`` rewrites the baseline after a reviewed change.
"""

from __future__ import annotations

import ast
import dataclasses
import json
from pathlib import Path
from typing import Dict, Iterable, List, Optional

#: The port's package root, relative to the repo root.
PACKAGE = "distributed_point_functions_tpu_torch"

#: Package subdirectories that are not the library (the JAX rules leave out
#: the repo's tools and scripts, which sit outside the JAX package).
NON_LIBRARY = ("tools", "experiments", "examples", "_build")

#: The kernel sources, relative to the repo root.
CSRC = f"{PACKAGE}/csrc"

#: The chip check whose ``kernels`` list names every kernel source.
CHIP_SMOKE = "chip_smoke.py"

#: The g++ build of the kernel bodies (its harness's #include list).
KERNEL_TEST = "tests/test_torch_kernels.py"


@dataclasses.dataclass(frozen=True)
class Finding:
    """One lint finding: file:line, the checker that fired, what and how
    to fix. `key` carries the pin key for baseline-related findings."""

    checker: str
    path: str  # repo-root-relative posix path
    line: int
    message: str
    hint: str = ""
    key: Optional[str] = None

    def render(self) -> str:
        out = f"{self.path}:{self.line}: [{self.checker}] {self.message}"
        if self.hint:
            out += f"\n    hint: {self.hint}"
        return out


@dataclasses.dataclass
class Module:
    """A parsed source module. `tree` nodes carry `.parent` links and
    functions carry `.qualname` (dotted from module scope); `nodes` lists
    every node of the tree."""

    path: Path
    rel: str
    source: str
    tree: ast.Module
    nodes: List[ast.AST] = dataclasses.field(default_factory=list)

    @property
    def lines(self) -> List[str]:
        return self.source.splitlines()

    @property
    def in_package(self) -> bool:
        return self.rel.startswith(PACKAGE + "/")

    @property
    def in_library(self) -> bool:
        """In the package and outside its tools, scripts and build tree."""
        if not self.in_package:
            return False
        first = self.rel[len(PACKAGE) + 1:].split("/", 1)[0]
        return first not in NON_LIBRARY


def _annotate(tree: ast.Module) -> List[ast.AST]:
    """Adds .parent links to every node and .qualname to every function/
    class def (dotted path of enclosing defs, module scope = ""), in one
    pass; returns every node, so checkers need not walk the tree again."""
    tree.parent = None  # type: ignore[attr-defined]
    nodes: List[ast.AST] = [tree]
    stack = [(tree, "")]
    while stack:
        node, prefix = stack.pop()
        for child in ast.iter_child_nodes(node):
            child.parent = node  # type: ignore[attr-defined]
            nodes.append(child)
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                qual = f"{prefix}.{child.name}" if prefix else child.name
                child.qualname = qual  # type: ignore[attr-defined]
                stack.append((child, qual))
            else:
                stack.append((child, prefix))
    return nodes


def parse_module(path: Path, root: Path) -> Optional[Module]:
    try:
        source = path.read_text()
        tree = ast.parse(source, filename=str(path))
    except (SyntaxError, UnicodeDecodeError, OSError):
        return None
    nodes = _annotate(tree)
    return Module(path=path, rel=path.relative_to(root).as_posix(), source=source, tree=tree,
                  nodes=nodes)


def collect_modules(root: Path, subdirs: Iterable[str] = (PACKAGE,)) -> List[Module]:
    """Parses every .py under the given repo-root subdirs (skipping
    __pycache__ and the package's _build/), then the chip check and the
    kernel test, which the kernel checkers read. Missing paths are skipped
    so fixture roots carry only the tree a test needs."""
    modules: List[Module] = []
    for sub in subdirs:
        base = root / sub
        if not base.is_dir():
            continue
        for path in sorted(base.rglob("*.py")):
            if "__pycache__" in path.parts or "_build" in path.relative_to(base).parts:
                continue
            mod = parse_module(path, root)
            if mod is not None:
                modules.append(mod)
    for rel in (CHIP_SMOKE, KERNEL_TEST):
        if (root / rel).is_file():
            mod = parse_module(root / rel, root)
            if mod is not None:
                modules.append(mod)
    return modules


def module_at(modules: List[Module], rel: str) -> Optional[Module]:
    for mod in modules:
        if mod.rel == rel:
            return mod
    return None


def enclosing_qualname(node: ast.AST) -> str:
    """Dotted qualname of the innermost def/class containing `node`
    ("<module>" at module scope)."""
    p = getattr(node, "parent", None)
    while p is not None:
        if isinstance(p, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            return p.qualname  # type: ignore[attr-defined]
        p = getattr(p, "parent", None)
    return "<module>"


def dotted_name(node: ast.AST) -> Optional[str]:
    """Name/Attribute chain -> "a.b.c"; None for anything else (a method
    call on a computed value, a subscripted callee, ...)."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


# ---------------------------------------------------------------------------
# Baseline
# ---------------------------------------------------------------------------

Pins = Dict[str, int]
Baseline = Dict[str, Pins]


def load_baseline(path: Path) -> Baseline:
    with open(path) as f:
        data = json.load(f)
    return {
        checker: {str(k): int(v) for k, v in pins.items()}
        for checker, pins in data.items()
    }


def save_baseline(path: Path, baseline: Baseline) -> None:
    ordered = {
        checker: dict(sorted(pins.items()))
        for checker, pins in sorted(baseline.items())
    }
    path.write_text(json.dumps(ordered, indent=2) + "\n")


def compare_pins(
    checker: str,
    observed: Pins,
    pinned: Pins,
    lines: Dict[str, int],
    new_hint: str,
) -> List[Finding]:
    """EXACT baseline comparison (see module docstring). `lines` maps pin
    key -> a representative line for the report."""
    findings: List[Finding] = []
    for key, count in sorted(observed.items()):
        allowed = pinned.get(key, 0)
        if count > allowed:
            findings.append(
                Finding(
                    checker=checker,
                    path=key.split("::", 1)[0],
                    line=lines.get(key, 1),
                    message=(
                        f"new occurrence of pinned construct {key!r} "
                        f"(observed {count}, baseline {allowed})"
                    ),
                    hint=new_hint,
                    key=key,
                )
            )
    for key, allowed in sorted(pinned.items()):
        count = observed.get(key, 0)
        if count < allowed:
            findings.append(
                Finding(
                    checker=checker,
                    path=key.split("::", 1)[0],
                    line=1,
                    message=(
                        f"stale baseline entry {key!r} (observed {count}, "
                        f"baseline {allowed}) — the tree moved; update the "
                        "baseline so it stays exact"
                    ),
                    hint="run: python -m distributed_point_functions_tpu_torch.tools.dpflint "
                    "--update-baseline",
                    key=key,
                )
            )
    return findings
