"""port-isolation checker: the port stands alone and never falls back.

No JAX checker mirrors this; it is the static twin of
``tests/test_torch_imports.py``'s subprocess guard, which imports the
port's entry points in a fresh process and fails if ``jax`` or the JAX
package got loaded. The guard sees only the modules its script reaches;
this sees every file. Two rules, both hard violations:

* **isolation**: no module of the package (its tools, experiments and
  demos included) imports ``jax``, ``jaxlib`` or
  ``distributed_point_functions_tpu``, by an import statement or by
  ``importlib.import_module`` / ``__import__`` with a literal name. The
  port keeps its own copy of anything it needs from the JAX package.
* **no fallback**: no ``try`` in ``ops/aes_cuda.py`` catches an error and
  then runs a plain version (``backend_torch`` / ``aes_torch``) or moves
  to the CPU, and no handler swallows an error of a ``library()`` build or
  launch without raising. A wrapper given CUDA tensors launches its kernel
  or raises; the plain versions run for CPU tensors only.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Tuple

from .core import PACKAGE, Finding, Module, Pins, dotted_name, enclosing_qualname

NAME = "port-isolation"

FORBIDDEN = ("jax", "jaxlib", "distributed_point_functions_tpu")
WRAPPERS = f"{PACKAGE}/ops/aes_cuda.py"
PLAIN = ("backend_torch.", "aes_torch.")


def _forbidden(name: Optional[str]) -> Optional[str]:
    if not name:
        return None
    for f in FORBIDDEN:
        if name == f or name.startswith(f + "."):
            return name
    return None


def _imports(mod: Module):
    """(node, module name) for each absolute import and each literal
    dynamic import."""
    for node in mod.nodes:
        if isinstance(node, ast.Import):
            for a in node.names:
                yield node, a.name
        elif isinstance(node, ast.ImportFrom) and not node.level and node.module:
            yield node, node.module
        elif isinstance(node, ast.Call) and dotted_name(node.func) in (
            "importlib.import_module", "import_module", "__import__",
        ):
            arg = node.args[0] if node.args else None
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                yield node, arg.value


def _moves_to_cpu(node: ast.AST) -> bool:
    for n in ast.walk(node):
        if not isinstance(n, ast.Call):
            continue
        d = dotted_name(n.func) or ""
        if d.startswith(PLAIN):
            return True
        if isinstance(n.func, ast.Attribute) and n.func.attr == "cpu":
            return True
        if (isinstance(n.func, ast.Attribute) and n.func.attr == "to") or d == "torch.device":
            if any(isinstance(a, ast.Constant) and a.value == "cpu" for a in n.args):
                return True
    return False


def _calls_library(node: ast.AST) -> bool:
    return any(
        isinstance(n, ast.Call) and isinstance(n.func, ast.Name) and n.func.id == "library"
        for n in ast.walk(node)
    )


def check(modules: List[Module]) -> Tuple[List[Finding], Pins, Dict[str, int]]:
    violations: List[Finding] = []
    for mod in modules:
        if not mod.in_package:
            continue
        for node, name in _imports(mod):
            if _forbidden(name):
                violations.append(Finding(
                    NAME, mod.rel, node.lineno,
                    f"import of {name} in {enclosing_qualname(node)}",
                    hint="the port imports neither jax nor the JAX package; keep a copy of "
                    "what it needs in the port (only the tests import both)",
                ))
        if mod.rel != WRAPPERS:
            continue
        for node in mod.nodes:
            if not isinstance(node, ast.Try):
                continue
            body = ast.Module(body=node.body, type_ignores=[])
            for handler in node.handlers:
                h = ast.Module(body=handler.body, type_ignores=[])
                raises = any(isinstance(n, ast.Raise) for n in ast.walk(h))
                if _moves_to_cpu(h) or (_calls_library(body) and not raises):
                    violations.append(Finding(
                        NAME, mod.rel, handler.lineno,
                        f"{enclosing_qualname(node)} catches a build or launch error and "
                        "goes on without the kernel",
                        hint="on CUDA tensors a wrapper launches its kernel or raises; the "
                        "degradation chains (ops/degrade.py) choose the next rung, not the "
                        "wrapper",
                    ))
    return violations, {}, {}
