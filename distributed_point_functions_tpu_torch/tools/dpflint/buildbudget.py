"""build-budget checker: the port's counterpart of ``compile-budget``.

The JAX package's ``compile-budget`` caps the distinct interpret-mode
Pallas configurations a test suite compiles, because each one costs tens
of seconds of XLA compile. The port's compile cost sits in its builds: one
``torch.utils.cpp_extension.load`` of ``csrc/`` (most of a minute on the
card's machine, nearly all of it ``binding.cpp``) and the native engine's
g++ build. A second extension, an inline build or a ``torch.compile``
would each add that cost again, at first use in every process, and the
last would also put a compiled plain version where a hand-written kernel
belongs. So:

* every ``cpp_extension.load`` call and every compiler command (a list
  literal that starts with ``g++``, ``gcc``, ``c++``, ``clang++`` or
  ``nvcc``) is a pinned build site; the baseline holds the two that stand
  (``ops/aes_cuda.py``'s load, ``native/__init__.py``'s g++), so a new
  one fails until reviewed;
* ``cpp_extension.load_inline`` and ``torch.compile`` are hard violations.

Scope: the whole package (its tools, experiments and demos build nothing
either).
"""

from __future__ import annotations

import ast
from typing import Dict, List, Tuple

from .core import Finding, Module, Pins, dotted_name, enclosing_qualname

NAME = "build-budget"

COMPILERS = frozenset({"g++", "gcc", "c++", "clang++", "nvcc"})
CPP_EXTENSION = "torch.utils.cpp_extension"


def _imported(mod: Module, module: str) -> Dict[str, str]:
    """Local alias -> name for `from <module> import name [as alias]`."""
    out: Dict[str, str] = {}
    for node in mod.nodes:
        if isinstance(node, ast.ImportFrom) and node.module == module:
            for a in node.names:
                out[a.asname or a.name] = a.name
    return out


def check(modules: List[Module]) -> Tuple[List[Finding], Pins, Dict[str, int]]:
    violations: List[Finding] = []
    pins: Pins = {}
    pin_lines: Dict[str, int] = {}

    def pin(mod: Module, node: ast.AST, what: str) -> None:
        key = f"{mod.rel}::{enclosing_qualname(node)}::{what}"
        pins[key] = pins.get(key, 0) + 1
        pin_lines.setdefault(key, node.lineno)

    for mod in modules:
        if not mod.in_package:
            continue
        ext = _imported(mod, CPP_EXTENSION)
        from_torch = _imported(mod, "torch")
        for node in mod.nodes:
            if isinstance(node, ast.Call):
                d = dotted_name(node.func) or ""
                name = ext.get(d, d.rsplit(".", 1)[-1] if "cpp_extension." in d else None)
                if d == "torch.compile" or from_torch.get(d) == "compile":
                    violations.append(Finding(
                        NAME, mod.rel, node.lineno,
                        f"torch.compile in {enclosing_qualname(node)}",
                        hint="a kernel of the port is written by hand in csrc/; the plain "
                        "versions stay plain PyTorch",
                    ))
                elif name == "load_inline":
                    violations.append(Finding(
                        NAME, mod.rel, node.lineno,
                        f"cpp_extension.load_inline in {enclosing_qualname(node)}",
                        hint="add the kernel to csrc/ and to the one load in ops/aes_cuda.py",
                    ))
                elif name == "load":
                    pin(mod, node, "cpp_extension.load")
            elif isinstance(node, (ast.List, ast.Tuple)) and node.elts:
                first = node.elts[0]
                if isinstance(first, ast.Constant) and first.value in COMPILERS:
                    pin(mod, node, str(first.value))
    return violations, pins, pin_lines
