"""error-taxonomy checker (mirrors the JAX package's ``taxonomy.py``).

The port mirrors the reference's absl::Status categories as exception
classes (``utils/errors.py``, class for class the JAX package's), so its
callers (the degradation chains, the wire protocol's status codes, the
tests) can dispatch on failure *category*. A bare ``raise RuntimeError`` /
``raise ValueError`` opts out of that contract: the supervisor cannot
classify it, the wire maps it to UNKNOWN, and ``except DpfError`` handlers
miss it. The JAX package holds its library at zero such raises; so does
this.

Differs from the JAX rule in scope only: the port's tools, experiments and
demos live inside its package, so they are left out by path, as the JAX
rule leaves out the repo's ``tools/`` by being scoped to its package.
``utils/errors.py`` itself is exempt (it *defines* the taxonomy).
"""

from __future__ import annotations

import ast
from typing import Dict, List, Tuple

from .core import PACKAGE, Finding, Module, Pins, enclosing_qualname

NAME = "error-taxonomy"

BARE = {"RuntimeError", "ValueError"}

EXEMPT = f"{PACKAGE}/utils/errors.py"

_HINTS = {
    "ValueError": "InvalidArgumentError (caller handed bad input) — it "
    "subclasses ValueError, so `except ValueError` callers keep working",
    "RuntimeError": "FailedPreconditionError / InternalError / "
    "UnavailableError by category — all subclass RuntimeError",
}


def check(modules: List[Module]) -> Tuple[List[Finding], Pins, Dict[str, int]]:
    violations: List[Finding] = []
    for mod in modules:
        if not mod.in_library or mod.rel == EXEMPT:
            continue
        for node in mod.nodes:
            if not isinstance(node, ast.Raise) or node.exc is None:
                continue
            exc = node.exc
            name = None
            if isinstance(exc, ast.Call) and isinstance(exc.func, ast.Name):
                name = exc.func.id
            elif isinstance(exc, ast.Name):
                name = exc.id
            if name in BARE:
                violations.append(
                    Finding(
                        NAME, mod.rel, node.lineno,
                        f"bare `raise {name}` in {enclosing_qualname(node)} "
                        "bypasses the utils/errors.py absl taxonomy",
                        hint=f"use {_HINTS[name]}",
                    )
                )
    return violations, {}, {}
