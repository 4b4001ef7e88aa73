"""env-discipline checker (mirrors the JAX package's ``envdiscipline.py``).

``utils/envflags.py`` exists because two hand-rolled parsers of the same
flag drift: a typo'd ``DPF_TPU_PIPELINE=ture`` must raise, not measure the
same path twice in an A/B. The discipline, as in the JAX package:

* every ``DPF_TPU_*`` read goes through a ``utils/envflags`` helper; a
  direct ``os.environ`` touch on a DPF flag is a hard violation;
* every ``DPF_TPU_*`` flag name that appears in the library is named in
  README.md; an undocumented flag is a finding;
* any other ``os.environ`` touch (the multihost launcher's MASTER_ADDR,
  WORLD_SIZE, RANK reads) is a watch-list site pinned in the baseline; a
  new one fails until it is migrated or deliberately pinned.

Differs from the JAX rule in scope only: the port's library, without its
tools, experiments and demos (see ``core.py``). ``utils/envflags.py`` is
the one module allowed to touch ``os.environ``.
"""

from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from .core import PACKAGE, Finding, Module, Pins, dotted_name, enclosing_qualname

NAME = "env-discipline"

_FLAG_RE = re.compile(r"DPF_TPU_[A-Z0-9_]+")

#: The single module allowed to read os.environ directly.
EXEMPT = f"{PACKAGE}/utils/envflags.py"


def _imports_from_os(mod: Module, name: str) -> bool:
    """True when the module does `from os import <name>`."""
    for node in mod.nodes:
        if isinstance(node, ast.ImportFrom) and node.module == "os":
            if any(alias.name == name for alias in node.names):
                return True
    return False


def _literal_str(node: Optional[ast.AST]) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def _flag_for(env_node: ast.AST) -> Optional[str]:
    """The flag name touched at this os.environ site, when statically
    extractable: environ[X], environ.get(X, ...), `X in environ`."""
    parent = getattr(env_node, "parent", None)
    if isinstance(parent, ast.Subscript):
        return _literal_str(parent.slice)
    if isinstance(parent, ast.Attribute) and parent.attr in ("get", "pop", "setdefault"):
        call = getattr(parent, "parent", None)
        if isinstance(call, ast.Call) and call.args:
            return _literal_str(call.args[0])
    if isinstance(parent, ast.Compare):
        return _literal_str(parent.left)
    return None


def _environ_nodes(mod: Module):
    """Yields (node, flag_name_or_None) for each env read: the
    `os.environ` attribute chain, a bare `environ` imported from os, and
    `os.getenv(...)` / a bare imported `getenv(...)`."""
    bare_environ = _imports_from_os(mod, "environ")
    bare_getenv = _imports_from_os(mod, "getenv")
    for node in mod.nodes:
        if (
            isinstance(node, ast.Attribute)
            and node.attr == "environ"
            and isinstance(node.value, ast.Name)
            and node.value.id == "os"
        ):
            yield node, _flag_for(node)
        elif bare_environ and isinstance(node, ast.Name) and node.id == "environ":
            yield node, _flag_for(node)
        elif isinstance(node, ast.Call):
            callee = dotted_name(node.func)
            if callee == "os.getenv" or (callee == "getenv" and bare_getenv):
                yield node, _literal_str(node.args[0]) if node.args else None


def check(
    modules: List[Module], root: Path
) -> Tuple[List[Finding], Pins, Dict[str, int]]:
    violations: List[Finding] = []
    pins: Pins = {}
    pin_lines: Dict[str, int] = {}
    flags_in_tree: Dict[str, Tuple[str, int]] = {}

    for mod in modules:
        if not mod.in_library:
            continue
        for lineno, line in enumerate(mod.lines, 1):
            for m in _FLAG_RE.finditer(line):
                flags_in_tree.setdefault(m.group(0), (mod.rel, lineno))
        if mod.rel == EXEMPT:
            continue
        for node, flag in _environ_nodes(mod):
            qual = enclosing_qualname(node)
            if flag and flag.startswith("DPF_TPU_"):
                violations.append(
                    Finding(
                        NAME, mod.rel, node.lineno,
                        f"direct os.environ read of {flag} in {qual}",
                        hint="go through utils/envflags (env_bool / env_int / "
                        "env_float / env_str / env_opt_bool): one strict "
                        "parser per flag type",
                    )
                )
            else:
                key = f"{mod.rel}::{qual}::environ[{flag or '?'}]"
                pins[key] = pins.get(key, 0) + 1
                pin_lines.setdefault(key, node.lineno)

    readme = root / "README.md"
    readme_text = readme.read_text() if readme.is_file() else ""
    for flag in sorted(flags_in_tree):
        if flag == "DPF_TPU_":  # a prefix mention
            continue
        if flag not in readme_text:
            rel, lineno = flags_in_tree[flag]
            violations.append(
                Finding(
                    NAME, rel, lineno,
                    f"flag {flag} is read by the library but missing from README.md",
                    hint="add it to the README's port section (name, default, what it does)",
                )
            )
    return violations, pins, pin_lines
