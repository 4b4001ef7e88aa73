"""plain-parity checker: the port's counterpart of ``replay-parity``.

The JAX package's ``replay-parity`` holds each megakernel to the eager
replay that shares its core, because the replays were the only coverage
the kernels had without hardware. The port's equivalent is the plain
PyTorch version of each kernel: the wrapper runs it for CPU tensors (which
is how every CPU test reaches the kernel's semantics), and ``chip_smoke.py``
holds the kernel against it on the card. A binding missing any of the
three is a kernel that no test can reach. So every binding that
``csrc/binding.cpp`` exports and that launches a kernel (its C++ function
calls a ``dpf::launch_*`` launcher) has:

* a wrapper in ``ops/aes_cuda.py`` that calls it on ``library()`` and
  adds one to its kernel's launch count in the same function;
* a public wrapper reaching that call whose ``if _on_cpu(...)`` branch
  returns a plain version, a function that ``ops/backend_torch.py`` or
  ``ops/aes_torch.py`` defines;
* an entry in ``chip_smoke.py``'s ``kernels`` list: the ``.cu`` file that
  defines its launcher is named there.

Bindings that launch nothing (the shared-memory and block-count queries)
are exempt. All findings are hard violations.
"""

from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import Dict, List, Optional, Set, Tuple

from . import csource
from .core import CHIP_SMOKE, CSRC, PACKAGE, Finding, Module, Pins, dotted_name, module_at

NAME = "plain-parity"

WRAPPERS = f"{PACKAGE}/ops/aes_cuda.py"
PLAIN_MODULES = {
    "backend_torch": f"{PACKAGE}/ops/backend_torch.py",
    "aes_torch": f"{PACKAGE}/ops/aes_torch.py",
}


class _Fn:
    """What the checker needs of one module-level function of aes_cuda."""

    def __init__(self, fn: ast.FunctionDef):
        self.node = fn
        self.binding_calls: Dict[str, int] = {}
        self.counts = False
        self.plain: List[Tuple[str, str, int]] = []  # (module, function, line)
        self.local_calls: Set[str] = set()
        aliases = {
            t.id
            for node in ast.walk(fn)
            if isinstance(node, ast.Assign) and _is_library_call(node.value)
            for t in node.targets if isinstance(t, ast.Name)
        }
        for node in ast.walk(fn):
            if isinstance(node, ast.Call):
                f = node.func
                if isinstance(f, ast.Attribute) and (
                    _is_library_call(f.value)
                    or (isinstance(f.value, ast.Name) and f.value.id in aliases)
                ):
                    self.binding_calls.setdefault(f.attr, node.lineno)
                elif isinstance(f, ast.Name):
                    self.local_calls.add(f.id)
            elif (
                isinstance(node, ast.AugAssign)
                and isinstance(node.target, ast.Attribute)
                and node.target.attr == "launches"
            ):
                self.counts = True
            elif isinstance(node, ast.If) and _is_on_cpu(node.test):
                for stmt in ast.walk(ast.Module(body=node.body, type_ignores=[])):
                    if isinstance(stmt, ast.Return) and isinstance(stmt.value, ast.Call):
                        d = dotted_name(stmt.value.func) or ""
                        mod, _, name = d.partition(".")
                        if mod in PLAIN_MODULES and name:
                            self.plain.append((mod, name, stmt.lineno))


def _is_library_call(node: Optional[ast.AST]) -> bool:
    return (
        isinstance(node, ast.Call)
        and isinstance(node.func, ast.Name)
        and node.func.id == "library"
    )


def _is_on_cpu(test: ast.AST) -> bool:
    return isinstance(test, ast.Call) and dotted_name(test.func) == "_on_cpu"


def _defined(mod: Optional[Module]) -> Set[str]:
    if mod is None:
        return set()
    return {n.name for n in mod.tree.body if isinstance(n, ast.FunctionDef)}


def _kernel_list_sources(mod: Optional[Module]) -> Set[str]:
    """String constants of the function that builds ``kernels = [...]``,
    from that assignment on: the sources the kernels list names."""
    out: Set[str] = set()
    if mod is None:
        return out
    for fn in ast.walk(mod.tree):
        if not isinstance(fn, ast.FunctionDef):
            continue
        starts = [
            n.lineno for n in ast.walk(fn)
            if isinstance(n, ast.Assign)
            and any(isinstance(t, ast.Name) and t.id == "kernels" for t in n.targets)
        ]
        if not starts:
            continue
        first = min(starts)
        for n in ast.walk(fn):
            if (
                isinstance(n, ast.Constant)
                and isinstance(n.value, str)
                and getattr(n, "lineno", 0) >= first
            ):
                out.add(n.value)
    return out


def check(modules: List[Module], root: Path) -> Tuple[List[Finding], Pins, Dict[str, int]]:
    violations: List[Finding] = []
    csrc = root / CSRC
    binding = csource.read(csrc / "binding.cpp")
    if not binding:
        return violations, {}, {}
    wrappers_mod = module_at(modules, WRAPPERS)
    fns: Dict[str, _Fn] = {}
    if wrappers_mod is not None:
        fns = {n.name: _Fn(n) for n in wrappers_mod.tree.body if isinstance(n, ast.FunctionDef)}
    plain_defs = {k: _defined(module_at(modules, v)) for k, v in PLAIN_MODULES.items()}
    listed = _kernel_list_sources(module_at(modules, CHIP_SMOKE))
    cu_texts = {cu.name: csource.read(cu) for cu in sorted(csrc.glob("*.cu"))}

    def reaches(name: str, targets: Set[str], seen: Set[str]) -> bool:
        if name in targets:
            return True
        if name in seen or name not in fns:
            return False
        seen.add(name)
        return any(reaches(c, targets, seen) for c in fns[name].local_calls)

    bind_rel = f"{CSRC}/binding.cpp"
    for exported, cpp_fn, line in csource.bindings(binding):
        launchers = re.findall(r"\bdpf::(launch_\w+)\s*\(", csource.function_body(binding, cpp_fn))
        if not launchers:
            continue  # a query, not a launch
        where = f"binding {exported!r}"
        sites = sorted(n for n, f in fns.items() if exported in f.binding_calls)
        if not sites:
            violations.append(Finding(
                NAME, bind_rel, line,
                f"{where} has no wrapper in ops/aes_cuda.py (no library().{exported}(...) call)",
                hint="launch it from a wrapper in ops/aes_cuda.py, as the other kernels are",
            ))
            continue
        for s in sites:
            if not fns[s].counts:
                violations.append(Finding(
                    NAME, WRAPPERS, fns[s].binding_calls[exported],
                    f"{s} launches {where} but adds nothing to a kernel's launch count",
                    hint="add one to the kernel's count (K.launches += 1) where it launches",
                ))
        public = [n for n, f in fns.items() if f.plain and reaches(n, set(sites), set())]
        if not public:
            violations.append(Finding(
                NAME, WRAPPERS, fns[sites[0]].binding_calls[exported],
                f"no wrapper reaching {where} runs a plain version for CPU tensors",
                hint="branch on _on_cpu(...) and return the backend_torch / aes_torch version",
            ))
        for n in public:
            for mod, plain, pline in fns[n].plain:
                if plain not in plain_defs[mod]:
                    violations.append(Finding(
                        NAME, WRAPPERS, pline,
                        f"{n}'s plain version {mod}.{plain} is not defined in "
                        f"{PLAIN_MODULES[mod]}",
                    ))
        sources = sorted(cu for cu, text in cu_texts.items()
                         if any(csource.definitions(text, lc) for lc in launchers))
        for cu in sources:
            if not any(s == cu or s.endswith("/" + cu) for s in listed):
                violations.append(Finding(
                    NAME, bind_rel, line,
                    f"{where}'s kernel source csrc/{cu} has no entry in {CHIP_SMOKE}'s "
                    "kernels list",
                    hint="hold the kernel against its plain version in chip_smoke.py and "
                    "add its row to the kernels list",
                ))
    return violations, {}, {}
