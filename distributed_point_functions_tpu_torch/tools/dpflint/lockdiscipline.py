"""lock-discipline checker (mirrors the JAX package's ``lockdiscipline.py``).

The class of a bug the JAX package had: ``utils/integrity._hooks`` was
an unlocked module-level list mutated on the caller thread while the
pipelined executor's finalize worker iterated it. The port's threaded
modules (telemetry bus, pipelined executor, serving batcher, server,
fleet, streams, leases, autoscaler, and the port's own thread and lock
owners below) share state across threads; shared mutable state is mutated
only while holding the owning lock's ``with`` block.

Heuristics, the JAX checker's unchanged (self-calibrating, no
annotations):

* **module scope**: a module-level name bound to a mutable container, or
  rebound via ``global`` in any function, is shared state when the module
  also owns module-level locks. Every mutation site in a function must sit
  lexically inside ``with <lock>:``.
* **class scope**: for classes that create ``self._lock``-style
  threading.Lock/RLock/Condition attrs: an instance attr is *lock-owned*
  when at least one of its mutation sites (outside ``__init__``) is inside
  ``with self.<lock>:``. Every other mutation site of a lock-owned attr
  (outside ``__init__``) must then also hold a lock.

Unguarded sites are watch-list pins, not hard violations: the stream's
``*_locked`` helpers run with the caller's lock held, which a lexical scan
cannot see. A NEW unguarded mutation fails until reviewed.

Differs from the JAX rule in its module list only: the JAX package's
eight threaded modules under the port's package, plus the port's modules
that start threads or own a lock the JAX list has no twin for
(``serving/client.py``, ``serving/router.py``, ``utils/deadline.py``,
``ops/keygen_batch.py``, ``ops/aes_cuda.py``, ``native/__init__.py``).
``serving/frontdoor.py`` and ``ops/degrade.py`` start no thread and own no
lock.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from .core import PACKAGE, Finding, Module, Pins, dotted_name

NAME = "lock-discipline"

THREADED_MODULES = (
    f"{PACKAGE}/utils/telemetry.py",
    f"{PACKAGE}/ops/pipeline.py",
    f"{PACKAGE}/serving/batcher.py",
    f"{PACKAGE}/serving/server.py",
    f"{PACKAGE}/serving/fleet.py",
    f"{PACKAGE}/serving/streaming.py",
    f"{PACKAGE}/serving/lease.py",
    f"{PACKAGE}/serving/autoscale.py",
    # The port's own thread starters and lock owners.
    f"{PACKAGE}/serving/client.py",
    f"{PACKAGE}/serving/router.py",
    f"{PACKAGE}/utils/deadline.py",
    f"{PACKAGE}/ops/keygen_batch.py",
    f"{PACKAGE}/ops/aes_cuda.py",
    f"{PACKAGE}/native/__init__.py",
)

_LOCK_CTORS = {
    "threading.Lock",
    "threading.RLock",
    "threading.Condition",
}

#: Container methods that mutate in place.
_MUTATORS = {
    "append", "extend", "insert", "remove", "pop", "popleft", "clear",
    "add", "discard", "update", "setdefault", "popitem", "appendleft",
    "sort", "reverse",
}


def _is_lock_ctor(node: ast.AST) -> bool:
    return isinstance(node, ast.Call) and dotted_name(node.func) in _LOCK_CTORS


def _is_container_literal(node: ast.AST) -> bool:
    if isinstance(node, (ast.List, ast.Dict, ast.Set, ast.ListComp, ast.DictComp, ast.SetComp)):
        return True
    if isinstance(node, ast.Call):
        return dotted_name(node.func) in (
            "list", "dict", "set", "collections.deque", "deque",
            "collections.defaultdict", "defaultdict", "collections.OrderedDict",
            "OrderedDict",
        )
    return False


def _with_locks(node: ast.AST) -> Set[str]:
    """Names of locks held at `node`'s lexical position: each enclosing
    With item that is a plain Name (`with _lock:`) or `self.<attr>`
    (`with self._lock:`) contributes "name" / "self.attr"."""
    held: Set[str] = set()
    p = getattr(node, "parent", None)
    while p is not None:
        if isinstance(p, ast.With):
            for item in p.items:
                d = dotted_name(item.context_expr)
                if d:
                    held.add(d)
        p = getattr(p, "parent", None)
    return held


def _enclosing_function(node: ast.AST) -> Optional[ast.FunctionDef]:
    p = getattr(node, "parent", None)
    while p is not None:
        if isinstance(p, ast.FunctionDef):
            return p
        p = getattr(p, "parent", None)
    return None


def _in_init(node: ast.AST) -> bool:
    """True when the OUTERMOST enclosing function is __init__ (closures
    defined inside __init__ still count as init-time)."""
    outer = None
    p = getattr(node, "parent", None)
    while p is not None:
        if isinstance(p, ast.FunctionDef):
            outer = p
        p = getattr(p, "parent", None)
    return outer is not None and outer.name == "__init__"


def _module_state(mod: Module) -> Tuple[Set[str], Set[str]]:
    """(module-level lock names, module-level shared mutable names)."""
    locks: Set[str] = set()
    shared: Set[str] = set()
    for node in mod.tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and isinstance(
            node.targets[0], ast.Name
        ):
            name = node.targets[0].id
            if _is_lock_ctor(node.value):
                locks.add(name)
            elif _is_container_literal(node.value):
                shared.add(name)
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Global):
            shared.update(node.names)
    shared -= locks
    return locks, shared


def _mutation_sites(root: ast.AST):
    """Yields (node, target_kind, target_name) mutation sites:
    kind 'name'/'name-sub' -> module-scope name, 'self'/'self-sub' ->
    instance attr name."""
    for node in ast.walk(root):
        if isinstance(node, (ast.Assign, ast.AugAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            for t in targets:
                # plain rebind of a module global (only meaningful inside
                # a function that declared it global — filtered by caller)
                if isinstance(t, ast.Name):
                    yield node, "name", t.id
                # self.attr = ... / self.attr += ...
                elif isinstance(t, ast.Attribute) and isinstance(t.value, ast.Name) and t.value.id == "self":
                    yield node, "self", t.attr
                # container[key] = ... on a global or self attr
                elif isinstance(t, ast.Subscript):
                    base = t.value
                    if isinstance(base, ast.Name):
                        yield node, "name-sub", base.id
                    elif isinstance(base, ast.Attribute) and isinstance(base.value, ast.Name) and base.value.id == "self":
                        yield node, "self-sub", base.attr
        elif isinstance(node, ast.Delete):
            for t in node.targets:
                if isinstance(t, ast.Subscript):
                    base = t.value
                    if isinstance(base, ast.Name):
                        yield node, "name-sub", base.id
                    elif isinstance(base, ast.Attribute) and isinstance(base.value, ast.Name) and base.value.id == "self":
                        yield node, "self-sub", base.attr
        elif isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
            if node.func.attr in _MUTATORS:
                base = node.func.value
                if isinstance(base, ast.Name):
                    yield node, "name-sub", base.id
                elif isinstance(base, ast.Attribute) and isinstance(base.value, ast.Name) and base.value.id == "self":
                    yield node, "self-sub", base.attr


def _declared_global(node: ast.AST, name: str) -> bool:
    fn = _enclosing_function(node)
    while fn is not None:
        for stmt in ast.walk(fn):
            if isinstance(stmt, ast.Global) and name in stmt.names:
                return True
        fn = _enclosing_function(fn)
    return False


def _locally_bound(node: ast.AST, name: str) -> bool:
    """True when `name` is a parameter or a plain local assignment target
    of an enclosing function (without a `global` decl) — the mutation
    then targets a local, not the module global of the same name."""
    if _declared_global(node, name):
        return False
    fn = _enclosing_function(node)
    while fn is not None:
        a = fn.args
        params = {x.arg for x in a.args + a.posonlyargs + a.kwonlyargs}
        if a.vararg:
            params.add(a.vararg.arg)
        if a.kwarg:
            params.add(a.kwarg.arg)
        if name in params:
            return True
        for stmt in ast.walk(fn):
            if isinstance(stmt, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                targets = (
                    stmt.targets if isinstance(stmt, ast.Assign) else [stmt.target]
                )
                for t in targets:
                    if isinstance(t, ast.Name) and t.id == name:
                        return True
            elif isinstance(stmt, (ast.For, ast.comprehension)):
                for leaf in ast.walk(stmt.target):
                    if isinstance(leaf, ast.Name) and leaf.id == name:
                        return True
            elif isinstance(stmt, ast.With):
                for item in stmt.items:
                    ov = item.optional_vars
                    if ov is not None and isinstance(ov, ast.Name) and ov.id == name:
                        return True
        fn = _enclosing_function(fn)
    return False


def check(modules: List[Module]) -> Tuple[List[Finding], Pins, Dict[str, int]]:
    violations: List[Finding] = []
    pins: Pins = {}
    pin_lines: Dict[str, int] = {}

    def pin(mod: Module, qual: str, what: str, line: int) -> None:
        key = f"{mod.rel}::{qual}::{what}"
        pins[key] = pins.get(key, 0) + 1
        pin_lines.setdefault(key, line)

    for mod in modules:
        if mod.rel not in THREADED_MODULES:
            continue
        mod_locks, mod_shared = _module_state(mod)

        # --- class-level pass: find lock attrs and lock-owned attrs ----
        class_locks: Dict[str, Set[str]] = {}
        for cls in ast.walk(mod.tree):
            if not isinstance(cls, ast.ClassDef):
                continue
            attrs: Set[str] = set()
            for node in ast.walk(cls):
                if (
                    isinstance(node, ast.Assign)
                    and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Attribute)
                    and isinstance(node.targets[0].value, ast.Name)
                    and node.targets[0].value.id == "self"
                    and _is_lock_ctor(node.value)
                ):
                    attrs.add(node.targets[0].attr)
            if attrs:
                class_locks[cls.name] = attrs

        # Collect per-class mutation sites to derive lock-owned attrs.
        per_class_sites: Dict[str, List[Tuple[ast.AST, str, bool]]] = {}
        for cls in ast.walk(mod.tree):
            if not isinstance(cls, ast.ClassDef) or cls.name not in class_locks:
                continue
            lock_attrs = class_locks[cls.name]
            sites: List[Tuple[ast.AST, str, bool]] = []
            for node, kind, name in _mutation_sites(cls):
                if kind not in ("self", "self-sub"):
                    continue
                if name in lock_attrs:
                    continue
                held = _with_locks(node)
                locked = any(f"self.{la}" in held for la in lock_attrs)
                sites.append((node, name, locked))
            per_class_sites[cls.name] = sites

        for cls_name, sites in per_class_sites.items():
            owned = {name for _, name, locked in sites if locked}
            for node, name, locked in sites:
                if name not in owned or locked or _in_init(node):
                    continue
                fn = _enclosing_function(node)
                qual = fn.qualname if fn is not None else cls_name  # type: ignore[attr-defined]
                pin(mod, qual, f"unlocked:self.{name}", node.lineno)

        # --- module-level pass ----------------------------------------
        if mod_locks:
            for node, kind, name in _mutation_sites(mod.tree):
                if kind in ("self", "self-sub"):
                    continue
                if name not in mod_shared:
                    continue
                fn = _enclosing_function(node)
                if fn is None:
                    continue  # module top-level init runs pre-threading
                if kind == "name" and not _declared_global(node, name):
                    continue  # local shadowing, not the module global
                if kind == "name-sub" and _locally_bound(node, name):
                    continue  # mutation of a same-named local
                held = _with_locks(node)
                if held & mod_locks:
                    continue
                qual = fn.qualname  # type: ignore[attr-defined]
                pin(mod, qual, f"unlocked:{name}", node.lineno)

    return violations, pins, pin_lines
