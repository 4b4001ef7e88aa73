"""Text scans of the kernel sources (``csrc/``), for the kernel checkers.

No C++ parser: the sources keep to a few shapes (``__global__`` kernels
whose bodies call ``dpf::`` device functions, host launchers declared in
``expand.h`` and defined in the ``.cu`` files, ``m.def`` bindings in
``binding.cpp``), and these regular expressions read those shapes on
comment-stripped text with its line numbers kept.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Set, Tuple

_COMMENT = re.compile(r"//[^\n]*|/\*.*?\*/", re.S)
_INCLUDE = re.compile(r'^\s*#\s*include\s*([<"])([^>"]+)[>"]', re.M)
_GLOBAL = re.compile(
    r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?([A-Za-z_]\w*)\s*\("
)
_DEVICE_DEF = re.compile(r"__device__[^;{}()]*?\b([A-Za-z_]\w*)\s*\(")
_CALL = re.compile(r"\b([A-Za-z_]\w*)\s*(?:<[^<>;{}()]*>)?\s*\(")
_NOT_CALLS = frozenset({
    "if", "for", "while", "switch", "return", "sizeof", "alignof", "decltype",
    "static_cast", "reinterpret_cast", "const_cast", "__launch_bounds__",
})


def strip_comments(text: str) -> str:
    """Comments blanked out, newlines kept (so offsets map to lines)."""
    return _COMMENT.sub(lambda m: re.sub(r"[^\n]", " ", m.group(0)), text)


def line_of(text: str, offset: int) -> int:
    return text.count("\n", 0, offset) + 1


def read(path: Path) -> str:
    return strip_comments(path.read_text()) if path.is_file() else ""


def includes(text: str) -> List[Tuple[str, str, int]]:
    """(delimiter, header, line) for each #include."""
    return [(m.group(1), m.group(2), line_of(text, m.start())) for m in _INCLUDE.finditer(text)]


def include_closure(csrc: Path, roots: Set[str]) -> Set[str]:
    """The quoted headers under `csrc` reachable from `roots` (names),
    roots included; headers that are not in `csrc` (generated tables, the
    toolkit's) are skipped."""
    seen: Set[str] = set()
    todo = [r for r in roots if (csrc / r).is_file()]
    while todo:
        name = todo.pop()
        if name in seen:
            continue
        seen.add(name)
        for delim, header, _ in includes(read(csrc / name)):
            if delim == '"' and (csrc / header).is_file() and header not in seen:
                todo.append(header)
    return seen


def _matching(text: str, start: int, open_ch: str, close_ch: str) -> int:
    """Offset just past the bracket that closes the one at `start`."""
    depth = 0
    for i in range(start, len(text)):
        c = text[i]
        if c == open_ch:
            depth += 1
        elif c == close_ch:
            depth -= 1
            if depth == 0:
                return i + 1
    return len(text)


def body_after(text: str, paren: int) -> Optional[Tuple[int, int]]:
    """The (start, end) of the `{...}` body of the function whose parameter
    list opens at `paren`; None for a declaration (`;` first)."""
    close = _matching(text, paren, "(", ")")
    for i in range(close, len(text)):
        if text[i] == "{":
            return i, _matching(text, i, "{", "}")
        if text[i] == ";":
            return None
    return None


def global_kernels(text: str) -> Iterator[Tuple[str, int, str]]:
    """(name, line, body) for each ``__global__`` kernel."""
    for m in _GLOBAL.finditer(text):
        span = body_after(text, m.end() - 1)
        if span is not None:
            yield m.group(1), line_of(text, m.start()), text[span[0]:span[1]]


def device_functions(text: str) -> Dict[str, str]:
    """name -> body of each ``__device__`` function defined in `text` (the
    last definition of an overloaded name wins; any one will do)."""
    out: Dict[str, str] = {}
    for m in _DEVICE_DEF.finditer(text):
        span = body_after(text, m.end() - 1)
        if span is not None:
            out[m.group(1)] = text[span[0]:span[1]]
    return out


def calls(body: str) -> Set[str]:
    """Names called in a body (qualifiers dropped, templates skipped)."""
    return {m.group(1) for m in _CALL.finditer(body)} - _NOT_CALLS


def declarations(text: str) -> List[Tuple[str, int]]:
    """(name, line) of each function declared (not defined) in a header."""
    out = []
    for m in re.finditer(r"\b([A-Za-z_]\w*)\s*\(", text):
        if m.group(1) in _NOT_CALLS:
            continue
        if body_after(text, m.end() - 1) is None:
            close = _matching(text, m.end() - 1, "(", ")")
            if text[close:].lstrip().startswith(";") and re.search(
                r"[\w*&>]\s+$", text[max(0, m.start() - 40):m.start()]
            ):
                out.append((m.group(1), line_of(text, m.start())))
    return out


def definitions(text: str, name: str) -> bool:
    """True when `text` defines the function `name` (a body follows)."""
    for m in re.finditer(rf"\b{re.escape(name)}\s*\(", text):
        if body_after(text, m.end() - 1) is not None and re.search(
            r"[\w*&>]\s+$", text[max(0, m.start() - 40):m.start()]
        ):
            return True
    return False


def bindings(text: str) -> List[Tuple[str, str, int]]:
    """(exported name, C++ function, line) of each ``m.def`` in a binding."""
    return [
        (m.group(1), m.group(2), line_of(text, m.start()))
        for m in re.finditer(r'\bm\.def\(\s*"(\w+)"\s*,\s*&\s*(\w+)', text)
    ]


def function_body(text: str, name: str) -> str:
    """The body of the (host) function `name` defined in `text`, or ""."""
    for m in re.finditer(rf"\b{re.escape(name)}\s*\(", text):
        span = body_after(text, m.end() - 1)
        if span is not None and re.search(r"[\w*&>]\s+$", text[max(0, m.start() - 40):m.start()]):
            return text[span[0]:span[1]]
    return ""
