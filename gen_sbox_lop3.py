#!/usr/bin/env python3
"""Writes csrc/aes_sbox.cuh: the AES S-box as a netlist of three-input
functions, one LOP3 instruction each on the card.

Run from the root of the repository, on any machine with numpy and scipy
(no GPU, no JAX; about two minutes on one CPU core):

    python3 gen_sbox_lop3.py [--check]

The netlist starts from the Boyar-Peralta S-box the plain version computes
(ops/aes_torch.py ``_bp_sbox``: 32 AND and 83 XOR/XNOR two-input gates,
traced here). Every signal of it is a Boolean function of the byte's eight
bits. A three-input function of signals a, b, c can compute signal n when n
is determined by (a, b, c) on all 256 inputs; this script lists, for every
signal, each such leaf set among the signals computed before it (one, two
or three leaves), and then chooses with an integer program (scipy's HiGHS)
the fewest signals to compute, each from one of its leaf sets whose leaves
are computed too, so that the eight outputs are. A leaf set may skip
signals that only it used (they fold into the function) or take a signal
the Boyar-Peralta order computes some other way; the order of the signals
keeps the result acyclic. The chosen netlist is checked against the AES
S-box on all 256 bytes before the header is written; ``--check`` compares
the checked-in header with a fresh one and writes nothing.

ptxas maps each ``lop3<LUT>`` of the header onto one LOP3: the helper is
inline PTX ``lop3.b32`` on the card (csrc/lop3.cuh). A LUT is the 8-bit
truth table F(0xF0, 0xCC, 0xAA) of the function of (a, b, c), as PTX
defines it.
"""

from __future__ import annotations

import argparse
import itertools
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
HEADER = ROOT / "distributed_point_functions_tpu_torch" / "csrc" / "aes_sbox.cuh"


class Sig:
    """A signal of the traced netlist: its truth table over the 256 byte
    values (a bool array), its index in the netlist, and whether it is an
    inverter (not counted as a two-input gate)."""

    inverter = False

    def __init__(self, net, table):
        self.net, self.table = net, table
        self.index = len(net)
        net.append(self)

    def __xor__(self, other):
        return Sig(self.net, self.table ^ other.table)

    def __and__(self, other):
        return Sig(self.net, self.table & other.table)

    def __invert__(self):
        out = Sig(self.net, ~self.table)
        out.inverter = True
        return out


def traced_sbox():
    """(signals, output indices s0..s7, u0 = MSB) of aes_torch._bp_sbox."""
    sys.path.insert(0, str(ROOT))
    from distributed_point_functions_tpu_torch.ops.aes_torch import _bp_sbox

    x = np.arange(256)
    net = []
    u = [Sig(net, ((x >> (7 - i)) & 1).astype(bool)) for i in range(8)]
    s = _bp_sbox(*u)
    return net, [o.index for o in s]


def pack(table: np.ndarray) -> np.ndarray:
    """A 256-entry truth table as 4 uint64 words."""
    return np.packbits(table).view(np.uint64)


def leaf_sets(tables: np.ndarray, n: int):
    """Every leaf set (of 1-3 signals before n) that determines signal n,
    without supersets of a smaller one."""
    f = tables[n]
    nf = ~f
    found = []
    for size in (1, 2, 3):
        combos = np.array(list(itertools.combinations(range(n), size)), dtype=np.int64)
        if not len(combos):
            break
        ok = np.ones(len(combos), bool)
        leaves = [tables[combos[:, j]] for j in range(size)]
        for bits in itertools.product((0, 1), repeat=size):
            m = np.full((len(combos), 4), ~np.uint64(0))
            for leaf, b in zip(leaves, bits):
                m &= leaf if b else ~leaf
            ok &= ~((m & f).any(1) & (m & nf).any(1))
        for c in combos[ok]:
            c = frozenset(int(v) for v in c)
            if not any(s < c for s in found):
                found.append(c)
    return found


def choose(net, outputs, cuts):
    """The fewest signals to compute (integer program), and each one's leaf
    set: {signal: leaves}."""
    from scipy.optimize import Bounds, LinearConstraint, milp
    from scipy.sparse import lil_matrix

    n_sig = len(net)
    var = [(n, c) for n in cuts for c in cuts[n]]
    nx = len(var)
    rows = n_sig + sum(len(c) for _, c in var)
    a = lil_matrix((rows, nx + n_sig))
    lo, hi = [], []
    r = 0
    by_signal = {}
    for i, (n, _) in enumerate(var):
        by_signal.setdefault(n, []).append(i)
    for s in range(n_sig):  # computed == one leaf set chosen (inputs: free)
        a[r, nx + s] = -1
        for i in by_signal.get(s, []):
            a[r, i] = 1
        lo.append(0 if s >= 8 else -np.inf)
        hi.append(0 if s >= 8 else np.inf)
        r += 1
    for i, (_, c) in enumerate(var):  # a chosen leaf set's leaves are computed
        for leaf in c:
            a[r, i] = 1
            a[r, nx + leaf] = -1
            lo.append(-np.inf)
            hi.append(0)
            r += 1
    lb = np.zeros(nx + n_sig)
    lb[nx + np.array(outputs)] = 1
    lb[nx : nx + 8] = 1
    cost = np.concatenate([np.zeros(nx), np.zeros(8), np.ones(n_sig - 8)])
    res = milp(cost, constraints=LinearConstraint(a.tocsr(), lo, hi),
               integrality=np.ones(nx + n_sig), bounds=Bounds(lb, np.ones(nx + n_sig)))
    if res.status != 0:
        raise RuntimeError(f"the integer program failed: {res.message}")
    x = np.round(res.x).astype(int)
    return {n: sorted(c) for i, (n, c) in enumerate(var) if x[i]}


def lut(tables, n, leaves, exprs):
    """(immLut, C expression) of signal n as a function of `leaves` (padded
    to three by repeating the last): bit 4a + 2b + c of immLut is f(a, b,
    c). A combination that no byte reaches is free; it is filled so that
    the expression is the shortest."""
    leaves = list(leaves) + [leaves[-1]] * (3 - len(leaves))
    care = value = 0
    for m in range(8):
        sel = np.ones(256, bool)
        for j, bit in enumerate(((m >> 2) & 1, (m >> 1) & 1, m & 1)):
            sel &= tables[leaves[j]] == bool(bit)
        if sel.any():
            vals = tables[n][sel]
            assert vals.all() or not vals.any()
            care |= 1 << m
            value |= int(vals[0]) << m
    free = [m for m in range(8) if not (care >> m) & 1]
    fills = []
    for bits in itertools.product((0, 1), repeat=len(free)):
        code = value | sum(b << m for b, m in zip(bits, free))
        expr = exprs.get(code)
        if expr is not None:
            fills.append((len(expr), code, expr))
    _, code, expr = min(fills)
    return code, expr


def expressions():
    """The shortest C expression of each 3-input truth table reachable
    with XOR, AND, OR and NOT in at most three binary operations, over the
    arguments a, b, c."""
    best = {}

    def add(expr, t):
        t &= 0xFF
        if t not in best or len(expr) < len(best[t]):
            best[t] = expr

    for k, v in (("a", 0xF0), ("b", 0xCC), ("c", 0xAA)):
        add(k, v)
        add(f"~{k}", ~v)
    for _ in range(3):
        items = list(best.items())
        for (t1, e1), (t2, e2) in itertools.product(items, items):
            for op, t in (("^", t1 ^ t2), ("&", t1 & t2), ("|", t1 | t2)):
                add(f"({e1} {op} {e2})", t)
                add(f"~({e1} {op} {e2})", ~t)
    return {t: (e[1:-1] if e.startswith("(") else e) for t, e in best.items()}


def netlist(net, outputs, chosen):
    """[(name, argument names, immLut, expression over a, b, c)] in the
    order the signals are computed."""
    exprs = expressions()
    tables = [s.table for s in net]
    names = {i: f"u{i}" for i in range(8)}
    out = []
    for k, n in enumerate(sorted(chosen)):
        names[n] = f"s{outputs.index(n)}" if n in outputs else f"g{k}"
        leaves = chosen[n]
        code, expr = lut(tables, n, leaves, exprs)
        args = [names[l] for l in leaves] + [names[leaves[-1]]] * (3 - len(leaves))
        out.append((names[n], args, code, expr))
    return out


def emit(lines) -> str:
    """C lines: lop3<immLut>, its expression as a comment, where the
    shortest expression of the LUT names the third argument c; else that
    expression, a C expression of one or two signals. A leaf set of two is
    padded by repeating its last leaf, so a line like lop3<0xa0>(x, y, y)
    (x & y) is one function of two signals: it stays lop3, because written
    as x & y it cost one more LOP3 a S-box in ptxas's output (sass_mix.py
    on an H100, in both K1 forms)."""
    text = []
    for name, args, code, expr in lines:
        c_expr = expr
        for ph in "abc":
            c_expr = c_expr.replace(ph, "\0" + ph)
        for ph, arg in zip("abc", args):
            c_expr = c_expr.replace("\0" + ph, arg)
        if "c" in expr:
            text.append(f"  const uint32_t {name} = lop3<0x{code:02x}>({', '.join(args)});"
                        f"  // {c_expr}")
        else:
            text.append(f"  const uint32_t {name} = {c_expr};")
    return "\n".join(text)


def check(lines) -> None:
    """The netlist, evaluated from its immLuts alone, is the AES S-box."""
    sys.path.insert(0, str(ROOT))
    from distributed_point_functions_tpu_torch.core.aes_numpy import SBOX

    x = np.arange(256)
    val = {f"u{i}": (x >> (7 - i)) & 1 for i in range(8)}
    for name, args, code, _ in lines:
        idx = (val[args[0]] << 2) | (val[args[1]] << 1) | val[args[2]]
        val[name] = (code >> idx) & 1
    got = sum(val[f"s{i}"] << (7 - i) for i in range(8))
    if not np.array_equal(got, np.asarray(SBOX, dtype=int)):
        raise AssertionError("the LOP3 netlist is not the AES S-box")


def header() -> str:
    t0 = time.perf_counter()
    net, outputs = traced_sbox()
    packed = np.stack([pack(s.table) for s in net])
    cuts = {n: leaf_sets(packed, n) for n in range(8, len(net))}
    chosen = choose(net, outputs, cuts)
    lines = netlist(net, outputs, chosen)
    check(lines)
    body = emit(lines)
    gates = sum(not s.inverter for s in net[8:])
    print(f"{gates} two-input gates -> {len(chosen)} LOP3 in "
          f"{time.perf_counter() - t0:.0f} s", file=sys.stderr)
    return f"""\
// The AES S-box as {len(chosen)} three-input functions. Generated by gen_sbox_lop3.py
// from the Boyar-Peralta netlist of ops/aes_torch.py _bp_sbox ({gates} two-input
// gates). Each line is one LOP3 on the card: lop3<LUT> (lop3.cuh), with the
// function as a comment, where the LUT's shortest expression reads its third
// argument, also when that argument repeats the second (two lines: as C
// expressions they cost ptxas one more LOP3 an S-box); else a C expression of
// one or two signals. Checked against the AES S-box on all 256 bytes when
// generated, and by tests/test_torch_kernels.py through g++.

#pragma once

#include <cstdint>

#include "lop3.cuh"

namespace dpf {{

// SubBytes of one byte's 8 bit-planes in place, b[0] = LSB (u0 = MSB, s0 =
// the MSB of the result).
__device__ __forceinline__ void sbox_byte(uint32_t* b) {{
  const uint32_t u0 = b[7], u1 = b[6], u2 = b[5], u3 = b[4];
  const uint32_t u4 = b[3], u5 = b[2], u6 = b[1], u7 = b[0];
{body}
  b[0] = s7;
  b[1] = s6;
  b[2] = s5;
  b[3] = s4;
  b[4] = s3;
  b[5] = s2;
  b[6] = s1;
  b[7] = s0;
}}

}}  // namespace dpf
"""


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--check", action="store_true",
                        help="compare the checked-in header with a fresh one; write nothing")
    args = parser.parse_args()
    text = header()
    if args.check:
        if HEADER.read_text() != text:
            sys.exit(f"{HEADER} differs from what gen_sbox_lop3.py writes")
        print(f"{HEADER.name} is up to date")
        return
    HEADER.write_text(text)
    print(f"wrote {HEADER}")


if __name__ == "__main__":
    main()
