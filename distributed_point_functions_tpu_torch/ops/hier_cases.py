"""K8's check windows: the inputs on which the port's tests (K8's body
built with g++, and K8 on the card) and chip_smoke.py hold
``aes_cuda.hier_megakernel`` against its plain version,
``backend_torch.hier_window``.

Each case is one prefix window of a real small hierarchy, composed by
``hierarchical.prepare_levels_fused(mode="hierkernel")``: K8 walks each lane
from its parent, so only such windows are inputs to it. The keys' own
tables, a random window-entry state (the context's seeds and control bits,
which K8 reads through the window's parent table and the plain version
through ``entry_pos``) and, on request, corrections that carry through every
limb. The plain version takes K8's operands but the parent table:
``backend_torch.hier_window(*args[:3], *args[4:], **kw)``.
"""

import numpy as np
import torch

from ..core.dpf import DistributedPointFunction
from ..core.params import DpfParameters
from ..core.value_types import Int, XorWrapper
from . import aes_torch, backend_torch, hierarchical

NUM_KEYS = 3
NONZEROS = 20

# name: (value type, its arguments, log-domain of level 0, log-domain step,
# levels, group, window, party). Level i has log-domain lds0 + step * i.
CASES = {
    # Level 0 sits at tree depth 0: the first step advances no level.
    "int64, zero-level first step": ("Int", (64,), 1, 1, 12, 4, 0, 0),
    "int64, a later window": ("Int", (64,), 1, 1, 12, 4, 1, 1),
    # From log-domain 1 every Int(32) level keeps two of a block's four.
    "int32 keep 2": ("Int", (32,), 1, 1, 10, 5, 1, 1),
    # Steps of two tree levels; four elements a block.
    "int32 keep 4, two-level steps": ("Int", (32,), 3, 2, 6, 3, 0, 0),
    "xor128": ("XorWrapper", (128,), 1, 1, 10, 4, 0, 1),
    "int64, three-level steps": ("Int", (64,), 2, 3, 5, 2, 1, 0),
    "int128": ("Int", (128,), 1, 1, 8, 4, 1, 1),
}


def window_case(name: str, *, device, carry: bool = True) -> dict:
    """The window of case `name`: ``args`` (K8's operands, in the order of
    ``aes_cuda.hier_megakernel``) and ``kw`` (its keywords) on `device`,
    and the window itself (``win``). With `carry`, corrections under which
    one selected lane of each (segment, element) whose control bit is set
    sums to exactly 0 mod 2^bits (``carrying_corrections``), else the keys'
    own."""
    tname, targs, lds0, step, levels, group, window, party = CASES[name]
    vt = {"Int": Int, "XorWrapper": XorWrapper}[tname](*targs)
    dpf = DistributedPointFunction.create_incremental(
        [DpfParameters(lds0 + step * i, vt) for i in range(levels)])
    top = lds0 + step * (levels - 1)
    rng = np.random.default_rng(sum(map(ord, name)))
    alphas = hierarchical.draw_random_finals(top, NUM_KEYS, rng)
    finals = hierarchical.draw_random_finals(top, NONZEROS, rng) + alphas
    plan = [(0, [])] + [
        (i, sorted({f >> (top - lds0 - step * (i - 1)) for f in finals})) for i in range(1, levels)]
    betas = [[int(b) for b in rng.integers(1, 2**31, size=NUM_KEYS)] for _ in range(levels)]
    seeds = rng.integers(0, 2**32, size=(NUM_KEYS, 2, 4), dtype=np.uint32)
    keys = dpf.generate_keys_batch(alphas, betas, seeds=seeds)[party]
    ctx = hierarchical.BatchedContext.create(dpf, keys)
    prepared = hierarchical.prepare_levels_fused(ctx, plan, group, mode=hierarchical.MODES[1],
                                                 device="cpu")
    lk = hierarchical.prepare_level_keys(ctx, prepared)
    win = prepared.hier_windows[window]
    lo, hi = win.start_level, win.start_level + win.depth
    m = win.state_cap  # the entry state's width: every window's exit width
    entry = rng.integers(0, 2**32, size=(NUM_KEYS, m, 4), dtype=np.uint32)
    entry_control = rng.integers(0, 2, size=(NUM_KEYS, m)).astype(np.int32)
    args = [torch.from_numpy(aes_torch.as_words(entry)), torch.from_numpy(entry_control),
            win.entry_pos, win.parent, win.path, lk.cw[:, lo:hi].contiguous(),
            lk.ccl[:, lo:hi].contiguous(), lk.ccr[:, lo:hi].contiguous(),
            lk.corrections[window], win.sel]
    bits = prepared.bits
    kw = dict(segments=win.segments, state_cap=win.state_cap, bits=bits, party=party,
              xor_group=prepared.xor_group, keep=prepared.hier_keep)
    if carry and not prepared.xor_group:
        args[8] = carrying_corrections(args, kw)
    return dict(args=[a.to(device) for a in args], kw=kw, win=win)


def carrying_corrections(args, kw) -> torch.Tensor:
    """Corrections under which, for each key and row (segment, element),
    one lane of the segment whose control bit is set at its capture sums to
    exactly 0 mod 2^bits: the add carries out of every limb, and party 1's
    negation of that 0 carries through every limb, at every capture."""
    bits, keep = kw["bits"], kw["keep"]
    lpe = bits // 32
    zero_kw = dict(kw, party=0)

    def values(corr):  # [K, keep, 32 W] python ints
        vals = backend_torch.hier_window(*args[:3], *args[4:8], corr, args[9], **zero_kw)[0]
        rows = aes_torch.from_words(vals).astype(object)
        k, _, w = rows.shape
        limbs = rows.reshape(k, keep, lpe, 32, w).transpose(0, 1, 4, 3, 2).reshape(
            k, keep, 32 * w, lpe)
        return sum(limbs[..., l] << (32 * l) for l in range(lpe))

    zero = torch.zeros_like(args[8])
    base = values(zero)
    probe = zero.clone()
    probe[:, :, 0] = 1
    moved = values(probe) != base  # selected lanes whose control bit is set
    sel = backend_torch.unpack_mask_device(args[9]).numpy() == 1
    out = aes_torch.from_words(zero).copy()
    for key in range(out.shape[0]):
        for row in range(out.shape[1]):
            hits = np.nonzero(moved[key, row % keep] & sel[row])[0]
            if hits.size:
                value = -base[key, row % keep, hits[0]] % (1 << bits)
                out[key, row] = [(value >> (32 * l)) & 0xFFFFFFFF for l in range(lpe)]
    return torch.from_numpy(aes_torch.as_words(out))
