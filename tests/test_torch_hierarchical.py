"""The PyTorch/CUDA port's hierarchical advance against the JAX package, on
the CPU.

``hierarchical.evaluate_levels_fused(device="cpu")`` runs the plain
versions of K2 and K4 with the correction in plain PyTorch (mode "fused")
and of K8 (``backend_torch.hier_megakernel``, mode "hierkernel"). The
references:

- the JAX package's host engine, ``hierarchical.evaluate_until_batch(...,
  engine="host")`` level by level (native AES, no JAX compile), run once per
  case and party (a cached oracle);
- its ``prepare_levels_fused(mode="hierkernel")`` and ``plan_hierkernel``
  for the window tables (host arrays, no compile);
- for K8's plain version, the eager replay
  ``aes_pallas.hier_megakernel_reference_rows`` under ``jax.disable_jit()``
  (one key, the real circuit: ~3 s a hash).

Comparisons are exact. K8's body built with g++ is in
tests/test_torch_kernels.py; the kernel on the card in
tests/test_torch_cuda.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_point_functions_tpu.core import value_types as jax_vt
from distributed_point_functions_tpu.core.dpf import DistributedPointFunction as JaxDpf
from distributed_point_functions_tpu.core.params import DpfParameters as JaxParams
from distributed_point_functions_tpu.ops import aes_pallas
from distributed_point_functions_tpu.ops import evaluator as jax_ev
from distributed_point_functions_tpu.ops import hierarchical as jax_hier
import distributed_point_functions_tpu_torch as port
from distributed_point_functions_tpu_torch.core import uint128
from distributed_point_functions_tpu_torch.ops import aes_cuda, aes_torch, backend_torch
from distributed_point_functions_tpu_torch.ops import evaluator as port_ev
from distributed_point_functions_tpu_torch.ops import hierarchical as port_hier
from distributed_point_functions_tpu_torch.utils.errors import InvalidArgumentError
from torch_fold_case import one_torch_thread  # noqa: F401 (autouse fixture)

MODES = port_hier.MODES
# By name, as the port's other suites name their kernel modes: tools/dpflint
# counts literal kernel modes as interpret-pallas compiles, and this module
# compiles none.
FUSED, HIERKERNEL = MODES
NUM_KEYS = 7
KEY_CHUNK = 3  # 7 keys: two full chunks and a padded one
GROUP = 16
# name: (log-domain of hierarchy level 0, levels, type name, type arguments,
# nonzeros, modes, key chunk of mode "hierkernel"). Level i has log-domain
# lds0 + i; its prefixes are the unique prefixes of the nonzeros and the
# keys' alphas.
CASES = {
    # 66 levels: the prefix bookkeeping crosses from uint64 to U128 at 64.
    "int64": (1, 66, "Int", (64,), 24, MODES, None),
    "xor128": (1, 12, "XorWrapper", (128,), 16, MODES, KEY_CHUNK),
    # From log-domain 3: four elements a block.
    "int32": (3, 12, "Int", (32,), 16, MODES, KEY_CHUNK),
    # Sub-word: mode "fused" only.
    "int8": (1, 10, "Int", (8,), 16, ("fused",), KEY_CHUNK),
}
SPLIT = 64  # the split test's first call ends at level SPLIT - 1


def level_plan(lds0, levels, finals):
    """[(0, []), (i, sorted unique prefixes at level i - 1)], U128 arrays from
    log-domain 64, for final leaves of lds0 + levels - 1 bits."""
    top = lds0 + levels - 1
    plan = [(0, [])]
    for i in range(1, levels):
        lds = lds0 + i - 1
        p = sorted({f >> (top - lds) for f in finals})
        plan.append((i, uint128.u128_array(p) if lds >= 64 else np.array(p, dtype=np.uint64)))
    return plan


def as_host(limbs: np.ndarray, bits: int) -> np.ndarray:
    """The port's uint32[..., lpe] limbs in the host engine's layout: uint32
    up to 32 bits, uint64 at 64, uint32[..., 4] limb rows at 128."""
    if bits <= 32:
        return limbs[..., 0]
    if bits == 64:
        return port_ev.values_to_numpy(limbs, 64)
    return limbs


@functools.lru_cache(maxsize=None)
def hier_case(name):
    """Both packages' DPFs and key pairs from the same seeds, the plan, and
    the JAX host engine's outputs at every level for both parties, with its
    context state after level SPLIT - 1."""
    lds0, levels, tname, args, nonzeros, _, key_chunk = CASES[name]
    top = lds0 + levels - 1
    rng = np.random.default_rng(1000 + levels * args[0])
    alphas = port_hier.draw_random_finals(top, NUM_KEYS, rng)
    finals = port_hier.draw_random_finals(top, nonzeros, rng) + alphas
    plan = level_plan(lds0, levels, finals)
    mask = (1 << min(args[0], 63)) - 1
    betas = [[int(b) & mask or 1 for b in rng.integers(1, 2**63, size=NUM_KEYS, dtype=np.uint64)]
             for _ in range(levels)]
    seeds = rng.integers(0, 2**32, size=(NUM_KEYS, 2, 4), dtype=np.uint32)
    jax_dpf = JaxDpf.create_incremental(
        [JaxParams(lds0 + i, getattr(jax_vt, tname)(*args)) for i in range(levels)])
    port_dpf = port.DistributedPointFunction.create_incremental(
        [port.DpfParameters(lds0 + i, getattr(port, tname)(*args)) for i in range(levels)])
    jax_keys = jax_dpf.generate_keys_batch(alphas, betas, seeds=seeds)
    port_keys = port_dpf.generate_keys_batch(alphas, betas, seeds=seeds)
    want, state = [], []
    for party in (0, 1):
        bc = jax_hier.BatchedContext.create(jax_dpf, jax_keys[party])
        outs = []
        for h, prefixes in plan:
            outs.append(np.asarray(jax_hier.evaluate_until_batch(bc, h, prefixes, engine="host")))
            if h == SPLIT - 1:
                state.append((bc.parent_tree, bc.child_levels, np.asarray(bc.seeds),
                              np.asarray(bc.control).astype(np.uint32)))
        want.append(outs)
    return dict(lds0=lds0, levels=levels, bits=args[0], key_chunk=key_chunk, alphas=alphas,
                betas=betas, finals=finals, plan=plan, port_dpf=port_dpf,
                port_keys=port_keys, want=want, state=state)


@functools.lru_cache(maxsize=None)
def port_outputs(name, mode, party):
    c = hier_case(name)
    ctx = port_hier.BatchedContext.create(c["port_dpf"], c["port_keys"][party])
    return port_hier.evaluate_levels_fused(ctx, c["plan"], group=GROUP, mode=mode,
                                           key_chunk=c["key_chunk"], device="cpu")


PARAMS = [(name, mode, party) for name, c in CASES.items() for mode in c[5] for party in (0, 1)]


@pytest.mark.parametrize("name, mode, party", PARAMS)
def test_evaluate_levels_fused_matches_the_host_engine(name, mode, party):
    """Every level's outputs equal the JAX package's host engine exactly:
    Int(64) over 66 levels (uint64 then U128 prefixes), XorWrapper(128),
    Int(32) (four elements a block) in both modes, the sub-word Int(8) in
    mode "fused", both parties, 7 keys in chunks of 3 (one chunk at 66
    levels) in mode "hierkernel"; on the CPU no kernel is launched."""
    c = hier_case(name)
    aes_cuda.reset_launch_counts()
    got = port_outputs(name, mode, party)
    assert [k.launches for k in aes_cuda.KERNELS] == [0] * len(aes_cuda.KERNELS)
    assert len(got) == len(c["plan"])
    lpe = max(c["bits"] // 32, 1)
    for h, (g, w) in enumerate(zip(got, c["want"][party])):
        assert g.dtype == np.uint32 and g.shape == (NUM_KEYS, w.shape[1], lpe), h
        assert np.array_equal(as_host(g, c["bits"]), w), f"level {h}"


@pytest.mark.parametrize("mode", MODES)
def test_shares_reconstruct_beta_on_alphas_path(mode):
    """Per level, r0 + r1 == beta of that level at the candidate that is
    alpha's prefix and 0 at every other candidate (Int(64), 66 levels)."""
    c = hier_case("int64")
    top = c["lds0"] + c["levels"] - 1
    shares = zip(port_outputs("int64", mode, 0), port_outputs("int64", mode, 1))
    for h, (r0, r1) in enumerate(shares):
        total = port_ev.values_to_numpy(r0, 64) + port_ev.values_to_numpy(r1, 64)
        want = np.zeros_like(total)
        lds = c["lds0"] + h
        parents = (None if h == 0 else
                   sorted({f >> (top - lds + 1) for f in c["finals"]}))
        for key, alpha in enumerate(c["alphas"]):
            prefix = alpha >> (top - lds)
            col = prefix if parents is None else 2 * parents.index(prefix >> 1) + (prefix & 1)
            want[key, col] = c["betas"][h][key]
        assert np.array_equal(total, want), f"level {h}"


@pytest.mark.parametrize("mode", MODES)
def test_a_plan_split_across_two_calls_equals_one_call(mode):
    """Levels 0 .. 63 in one call and 64 .. 65 in a second, from the first
    call's context: the outputs equal one call's, and after the first call
    the resumable state (prefix tree, child levels, seeds and control over
    the stored lanes) equals the JAX host engine's."""
    c = hier_case("int64")
    party = 1
    ctx = port_hier.BatchedContext.create(c["port_dpf"], c["port_keys"][party])
    first = port_hier.evaluate_levels_fused(ctx, c["plan"][:SPLIT], group=GROUP, mode=mode,
                                            device="cpu")
    tree, child_levels, seeds, control = c["state"][party]
    assert ctx.previous_hierarchy_level == SPLIT - 1
    assert ctx.child_levels == child_levels and np.array_equal(ctx.parent_tree, tree)
    n = len(tree) << child_levels
    assert ctx.seeds.shape[1] >= n and ctx.control.shape[1] >= n
    assert np.array_equal(aes_torch.from_words(ctx.seeds)[:, :n], seeds)
    assert np.array_equal(aes_torch.from_words(ctx.control)[:, :n], control)
    second = port_hier.evaluate_levels_fused(ctx, c["plan"][SPLIT:], group=GROUP, mode=mode,
                                             device="cpu")
    assert ctx.previous_hierarchy_level == c["levels"] - 1 and ctx.seeds is None
    for h, (g, w) in enumerate(zip(first + second, port_outputs("int64", mode, party))):
        assert np.array_equal(g, w), f"level {h}"


@pytest.mark.parametrize("group", [4, GROUP])
def test_hierkernel_tables_match_jax(group):
    """The prepared hierkernel plan's windows equal the JAX package's, cut
    to the port's width (the JAX lanes past it are padding: zero in
    entry_pos, path and sel), on a 70-level bit-wise plan of 24 nonzeros
    that crosses to U128 prefixes."""
    levels = 70
    rng = np.random.default_rng(70)
    finals = port_hier.draw_random_finals(levels, 24, rng)
    jax_plan = jax_hier.bitwise_hierarchy_plan(levels, finals)
    plan = port_hier.bitwise_hierarchy_plan(levels, finals)
    vt = (jax_vt.Int(64), port.Int(64))
    jax_dpf = JaxDpf.create_incremental([JaxParams(i + 1, vt[0]) for i in range(levels)])
    port_dpf = port.DistributedPointFunction.create_incremental(
        [port.DpfParameters(i + 1, vt[1]) for i in range(levels)])
    jax_key = jax_dpf.generate_keys_incremental(5, [1] * levels)[0]
    port_key = port_dpf.generate_keys_incremental(5, [1] * levels)[0]
    want = jax_hier.prepare_levels_fused(jax_hier.BatchedContext.create(jax_dpf, [jax_key]),
                                         jax_plan, group, mode=HIERKERNEL)
    got = port_hier.prepare_levels_fused(port_hier.BatchedContext.create(port_dpf, [port_key]),
                                         plan, group, mode=HIERKERNEL, device="cpu")
    for field in ("plan_levels", "bits", "xor_group", "final_level", "emit_state",
                  "end_child_levels", "hier_keep"):
        assert getattr(got, field) == getattr(want, field), field
    assert np.array_equal(got.end_parent_tree, want.end_parent_tree)
    assert len(got.hier_windows) == len(want.hier_windows) == -(-levels // group)
    for gw, ww in zip(got.hier_windows, want.hier_windows):
        for field in ("captures", "depth", "start_level", "slot_steps", "slot_keeps",
                      "state_base", "state_len", "state_cap"):
            assert getattr(gw, field) == getattr(ww, field), field
        wp = gw.plan.padded_words
        assert gw.plan == port_ev.HierkernelPlan(gw.depth, wp, 1, wp)
        assert wp <= ww.plan.padded_words and wp * 32 >= gw.state_base + gw.state_cap
        entry = np.asarray(ww.entry_pos_dev)
        assert np.array_equal(gw.entry_pos.numpy(), entry[: wp * 32]) and not entry[wp * 32 :].any()
        for mine, theirs in ((gw.path, ww.path_dev), (gw.sel, ww.sel_dev)):
            theirs = np.asarray(theirs)
            assert np.array_equal(aes_torch.from_words(mine), theirs[:, :wp])
            assert not theirs[:, wp:].any()
        assert len(gw.gsels) == len(ww.gsels_dev)
        for a, b in zip(gw.gsels, ww.gsels_dev):
            assert np.array_equal(a.numpy(), np.asarray(b))


def parent_table_plan(hierarchy):
    """(port DPF, plan) of a hierarchy for the parent-table test."""
    rng = np.random.default_rng(71)
    if hierarchy == "bitwise int64":  # crosses to U128 prefixes at 64
        levels = 70
        finals = port_hier.draw_random_finals(levels, 24, rng)
        params = [port.DpfParameters(i + 1, port.Int(64)) for i in range(levels)]
        return (port.DistributedPointFunction.create_incremental(params),
                port_hier.bitwise_hierarchy_plan(levels, finals))
    # Int(32) from log-domain 3 in steps of two: two tree levels an advance.
    levels, lds0, step = 12, 3, 2
    top = lds0 + step * (levels - 1)
    finals = port_hier.draw_random_finals(top, 24, rng)
    params = [port.DpfParameters(lds0 + step * i, port.Int(32)) for i in range(levels)]
    plan = [(0, [])] + [(i, sorted({f >> (top - lds0 - step * (i - 1)) for f in finals}))
                        for i in range(1, levels)]
    return port.DistributedPointFunction.create_incremental(params), plan


@pytest.mark.parametrize("group", [4, GROUP])
@pytest.mark.parametrize("hierarchy", ["bitwise int64", "int32 two-level steps"])
def test_hierkernel_parent_table_reaches_entry_pos_and_path(hierarchy, group):
    """Every window's segment table lays its advances out as the JAX tables
    do (contiguous segments, slot t captured at segment t's depth, the last
    segment the exit state), and from every real lane, following ``parent``
    up to segment 0 reaches the lane's ``entry_pos``, each parent in the
    segment before, with the leaf index of each step (lane i of a parent's
    2^levels_d leaves walks the bits of i) spelling the lane's ``path`` rows
    down to its depth, 0 below it: K8, which walks each lane from its
    parent, walks the paths the JAX kernel walks from the entry. Pad lanes
    point at lane 0."""
    dpf, plan = parent_table_plan(hierarchy)
    key = dpf.generate_keys_incremental(5, [1] * dpf.validator.num_hierarchy_levels)[0]
    prepared = port_hier.prepare_levels_fused(port_hier.BatchedContext.create(dpf, [key]),
                                              plan, group, mode=HIERKERNEL, device="cpu")
    for win in prepared.hier_windows:
        parent, entry = win.parent.numpy(), win.entry_pos.numpy()
        path = backend_torch.unpack_mask_device(win.path).numpy()  # [depth, lanes] 0 / 1
        segs = win.segments
        assert segs[0][0] == 0 and segs[-1][:2] == (win.state_base, win.state_len)
        assert segs[-1][2] == win.depth and len(segs) == len(win.slot_steps)
        for t, (b, n, d, ld) in enumerate(segs):
            assert win.captures[d] == t and ld == d - (segs[t - 1][2] if t else 0)
            assert t == 0 or (b == sum(segs[t - 1][:2]) and ld >= 1)
            lanes = np.arange(b, b + n)
            cur, bits = lanes, np.zeros((d, n), dtype=np.int64)
            for u in range(t, -1, -1):
                ub, _, ud, uld = segs[u]
                leaf = cur - ub
                for j in range(uld):
                    bits[ud - uld + j] = (leaf >> (uld - 1 - j)) & 1
                cur = parent[cur]
                if u:
                    pb, pn = segs[u - 1][:2]
                    assert ((cur >= pb) & (cur < pb + pn)).all()
            assert np.array_equal(entry[lanes], cur)
            assert np.array_equal(path[:d, b:b + n], bits) and not path[d:, b:b + n].any()
        total = sum(segs[-1][:2])
        assert not parent[total:].any() and not entry[total:].any()


@pytest.mark.parametrize("levels", [20, 128])
def test_host_helpers_match_jax(levels):
    """``draw_random_finals`` draws the JAX package's leaves from the same
    generator state (int64 range and 32-bit words), ``bitwise_hierarchy_plan``
    builds its plan, and ``candidate_children`` lists its candidates and
    refuses what it refuses."""
    finals = port_hier.draw_random_finals(levels, 50, np.random.default_rng(levels))
    assert finals == jax_hier.draw_random_finals(levels, 50, np.random.default_rng(levels))
    plan = port_hier.bitwise_hierarchy_plan(levels, finals)
    for (h, a), (g, b) in zip(plan, jax_hier.bitwise_hierarchy_plan(levels, finals)):
        a, b = np.asarray(a), np.asarray(b)
        assert h == g and a.dtype == b.dtype and np.array_equal(a, b)
    if levels > 62:
        for fn in (port_hier.candidate_children, jax_hier.candidate_children):
            with pytest.raises(ValueError, match="uint64"):  # each package's InvalidArgumentError
                fn(plan[3][1], 3, 63)
        return
    for prev, lds in ((0, 1), (3, 4), (3, 6), (7, 12)):
        prefixes = [] if prev == 0 else plan[prev][1][::-1]
        assert np.array_equal(port_hier.candidate_children(prefixes, prev, lds),
                              jax_hier.candidate_children(prefixes, prev, lds))
    with pytest.raises(InvalidArgumentError, match="descends"):
        port_hier.candidate_children([1], 4, 4)


@pytest.mark.parametrize("lanes, levels, n_rows, lpe, keep, budget", [
    (1, 1, 1, 1, 1, None), (90, 8, 16, 2, 2, None), (320_000, 16, 32, 2, 2, None),
    (1_000_000, 16, 32, 2, 2, None), (8192, 6, 6, 2, 2, 200_000), (5000, 3, 3, 4, 1, 65_536),
])
def test_plan_hierkernel_matches_jax(lanes, levels, n_rows, lpe, keep, budget):
    """``plan_hierkernel`` plans the JAX package's tiles from the same
    budget (its default, the v5e's 8 MB, included); the port's own window
    width is never wider."""
    kw = {} if budget is None else dict(vmem_budget=budget)
    got = port_ev.plan_hierkernel(lanes, levels, n_rows, lpe, keep, **kw)
    assert tuple(got) == tuple(jax_ev.plan_hierkernel(lanes, levels, n_rows, lpe, keep, **kw))
    words = port_ev.lane_words(lanes)
    assert words % 8 == 0 and 32 * words >= lanes and words <= got.padded_words


@pytest.mark.parametrize("party, bits, keep, captures", [
    (0, 64, 2, (1, 0)), (1, 128, 1, (-1, 0)),
])
def test_hier_megakernel_plain_matches_jax_replay(party, bits, keep, captures):
    """K8's plain version equals the JAX package's eager replay
    ``hier_megakernel_reference_rows`` (the real circuit) for one key at one
    word: Int(64) with two slots placed at depths 0 and 1, party 0; and
    XorWrapper(128) with a depth that does not capture, party 1. The value
    rows, the exit planes and the exit control."""
    rng = np.random.default_rng(80 + party)
    lpe, slots = bits // 32, max(captures) + 1

    def r(*shape):
        return rng.integers(0, 2**32, size=shape, dtype=np.uint32)

    levels = len(captures) - 1
    ops = [r(1, 128, 1), r(1, 1), r(levels, 1), r(1, levels, 128), r(1, levels),
           r(1, levels), r(1, slots * keep, lpe), r(slots * keep, 1)]
    kw = dict(bits=bits, party=party, xor_group=bits == 128, keep=keep, captures=captures)
    got = backend_torch.hier_megakernel(*(torch.from_numpy(aes_torch.as_words(a)) for a in ops),
                                        **kw)
    with jax.disable_jit():
        want = aes_pallas.hier_megakernel_reference_rows(
            jnp.asarray(ops[0][0]), jnp.asarray(ops[1][0]), jnp.asarray(ops[2]),
            *(jnp.asarray(a[0]) for a in ops[3:7]), jnp.asarray(ops[7]), **kw)
    for g, w in zip(got, want):
        assert np.array_equal(aes_torch.from_words(g)[0], np.asarray(w))


def refusal(name):
    """(call, exception, message) of one refused request."""
    c = hier_case("int64")
    dpf, keys, plan = c["port_dpf"], c["port_keys"][0], c["plan"]

    def ctx():
        return port_hier.BatchedContext.create(dpf, keys)

    def run(p, **kw):
        return lambda: port_hier.evaluate_levels_fused(ctx(), p, device="cpu", **kw)

    if name == "modn":
        d = port.DistributedPointFunction.create_incremental(
            [port.DpfParameters(4, port.IntModN(64, 2**61 - 1))])
        k, _ = d.generate_keys_incremental(3, [1])
        return (lambda: port_hier.evaluate_levels_fused(
            port_hier.BatchedContext.create(d, [k]), [(0, [])], device="cpu"),
            InvalidArgumentError, "scalar Int/XorWrapper")
    if name in ("sub-word hierkernel", "zero-depth window"):
        # Level 0 of a bit-wise hierarchy sits at tree depth 0: a window of
        # that level alone walks no level.
        vt = port.Int(8) if name == "sub-word hierkernel" else port.Int(32)
        d = port.DistributedPointFunction.create_incremental(
            [port.DpfParameters(i + 1, vt) for i in range(2)])
        k, _ = d.generate_keys_incremental(3, [1] * 2)
        return (lambda: port_hier.evaluate_levels_fused(
            port_hier.BatchedContext.create(d, [k]), [(0, []), (1, [0, 1])], group=1,
            mode=HIERKERNEL, device="cpu"),
            NotImplementedError, {"sub-word hierkernel": "32-bit-multiple",
                                  "zero-depth window": "zero tree levels"}[name])
    if name == "level sharing a depth":
        # Validated parameters give every hierarchy level its own tree depth;
        # the window composer refuses a step that shares one all the same.
        raw = [(np.zeros(1, np.int64), 1, 1, np.arange(4), 2, 2, 0, 0),
               (np.zeros(1, np.int64), 1, 0, np.arange(2), 2, 2, 1, 1)]
        return (lambda: port_hier._compose_hier_windows(raw, 2, 64, 1, "cpu"),
                NotImplementedError, "deepen")
    if name == "window deeper than 62":
        return run(plan, group=64, mode=HIERKERNEL), NotImplementedError, "exceeds 62"
    if name == "group 0":
        return run(plan, group=0), InvalidArgumentError, "group"
    if name == "empty plan":
        return (lambda: port_hier.prepare_levels_fused(ctx(), [], device="cpu"),
                InvalidArgumentError, "non-empty")
    if name == "non-increasing plan":
        return run([plan[0], plan[1], plan[1]]), InvalidArgumentError, "strictly increasing"
    if name == "unknown mode":
        return run(plan, mode="walk"), InvalidArgumentError, "mode"
    if name == "key chunk 0":
        return run(plan, mode=HIERKERNEL, key_chunk=0), InvalidArgumentError, "key_chunk"
    if name == "two parties":
        mixed = [keys[0], c["port_keys"][1][0]]
        return (lambda: port_hier.BatchedContext.create(dpf, mixed), InvalidArgumentError,
                "one party")
    prepared = port_hier.prepare_levels_fused(ctx(), plan[:2], mode=HIERKERNEL, device="cpu")
    if name == "prepared for another mode":
        return run(prepared, mode=FUSED), InvalidArgumentError, "re-prepare"
    if name == "prepared for another context state":
        moved = ctx()
        port_hier.evaluate_levels_fused(moved, plan[:1], device="cpu")
        return (lambda: port_hier.evaluate_levels_fused(moved, prepared, mode=HIERKERNEL,
                                                        device="cpu"),
                InvalidArgumentError, "context state")
    assert name == "prepared for other parameters"
    other = hier_case("xor128")
    octx = port_hier.BatchedContext.create(other["port_dpf"], other["port_keys"][0])
    return (lambda: port_hier.evaluate_levels_fused(octx, prepared, mode=HIERKERNEL,
                                                    device="cpu"),
            InvalidArgumentError, "parameter list")


@pytest.mark.parametrize("name", [
    "modn", "sub-word hierkernel", "zero-depth window", "level sharing a depth",
    "window deeper than 62", "group 0", "empty plan", "non-increasing plan", "unknown mode",
    "key chunk 0", "two parties", "prepared for another mode",
    "prepared for another context state", "prepared for other parameters",
])
def test_refusals(name):
    """As the JAX package: IntModN values (InvalidArgumentError); in mode
    "hierkernel" a sub-word width, a window of zero depth, a later level
    that does not deepen the tree and a window deeper than 62 levels
    (NotImplementedError); group 0, an empty or non-increasing plan, an
    unknown mode, a key chunk of 0, keys of two parties, and a prepared plan
    for another mode, context state or parameter list
    (InvalidArgumentError)."""
    call, exc, match = refusal(name)
    with pytest.raises(exc, match=match):
        call()


def test_prepared_plan_replays_and_an_empty_plan_is_a_no_op():
    """A prepared plan replays on a second key batch in the same state and
    gives what the plan gives; ``device_output`` keeps int32 tensors; an
    empty plan returns [] and leaves the context as it was."""
    c = hier_case("xor128")
    keys = c["port_keys"][0]
    ctx = port_hier.BatchedContext.create(c["port_dpf"], keys[:2])
    prepared = port_hier.prepare_levels_fused(ctx, c["plan"], mode=HIERKERNEL, device="cpu")
    assert port_hier.evaluate_levels_fused(ctx, [], device="cpu") == []
    assert ctx.previous_hierarchy_level == -1
    again = port_hier.BatchedContext.create(c["port_dpf"], keys[2:4])
    got = port_hier.evaluate_levels_fused(again, prepared, mode=HIERKERNEL, device="cpu",
                                          device_output=True)
    assert all(isinstance(g, torch.Tensor) and g.dtype == torch.int32 for g in got)
    want = port_outputs("xor128", HIERKERNEL, 0)
    for g, w in zip(got, want):
        assert np.array_equal(aes_torch.from_words(g), w[2:4])
