"""The PyTorch/CUDA port's batched EvaluateAt against the JAX package, on the
CPU.

``evaluate_at_batch(device="cpu")`` runs the plain versions of K6
(``backend_torch.walk_level``, mode "walk", with K4's) and K7
(``backend_torch.walk_megakernel``, mode "walkkernel"). The references:

- the JAX package's ``evaluate_at_batch(mode="walk", use_pallas=False)``,
  compiled once per party at one point set (module fixture);
- for every other case its host oracle ``core/host_eval.evaluate_at_host``,
  bit-identical to its ``dpf.evaluate_at`` and ``evaluate_at_batch``: no new
  JAX compile;
- for the kernels' plain versions, ``backend_jax.evaluate_seeds_planes``
  (K6, level for level) and the eager replay
  ``aes_pallas.walk_megakernel_reference_rows`` under ``jax.disable_jit()``
  (K7, one key: the real circuit eagerly costs ~10 s a replay).

Comparisons are exact. The kernels' CUDA bodies built with g++ are in
tests/test_torch_kernels.py; the kernels on the card in
tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_point_functions_tpu.core import host_eval
from distributed_point_functions_tpu.core.dpf import DistributedPointFunction as JaxDpf
from distributed_point_functions_tpu.core.params import DpfParameters as JaxParams
from distributed_point_functions_tpu.core import value_types as jax_vt
from distributed_point_functions_tpu.ops import aes_pallas, backend_jax
from distributed_point_functions_tpu.ops import evaluator as jax_ev
import distributed_point_functions_tpu_torch as port
from distributed_point_functions_tpu_torch.core import uint128
from distributed_point_functions_tpu_torch.core.keys import EvaluationContext
from distributed_point_functions_tpu_torch.ops import aes_cuda, aes_torch, backend_torch
from distributed_point_functions_tpu_torch.ops import evaluator as port_ev
from distributed_point_functions_tpu_torch.utils.errors import (
    InvalidArgumentError,
    UnimplementedError,
)
from torch_fold_case import one_torch_thread  # noqa: F401 (autouse fixture)

LOG_DOMAIN = 11
NUM_KEYS = 12
NUM_POINTS = 100  # not a multiple of 32
MODES = ("walk", "walkkernel")


def words(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(aes_torch.as_words(x))


def make_keys(params, alphas, betas, seed):
    """Both packages' DPFs and key pairs from the same seeds. `params` is a
    list of (log_domain_size, value type name, type arguments)."""
    seeds = np.random.default_rng(seed).integers(
        0, 2**32, size=(len(alphas), 2, 4), dtype=np.uint32
    )
    jax_dpf = JaxDpf.create_incremental(
        [JaxParams(lds, getattr(jax_vt, name)(*a)) for lds, name, a in params]
    )
    port_dpf = port.DistributedPointFunction(
        [port.DpfParameters(lds, getattr(port, name)(*a)) for lds, name, a in params]
    )
    return (jax_dpf, jax_dpf.generate_keys_batch(alphas, betas, seeds=seeds),
            port_dpf, port_dpf.generate_keys_batch(alphas, betas, seeds=seeds))


@pytest.fixture(scope="module")
def int64():
    """Int(64) keys of both parties at log-domain 11, 100 points that hold
    every alpha and a repeat, and the JAX package's walk at them (one XLA
    compile per party)."""
    rng = np.random.default_rng(11)
    alphas = [int(a) for a in rng.integers(0, 1 << LOG_DOMAIN, size=NUM_KEYS)]
    betas = [int(b) for b in rng.integers(1, 2**63, size=NUM_KEYS, dtype=np.uint64)]
    points = alphas + [alphas[0]] + [
        int(p) for p in rng.integers(0, 1 << LOG_DOMAIN, size=NUM_POINTS - NUM_KEYS - 1)
    ]
    jax_dpf, jax_keys, port_dpf, port_keys = make_keys(
        [(LOG_DOMAIN, "Int", (64,))], alphas, [betas], seed=12
    )
    want = [
        jax_ev.evaluate_at_batch(
            jax_dpf, jax_keys[party], points, mode="walk", use_pallas=False,
            pipeline=False, integrity=False,
        )
        for party in (0, 1)
    ]
    return dict(alphas=alphas, betas=betas, points=points, port_dpf=port_dpf,
                port_keys=port_keys, want=want)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("party", [0, 1])
def test_evaluate_at_batch_matches_jax(int64, mode, party):
    """Both modes equal the JAX package's walk limb for limb, for both
    parties, in one chunk and in chunks of 5 keys (the last one padded),
    with and without device_output; the shares reconstruct beta at each
    key's alpha and 0 elsewhere; and on the CPU no kernel is launched."""
    aes_cuda.reset_launch_counts()
    run = lambda **kw: port_ev.evaluate_at_batch(
        int64["port_dpf"], int64["port_keys"][party], int64["points"], mode=mode,
        device="cpu", **kw,
    )
    got = run()
    assert got.dtype == np.uint32 and got.shape == (NUM_KEYS, NUM_POINTS, 2)
    assert np.array_equal(got, int64["want"][party])
    chunked = run(key_chunk=5, device_output=True)
    assert isinstance(chunked, torch.Tensor) and chunked.device.type == "cpu"
    assert np.array_equal(aes_torch.from_words(chunked), got)
    assert [k.launches for k in aes_cuda.KERNELS] == [0] * len(aes_cuda.KERNELS)
    if party == 1:
        total = port_ev.values_to_numpy(int64["want"][0], 64) + port_ev.values_to_numpy(got, 64)
        hit = np.array(int64["alphas"])[:, None] == np.array(int64["points"])[None, :]
        assert np.array_equal(total, np.where(hit, np.array(int64["betas"], np.uint64)[:, None], 0))


def host_case(name):
    """(JAX DPF, JAX keys, port DPF, port keys of one party, points, hierarchy
    level, bits, modes) of a case checked against the JAX host oracle."""
    rng = np.random.default_rng(len(name))
    lds = 10
    vt = {"int32": ("Int", (32,)), "xor128": ("XorWrapper", (128,)),
          "int128": ("Int", (128,)), "int8": ("Int", (8,))}.get(name)
    if vt is not None:
        params = [(lds, *vt)]
        bits = vt[1][0]
        betas = [[int(b) for b in rng.integers(1, 2**min(bits, 63), size=8, dtype=np.uint64)]]
    else:  # an incremental DPF, evaluated at its inner hierarchy level
        params = [(6, "Int", (32,)), (lds, "Int", (64,))]
        bits = 32
        betas = [[int(b) for b in rng.integers(1, 2**31, size=8)], 7]
    alphas = [int(a) for a in rng.integers(0, 1 << lds, size=8)]
    jax_dpf, jax_keys, port_dpf, port_keys = make_keys(params, alphas, betas, seed=len(name))
    level = 0 if vt is None else -1
    inner = params[level][0]
    # Every alpha (its prefix at an inner level), repeats, 77 points in all.
    points = [a >> (lds - inner) for a in alphas] + [int(p) for p in rng.integers(0, 1 << inner, size=60)]
    points += points[:9]
    modes = ("walk",) if bits % 32 else MODES
    party = {"xor128": 0, "incremental": 0}.get(name, 1)
    return jax_dpf, jax_keys[party], port_dpf, port_keys[party], points, level, bits, modes


@pytest.mark.parametrize("name", ["int32", "xor128", "int128", "int8", "incremental"])
def test_evaluate_at_batch_matches_the_host_oracle(name):
    """Int(32) (four elements a block), XorWrapper(128), Int(128), the
    sub-word Int(8) (mode "walk" only), and an incremental DPF at its inner
    level, with repeated points and a count that is not a multiple of 32,
    equal the JAX package's host EvaluateAt in every mode that takes them."""
    jax_dpf, jax_keys, port_dpf, port_keys, points, level, bits, modes = host_case(name)
    want = host_eval.evaluate_at_host(jax_dpf, jax_keys, points, hierarchy_level=level)
    for mode in modes:
        got = port_ev.evaluate_at_batch(
            port_dpf, port_keys, points, hierarchy_level=level, mode=mode, device="cpu"
        )
        if bits == 128:
            assert np.array_equal(got, want), mode
        else:
            assert np.array_equal(port_ev.values_to_numpy(got, bits).astype(np.uint64), want), mode


@pytest.mark.parametrize("name", ["int64", "xor128", "modn"])
def test_host_evaluate_at_matches_jax(name):
    """The port's host ``dpf.evaluate_at`` equals the JAX package's, IntModN
    (sampled values) included, at both hierarchy levels of an incremental
    DPF."""
    vt = {"int64": ("Int", (64,)), "xor128": ("XorWrapper", (128,)),
          "modn": ("IntModN", (64, (1 << 64) - 59))}[name]
    rng = np.random.default_rng(len(name))
    alphas = [int(a) for a in rng.integers(0, 1 << 9, size=3)]
    betas = [[1, 2, 3], [int(b) for b in rng.integers(1, 2**31, size=3)]]
    jax_dpf, jax_keys, port_dpf, port_keys = make_keys(
        [(4, *vt), (9, *vt)], alphas, betas, seed=3
    )
    for level, lds in ((0, 4), (1, 9)):
        points = [a >> (9 - lds) for a in alphas] + list(range(0, 1 << lds, 5))
        for party in (0, 1):
            for jk, pk in zip(jax_keys[party], port_keys[party]):
                assert port_dpf.evaluate_at(pk, level, points) == jax_dpf.evaluate_at(
                    jk, level, points
                )


def test_walk_level_plain_matches_jax_scan():
    """K6's plain version equals ``backend_jax.evaluate_seeds_planes``, level
    for level, on the same planes, path masks and tables."""
    rng = np.random.default_rng(6)
    k, w, levels = 3, 3, 4
    planes = rng.integers(0, 2**32, size=(k, 128, w), dtype=np.uint32)
    control = rng.integers(0, 2**32, size=(k, w), dtype=np.uint32)
    paths = rng.integers(0, 2**32, size=(levels, w), dtype=np.uint32)
    cw = backend_torch.cw_seed_planes(rng.integers(0, 2**32, size=(k, levels, 4), dtype=np.uint32))
    ccl = backend_torch.control_masks(rng.integers(0, 2, size=(k, levels)))
    ccr = backend_torch.control_masks(rng.integers(0, 2, size=(k, levels)))
    one_level = jax.jit(jax.vmap(backend_jax.evaluate_seeds_planes, in_axes=(0, 0, None, 0, 0, 0)))
    p_jax, c_jax = jnp.asarray(planes), jnp.asarray(control)
    p_port, c_port = words(planes), words(control)
    for lvl in range(levels):
        s = slice(lvl, lvl + 1)
        p_jax, c_jax = one_level(p_jax, c_jax, jnp.asarray(paths[s]), jnp.asarray(cw[:, s]),
                                 jnp.asarray(ccl[:, s]), jnp.asarray(ccr[:, s]))
        p_port, c_port = backend_torch.walk_level(
            p_port, c_port, words(paths[lvl]), words(cw[:, lvl]), words(ccl[:, lvl]),
            words(ccr[:, lvl]),
        )
        assert np.array_equal(aes_torch.from_words(p_port), np.asarray(p_jax)), lvl
        assert np.array_equal(aes_torch.from_words(c_port), np.asarray(c_jax)), lvl


def test_walk_megakernel_plain_matches_jax_replay():
    """K7's plain version equals the JAX package's eager replay
    ``walk_megakernel_reference_rows`` for one key: a two-level tree, two
    kept Int(64) elements, party 1, mixed select rows and a padded point."""
    rng = np.random.default_rng(7)
    levels, w, bits, keep, party = 2, 1, 64, 2, 1

    def r(*shape):
        return rng.integers(0, 2**32, size=shape, dtype=np.uint32)

    block_sel = rng.integers(0, keep, size=32 * w)
    block_sel[-1] = -1
    sel = aes_torch.pack_bit_mask(block_sel[None, :] == np.arange(keep)[:, None])
    seed = backend_torch.cw_seed_planes(r(1, 4))
    path, cw = r(levels, w), backend_torch.cw_seed_planes(r(1, levels, 4))
    ccl = backend_torch.control_masks(rng.integers(0, 2, size=(1, levels)))
    ccr = backend_torch.control_masks(rng.integers(0, 2, size=(1, levels)))
    corr = r(1, 2, 2)
    kw = dict(bits=bits, party=party, xor_group=False, keep=keep)
    got = backend_torch.walk_megakernel(*map(words, (seed, path, cw, ccl, ccr, corr, sel)), **kw)
    with jax.disable_jit():
        want = aes_pallas.walk_megakernel_reference_rows(
            *map(jnp.asarray, (seed[0], path, cw[0], ccl[0], ccr[0], corr[0], sel)), **kw
        )
    assert np.array_equal(aes_torch.from_words(got)[0], np.asarray(want))


def test_path_bit_masks_match_jax():
    """Per-level path masks from uint128 tree indices, deep trees and
    indices past 64 bits included, equal the JAX package's."""
    rng = np.random.default_rng(98)
    indices = [int(x) for x in rng.integers(0, 2**63, size=40, dtype=np.uint64)]
    indices = [x | (x << 64) for x in indices] + [0, (1 << 127) - 1]
    paths = uint128.array_to_limbs(indices)
    for levels, padded in ((5, 64), (31, 96), (127, 64)):
        if levels < 127:
            paths_l = uint128.array_to_limbs([x & ((1 << levels) - 1) for x in indices])
        else:
            paths_l = paths
        assert np.array_equal(
            backend_torch.path_bit_masks(paths_l, levels, padded),
            backend_jax._path_bit_masks(paths_l, levels, padded),
        )


@pytest.mark.parametrize("budget", [port_ev.WALKKERNEL_BUDGET, 8 << 20, 1 << 16])
def test_plan_walkkernel_matches_jax(budget):
    """For the same budget the port plans the JAX package's tiles, over
    point counts from one to several tiles, tree depths and limb counts, in
    the EvaluateAt form and with the DCF form's captures; a tree without
    levels is refused."""
    for points in (0, 1, 31, 100, 512, 4096, 8193, 20000, 70000):
        for levels in (1, 12, 23, 31):
            for lpe in (1, 2, 4):
                for captures in (False, True):
                    got = port_ev.plan_walkkernel(points, levels, lpe, captures, budget=budget)
                    want = jax_ev.plan_walkkernel(points, levels, lpe, captures, vmem_budget=budget)
                    assert tuple(got) == tuple(want), (points, levels, lpe, captures)
    with pytest.raises(InvalidArgumentError, match="at least one tree level"):
        port_ev.plan_walkkernel(100, 0, 2)


def test_evaluate_at_edges_and_refusals(int64):
    """Refusals: mode "walkkernel" on a sub-word type and on IntModN (the
    codec walk is mode "walk"), an unknown mode, a tree without levels in
    mode "walkkernel", a point outside the domain, keys of two parties, a
    context on the host EvaluateAt and a captures tuple of K7's DCF form
    that does not hold a flag per depth. Edges: no points, and mode "walk" on a tree without
    levels."""
    dpf, keys = int64["port_dpf"], int64["port_keys"]
    int16 = port.DistributedPointFunction.create(port.DpfParameters(10, port.Int(16)))
    k16, _ = int16.generate_keys_batch([3], [[4]])
    with pytest.raises(NotImplementedError, match="32-bit-multiple"):
        port_ev.evaluate_at_batch(int16, k16, [3], mode="walkkernel", device="cpu")
    modn = port.DistributedPointFunction.create(
        port.DpfParameters(9, port.IntModN(64, (1 << 64) - 59))
    )
    km, _ = modn.generate_keys_batch([1], [[2]])
    with pytest.raises(NotImplementedError, match="use mode='walk' for codec"):
        port_ev.evaluate_at_batch(modn, km, [1], mode="walkkernel", device="cpu")
    with pytest.raises(InvalidArgumentError, match="mode"):
        port_ev.evaluate_at_batch(dpf, keys[0], [1], mode="fold", device="cpu")
    jax_flat, (jkf, _), flat, (kf, _) = make_keys([(1, "Int", (64,))], [1], [[2]], seed=1)
    assert flat.validator.hierarchy_to_tree[0] == 0
    with pytest.raises(InvalidArgumentError, match="at least one tree level"):
        port_ev.evaluate_at_batch(flat, kf, [1], mode="walkkernel", device="cpu")
    with pytest.raises(InvalidArgumentError, match="outside the domain"):
        port_ev.evaluate_at_batch(dpf, keys[0], [1 << LOG_DOMAIN], device="cpu")
    with pytest.raises(InvalidArgumentError, match="one party"):
        port_ev.evaluate_at_batch(dpf, [keys[0][0], keys[1][0]], [1], device="cpu")
    with pytest.raises(UnimplementedError, match="Queue 1 item 8"):
        dpf.evaluate_at(keys[0][0], 0, [1], ctx=EvaluationContext(
            parameters=list(dpf.validator.parameters), key=keys[0][0]))
    ops = [torch.zeros(s, dtype=torch.int32) for s in ((1, 128), (2, 1), (1, 2, 128), (1, 2),
                                                        (1, 2), (1, 6, 2), (6, 1))]
    with pytest.raises(InvalidArgumentError, match=r"levels \+ 1 = 3 flags"):
        aes_cuda.walk_megakernel(*ops, bits=64, party=0, xor_group=False, keep=2,
                                 captures=(True,))
    for mode in MODES:
        got = port_ev.evaluate_at_batch(dpf, keys[0], [], mode=mode, device="cpu")
        assert got.shape == (NUM_KEYS, 0, 2)
    # Mode "walk" on a tree without levels: the root seed's value hash.
    want = host_eval.evaluate_at_host(jax_flat, jkf, [0, 1])
    got = port_ev.evaluate_at_batch(flat, kf, [0, 1], device="cpu")
    assert np.array_equal(port_ev.values_to_numpy(got, 64), want)


def test_evaluate_at_past_one_tile_of_points_matches_the_host_oracle():
    """At 8,193 points, one more than the JAX plan's tile of 256 words
    holds, both modes equal the JAX package's host EvaluateAt for 2 keys of
    each party at log-domain 16, and mode "walkkernel" builds its tables at
    ceil(P / 32) words rounded up to 8 (264), not at the plan's padded 512."""
    rng = np.random.default_rng(8193)
    lds, num_points = 16, 8193
    alphas = [int(a) for a in rng.integers(0, 1 << lds, size=2)]
    betas = [int(b) for b in rng.integers(1, 2**63, size=2, dtype=np.uint64)]
    jax_dpf, jax_keys, port_dpf, port_keys = make_keys([(lds, "Int", (64,))], alphas, [betas],
                                                       seed=16)
    points = alphas + [int(p) for p in rng.integers(0, 1 << lds, size=num_points - 2)]
    tree_levels = port_dpf.validator.hierarchy_to_tree[0]
    assert port_ev.plan_walkkernel(num_points, tree_levels, 2).padded_words == 512
    for mode in MODES:
        wp = port_ev.prepare_walk_points(port_dpf, points, mode=mode, device="cpu")
        assert wp.path_masks.shape == (tree_levels, 264 if mode == MODES[1] else 257)
        for party in (0, 1):
            want = host_eval.evaluate_at_host(jax_dpf, jax_keys[party], points)
            got = port_ev.evaluate_at_batch(port_dpf, port_keys[party], points, mode=mode,
                                            device="cpu")
            assert np.array_equal(port_ev.values_to_numpy(got, 64), want), (mode, party)
