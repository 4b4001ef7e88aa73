"""The PyTorch/CUDA port's kernel modules against the JAX package, on the CPU.

K1 (bitsliced AES, ops/aes_torch.py), K2/K3/K4 (ops/backend_torch.py, the
plain versions the CUDA wrappers in ops/aes_cuda.py run for CPU tensors) are
held bit-exact against the JAX package's host engine on the same lanes
(``core/backend_numpy.expand_seeds`` and ``hash_expanded_seeds``, native
AES-NI where the host has it: no XLA program), the plane layout checked
against ``aes_jax.pack_to_planes`` once. K5's
plain version (``backend_torch.megakernel_fold``) is held against the JAX
package's eager replay ``aes_pallas.megakernel_reference_rows`` (the real
circuit under ``jax.disable_jit()``; no interpret-mode kernel), and its
pieces, the row-form correction and the 32x32 transpose, against theirs.
Every comparison is exact (``np.array_equal``): the outputs are integers.
The CUDA sources themselves are built with the host compiler and held
against the plain versions too; the kernels on the card are
tests/test_torch_cuda.py.
"""

import re
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_point_functions_tpu.core import aes_numpy as jax_aes_numpy
from distributed_point_functions_tpu.core import backend_numpy as jax_backend_numpy
from distributed_point_functions_tpu.core import constants as jax_constants
from distributed_point_functions_tpu.core.dpf import DistributedPointFunction as JaxDpf
from distributed_point_functions_tpu.core.params import DpfParameters as JaxParams
from distributed_point_functions_tpu.core.value_types import Int as JaxInt
from distributed_point_functions_tpu.core.value_types import XorWrapper as JaxXor
from distributed_point_functions_tpu.ops import aes_jax, aes_pallas, backend_jax
from distributed_point_functions_tpu.ops import evaluator as jax_ev
from distributed_point_functions_tpu.ops import value_codec as jax_value_codec
import distributed_point_functions_tpu_torch as port
from distributed_point_functions_tpu_torch.core import aes_numpy, backend_numpy, constants
from distributed_point_functions_tpu_torch.ops import (
    aes_cuda, aes_torch, backend_torch, evaluator, hier_cases, value_codec,
)
from distributed_point_functions_tpu_torch.utils.errors import InvalidArgumentError
from torch_fold_case import (  # noqa: F401 (one_torch_thread: an autouse fixture)
    blocks_to_planes, lane_bits, lane_masks, one_torch_thread, planes_to_blocks,
)

RNG_SEED = 20261016
K = 3  # keys
WIDTHS = (3, 40)  # lane words: a ragged width and one past a warp


def host_expand(planes, control, cw, ccl, ccr):
    """K2's operands of one key through the JAX package's host engine
    (``backend_numpy.expand_seeds``, one level): planes and control with
    the lane axis doubled, [left children | right children], as the plane
    form lays them out."""
    seed_cw = planes_to_blocks(cw[:, None] & np.uint32(1))[0]
    children, child_control = jax_backend_numpy.expand_seeds(
        planes_to_blocks(planes), lane_bits(control), seed_cw[None],
        np.array([ccl != 0]), np.array([ccr != 0]))
    order = np.concatenate([np.arange(0, len(children), 2), np.arange(1, len(children), 2)])
    return (blocks_to_planes(children[order]),
            lane_masks(child_control[order]))


def host_expand_batch(planes, control, cw, ccl, ccr):
    """host_expand for each key of a batch."""
    out = [host_expand(*a) for a in zip(planes, control, cw, ccl, ccr)]
    return np.stack([o[0] for o in out]), np.stack([o[1] for o in out])


def host_hash(planes):
    """K4's value hash of every lane through the JAX package's host engine
    (``backend_numpy.hash_expanded_seeds``, block 0)."""
    blocks = planes_to_blocks(planes)
    hashed = jax_backend_numpy.hash_expanded_seeds(blocks.reshape(-1, 4), 1)[:, 0]
    return blocks_to_planes(hashed.reshape(blocks.shape))


def words(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(aes_torch.as_words(x))


def expand_inputs(w: int, seed: int):
    """uint32 numpy operands of one doubling level for K keys."""
    rng = np.random.default_rng(seed)
    planes = rng.integers(0, 2**32, size=(K, 128, w), dtype=np.uint32)
    control = rng.integers(0, 2**32, size=(K, w), dtype=np.uint32)
    cw = backend_torch.cw_seed_planes(
        rng.integers(0, 2**32, size=(K, 4), dtype=np.uint32)
    )
    ccl = backend_torch.control_masks(rng.integers(0, 2, size=K))
    ccr = backend_torch.control_masks(rng.integers(0, 2, size=K))
    return planes, control, cw, ccl, ccr


def test_fips197_vector():
    """FIPS-197 appendix C.1 through the port's numpy AES and its bitsliced
    torch AES (the plain K1)."""
    key = bytes(range(16))
    plain = bytes.fromhex("00112233445566778899aabbccddeeff")
    want = bytes.fromhex("69c4e0d86a7b0430d8cdb78070b4c55a")
    rk = aes_numpy.expand_key(key)
    got = aes_numpy.encrypt_blocks(np.frombuffer(plain, np.uint8)[None], rk)
    assert got.tobytes() == want
    blocks = np.tile(np.frombuffer(plain, np.uint32), (32, 1))
    planes = aes_torch.pack_to_planes(words(blocks))
    enc = aes_torch.aes_encrypt_planes(
        planes.reshape(16, 8, 1),
        aes_torch.round_key_planes(int.from_bytes(key, "little")),
    )
    out = aes_torch.from_words(aes_torch.unpack_from_planes(enc.reshape(128, 1)))
    assert all(row.tobytes() == want for row in out)


def test_host_aes_and_constants_match_jax_package():
    """The port's copies of the PRG keys, the numpy MMO hashes and the
    plane round keys equal the JAX package's."""
    for name in ("PRG_KEY_LEFT", "PRG_KEY_RIGHT", "PRG_KEY_VALUE"):
        key = getattr(constants, name)
        assert key == getattr(jax_constants, name)
        assert np.array_equal(
            aes_torch.round_key_planes(key), aes_jax.round_key_planes(key)
        )
    blocks = np.random.default_rng(RNG_SEED).integers(
        0, 2**32, size=(50, 4), dtype=np.uint32
    )
    for key in (constants.PRG_KEY_LEFT, constants.PRG_KEY_VALUE):
        got = aes_numpy.Aes128FixedKeyHash(key).evaluate_limbs(blocks)
        want = jax_aes_numpy.Aes128FixedKeyHash(key).evaluate_limbs(blocks)
        assert np.array_equal(got, want)
    seeds = blocks.copy()
    seeds[0] = 0xFFFFFFFF  # carry through every limb of seed + j
    got = backend_numpy.hash_expanded_seeds(seeds, 3)
    for j in range(3):
        inp = [(int.from_bytes(s.tobytes(), "little") + j) % 2**128 for s in seeds]
        want = jax_aes_numpy.Aes128FixedKeyHash(jax_constants.PRG_KEY_VALUE).evaluate(inp)
        assert [int.from_bytes(h.tobytes(), "little") for h in got[:, j]] == want


@pytest.mark.parametrize("n", [32, 96])
def test_pack_unpack_match_jax(n):
    x = np.random.default_rng(n).integers(0, 2**32, size=(2, n, 4), dtype=np.uint32)
    planes = aes_torch.pack_to_planes(words(x))
    # Both keys' blocks in one jitted call: whole lane words, key after key.
    joint = np.asarray(jax.jit(aes_jax.pack_to_planes)(jnp.asarray(x.reshape(-1, 4))))
    want = joint.reshape(128, 2, n // 32).transpose(1, 0, 2)
    assert np.array_equal(aes_torch.from_words(planes), want)
    # The host-engine tests' numpy layout is the JAX package's.
    assert np.array_equal(blocks_to_planes(x), want)
    assert np.array_equal(planes_to_blocks(want), x)
    assert np.array_equal(aes_torch.from_words(aes_torch.unpack_from_planes(planes)), x)
    bits = np.random.default_rng(n + 1).integers(0, 2, size=(2, n)).astype(bool)
    assert np.array_equal(aes_torch.pack_bit_mask(bits), aes_jax.pack_bit_mask(bits))
    mask = aes_torch.pack_bit_mask(bits)
    assert np.array_equal(
        aes_torch.from_words(backend_torch.unpack_mask_device(words(mask))),
        np.asarray(jax.jit(jax.vmap(backend_jax.unpack_mask_device))(jnp.asarray(mask))),
    )


@pytest.mark.parametrize("w", WIDTHS)
def test_k2_expand_one_level_matches_jax(w):
    args = expand_inputs(w, RNG_SEED + w)
    want = host_expand_batch(*args)
    for fn in (backend_torch.expand_one_level, aes_cuda.expand_one_level):
        got = fn(*map(words, args))
        assert np.array_equal(aes_torch.from_words(got[0]), want[0])
        assert np.array_equal(aes_torch.from_words(got[1]), want[1])


def test_k2_one_key_view_matches_jax():
    """K2's one-key view in the legacy [128, W] layout (the replacement of
    aes_pallas.expand_one_level_pallas) equals the JAX package's host
    expansion of the key's lanes at W = 32: the plain version and the
    wrapper on CPU tensors."""
    args = [a[0] for a in expand_inputs(32, RNG_SEED + 32)]
    want = host_expand(*args)
    for fn in (backend_torch.expand_one_level_single, aes_cuda.expand_one_level_single):
        got = fn(*map(words, args))
        assert np.array_equal(aes_torch.from_words(got[0]), want[0])
        assert np.array_equal(aes_torch.from_words(got[1]), want[1])


@pytest.mark.parametrize("w", [2 * w for w in WIDTHS])
def test_k4_hash_value_planes_matches_jax(w):
    planes = np.random.default_rng(RNG_SEED - w).integers(
        0, 2**32, size=(K, 128, w), dtype=np.uint32
    )
    want = host_hash(planes)
    for fn in (backend_torch.hash_value_planes, aes_cuda.hash_value_planes):
        assert np.array_equal(aes_torch.from_words(fn(words(planes))), want)
    # The plain K1 under the value key is the numpy oracle's MMO hash.
    blocks = aes_torch.unpack_from_planes(words(planes))
    got = aes_torch.unpack_from_planes(backend_torch.hash_value_planes(words(planes)))
    oracle = backend_numpy._PRG_VALUE.evaluate_limbs(
        aes_torch.from_words(blocks).reshape(-1, 4)
    )
    assert np.array_equal(aes_torch.from_words(got).reshape(-1, 4), oracle)


@pytest.mark.parametrize("w", WIDTHS)
def test_k3_expand_and_hash_matches_jax_composition(w):
    args = expand_inputs(w, RNG_SEED + w)
    children, control = host_expand_batch(*args)
    want = (host_hash(children), control)
    for fn in (backend_torch.expand_and_hash_last_level, aes_cuda.expand_and_hash_last_level):
        got = fn(*map(words, args))
        assert np.array_equal(aes_torch.from_words(got[0]), want[0])
        assert np.array_equal(aes_torch.from_words(got[1]), want[1])


@pytest.mark.parametrize("bits", [32, 64, 128])
def test_rows_correct_element_matches_jax(bits):
    """The row-form correction, its limb add and its negation equal the JAX
    package's for both parties and both groups, on random rows and on rows
    of 0 / ~0 limbs whose carries run the whole element."""
    rng = np.random.default_rng(bits)
    lpe, n = bits // 32, 96
    limbs = rng.integers(0, 2**32, size=(lpe, n), dtype=np.uint32)
    limbs[:, n // 3 : 2 * n // 3] = np.uint32(0xFFFFFFFF)
    limbs[:, 2 * n // 3 :] = 0
    gate = np.where(rng.integers(0, 2, size=n) == 1, np.uint32(0xFFFFFFFF), np.uint32(0))
    corr = rng.integers(0, 2**32, size=lpe, dtype=np.uint32)
    corr[0] = 1  # + 1 carries through ~0 limbs
    port_rows = [words(r) for r in limbs]
    jax_rows = [jnp.asarray(r) for r in limbs]

    def same(got, want):
        return all(np.array_equal(aes_torch.from_words(g), np.asarray(w)) for g, w in zip(got, want))

    for party in (0, 1):
        for xor_group in (False, True):
            got = value_codec.rows_correct_element(
                port_rows, words(gate), [int(c) for c in corr.view(np.int32)],
                bits, party, xor_group,
            )
            want = jax_value_codec.rows_correct_element(
                jax_rows, jnp.asarray(gate), [jnp.uint32(c) for c in corr], bits, party,
                xor_group,
            )
            assert same(got, want), (party, xor_group)
    assert same(value_codec.rows_limb_add(port_rows, port_rows[::-1], bits),
                jax_value_codec.rows_limb_add(jax_rows, jax_rows[::-1], bits))
    assert same(value_codec.rows_limb_neg(port_rows, bits),
                jax_value_codec.rows_limb_neg(jax_rows, bits))
    for fn in (value_codec.rows_limb_neg, lambda r, b: value_codec.rows_limb_add(r, r, b)):
        with pytest.raises(NotImplementedError, match="32-bit-multiple"):
            fn(port_rows, 16)


def test_transpose32_rows_matches_unpack_and_jax():
    """The in-register transpose: per limb l, row j at word w of the
    transposed plane rows [32 l, 32 l + 32) is limb l of block 32 w + j, as
    unpack_from_planes gives it and as the JAX package's row transpose
    computes it."""
    w = 3
    planes = np.random.default_rng(32).integers(0, 2**32, size=(128, w), dtype=np.uint32)
    blocks = aes_torch.from_words(aes_torch.unpack_from_planes(words(planes)))  # [32 w, 4]
    for l in range(4):
        got = aes_torch.from_words(aes_torch.transpose32_rows(words(planes[32 * l : 32 * l + 32])))
        assert np.array_equal(got, blocks[:, l].reshape(w, 32).T)
        want = aes_pallas._transpose32_rows([jnp.asarray(planes[32 * l + i]) for i in range(32)])
        assert np.array_equal(got, np.stack([np.asarray(r) for r in want]))


def _replay_case(name):
    """(JAX DPF, keys of one party, bits, party, xor_group, budget, with a
    database) of K5's replay test, at log-domain 8 with two slabs."""
    rng = np.random.default_rng(8)
    seeds = rng.integers(0, 2**32, size=(2, 2, 4), dtype=np.uint32)
    if name.startswith("int64"):
        dpf = JaxDpf.create(JaxParams(8, JaxInt(64)))
        party = int(name[-1])
        keys = dpf.generate_keys_batch([3, 201], [[5, 2**64 - 9]], seeds=seeds)[party]
        # party 0: phase A and phase B one level each; party 1: both
        # levels in phase A
        return dpf, keys, 64, party, False, (8192 if party == 0 else 12288), False
    dpf = JaxDpf.create(JaxParams(8, JaxXor(128)))
    keys = dpf.generate_keys_batch([9, 250], [[2**128 - 1] * 2], seeds=seeds)[1]
    return dpf, keys, 128, 1, True, 16384, True


@pytest.mark.parametrize("name", ["int64-party0", "int64-party1", "xor128-db"])
def test_megakernel_plain_version_matches_jax_replay(name):
    """K5's plain version, reduced to [K, lpe], equals the JAX package's
    eager megakernel replay for the chunk's first key, on the same chunk
    inputs built by the JAX package (as its megakernel tests build them)."""
    dpf, keys, bits, party, xor_group, budget, with_db = _replay_case(name)
    plan = jax_ev.plan_megakernel(dpf, vmem_budget=budget)
    assert plan.num_slabs >= 2
    lds = dpf.validator.parameters[-1].log_domain_size
    keep = 1 << (lds - dpf.validator.hierarchy_to_tree[-1])
    batch = jax_ev.KeyBatch.from_keys(dpf, keys)
    ch = jax_ev._prepare_chunk(batch, len(keys), 5, True, bits)
    planes, control = jax_ev._pack_batch_jit(ch.seeds, ch.control_mask)
    inputs = [np.array(a) for a in (planes, control, ch.cw, ch.ccl, ch.ccr, ch.corr)]
    db = None
    if with_db:
        natural = np.random.default_rng(1).integers(0, 2**32, size=(1 << lds, 4), dtype=np.uint32)
        db = jax_ev.megakernel_db_rows(dpf, natural, plan)
    port_plan = evaluator.MegakernelPlan(*plan)
    got = backend_torch.xor_reduce(backend_torch.megakernel_fold(
        *map(words, inputs), None if db is None else words(db), plan=port_plan,
        bits=bits, party=party, xor_group=xor_group, keep=keep,
    ), dim=2)
    with jax.disable_jit():
        want = aes_pallas.megakernel_reference_rows(
            *[jnp.asarray(a[0]) for a in inputs], None if db is None else jnp.asarray(db),
            plan=plan, bits=bits, party=party, xor_group=xor_group, keep=keep,
        )
    assert np.array_equal(aes_torch.from_words(got)[0], np.asarray(want))


def test_wrappers_take_the_plain_version_only_for_cpu_tensors():
    """On CPU tensors the wrappers (K2 and its one-key view, K4, K6, K7, K8
    and K9 among them) run the plain versions and launch nothing; operands
    they cannot take are refused before any dispatch."""
    aes_cuda.reset_launch_counts()
    args = [words(a) for a in expand_inputs(3, 1)]
    aes_cuda.expand_one_level(*args)
    aes_cuda.hash_value_planes(args[0])
    path = args[1][0]
    aes_cuda.walk_level(args[0], args[1], path, *args[2:])
    ops, _ = walk_inputs(2, 1, 64, 2, seed=1)
    aes_cuda.walk_megakernel(*map(words, ops), bits=64, party=1, xor_group=False, keep=2)
    hier = hier_cases.window_case("int64, a later window", device="cpu", carry=False)
    aes_cuda.hier_megakernel(*hier["args"], **hier["kw"])
    aes_cuda.expand_one_level_single(*[a[0] for a in args])
    kops = list(map(words, keygen_inputs(2, 1, seed=1)))
    aes_cuda.keygen_megakernel(*kops, captures=(True, False, True))
    assert [k.launches for k in aes_cuda.KERNELS] == [0] * len(aes_cuda.KERNELS)
    with pytest.raises(InvalidArgumentError, match="last depth"):
        aes_cuda.keygen_megakernel(*kops, captures=(True, True, False))
    with pytest.raises(InvalidArgumentError, match="tree levels"):
        aes_cuda.keygen_megakernel(*kops[:2], kops[2][:0], captures=(True,))
    with pytest.raises(InvalidArgumentError, match="planes1"):
        aes_cuda.keygen_megakernel(kops[0], kops[1][:, :0], kops[2], captures=(True, False, True))
    with pytest.raises(InvalidArgumentError, match="one word"):
        aes_cuda.expand_one_level_single(*[a[0] for a in args[:3]], args[3], args[4][0])
    with pytest.raises(InvalidArgumentError, match="int32"):
        aes_cuda.hash_value_planes(args[0].to(torch.int64))
    with pytest.raises(InvalidArgumentError, match="shape"):
        aes_cuda.expand_one_level(args[0], args[1][:, :2], *args[2:])
    with pytest.raises(InvalidArgumentError, match="one CUDA device"):
        aes_cuda.hash_value_planes(torch.empty((1, 128, 1), dtype=torch.int32, device="meta"))
    with pytest.raises(InvalidArgumentError, match="one CUDA device"):
        aes_cuda.expand_one_level(args[0].to("meta"), *args[1:])
    with pytest.raises(InvalidArgumentError, match="path_mask"):
        aes_cuda.walk_level(args[0], args[1], path[:0], *args[2:])
    with pytest.raises(InvalidArgumentError, match="sel_bits"):
        aes_cuda.walk_megakernel(*map(words, ops[:6]), words(ops[6][:1]), bits=64, party=1,
                                 xor_group=False, keep=2)
    segs = hier["kw"]["segments"]
    for bad, match in (((segs[0], segs[2]) + segs[3:], "does not follow"),
                       (segs[:-1], "depth"), (((1,) + segs[0][1:],) + segs[1:], "does not follow")):
        with pytest.raises(InvalidArgumentError, match=match):
            aes_cuda.hier_megakernel(*hier["args"], **dict(hier["kw"], segments=bad))
    with pytest.raises(InvalidArgumentError, match="exit"):
        aes_cuda.hier_megakernel(*hier["args"], **dict(hier["kw"], state_cap=segs[-1][1] - 1))


def test_round_key_header_holds_the_plain_versions_tables():
    """The constant-memory tables the kernels are built with are the round
    keys the plain version uses."""
    nums = re.findall(r"0xffffffffu|0u", aes_cuda.round_key_header().split("{", 1)[1])
    got = np.array([0xFFFFFFFF if n != "0u" else 0 for n in nums], np.uint32)
    want = np.stack(
        [backend_torch._rk_np(t) for t in ("left", "right", "value")]
    ).reshape(-1)
    assert np.array_equal(got, want)


def test_parse_ptxas_reads_registers_spills_and_stack_frame():
    """The ptxas report that chip_smoke.py prints for each kernel: its
    registers, spill bytes and stack frame, per entry function."""
    log = (
        "ptxas info    : Compiling entry function '_Z3k2v' for 'sm_90a'\n"
        "ptxas info    : Function properties for _Z3k2v\n"
        "    16 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads\n"
        "ptxas info    : Used 128 registers, used 0 barriers\n"
        "ptxas info    : Compiling entry function '_Z3k4v' for 'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 255 registers\n"
    )
    assert aes_cuda._parse_ptxas(log) == {
        "_Z3k2v": {"stack_frame": 16, "spill_stores": 8, "spill_loads": 12, "registers": 128},
        "_Z3k4v": {"stack_frame": 0, "spill_stores": 0, "spill_loads": 0, "registers": 255},
    }


_HARNESS = r"""
#include <cstdio>
#include <vector>
#include "expand_rows.cuh"
#include "megakernel_rows.cuh"
#include "walk_rows.cuh"
#include "walk_quad.cuh"
#include "hier_rows.cuh"
#include "keygen_rows.cuh"
// stdin: mode K W, then the operands; stdout: the outputs.
static std::vector<uint32_t> rd(size_t n) {
  std::vector<uint32_t> v(n);
  if (fread(v.data(), 4, n, stdin) != n) throw 1;
  return v;
}
// K5 (mode 3): 14 ints (the plan's levels_a, levels_b, entry, mid, slab,
// final, fold, slabs; lpe, keep, party, xor_group, use_db, blocks_per_key),
// the operands; every (key, block) runs as one host thread holding the four
// columns of each word (dpf::QuadHost).
static int megakernel(int K) {
  int f[14];
  if (fread(f, 4, 14, stdin) != 14) return 1;
  dpf::MegakernelArgs a{};
  a.levels_a = f[0]; a.levels_b = f[1]; a.entry_words = f[2]; a.mid_words = f[3];
  a.slab_words = f[4]; a.final_words = f[5]; a.fold_words = f[6]; a.num_slabs = f[7];
  a.lpe = f[8]; a.keep = f[9]; a.party = f[10]; a.xor_group = f[11];
  a.blocks_per_key = f[13];
  const int L = a.levels_a + a.levels_b;
  auto planes = rd(size_t(K) * 128 * a.entry_words), control = rd(size_t(K) * a.entry_words);
  auto cw = rd(size_t(K) * L * 128), ccl = rd(size_t(K) * L), ccr = rd(size_t(K) * L);
  auto corr = rd(size_t(K) * 4);
  std::vector<uint32_t> db;
  if (f[12]) db = rd(size_t(a.keep) * a.lpe * 32 * a.num_slabs * a.final_words);
  std::vector<uint32_t> out(size_t(K) * a.lpe * a.fold_words);  // zeroed, as the wrapper's
  a.workspace_words = 129 * (a.mid_words + a.mid_words / 2);
  // Every workspace word starts as junk, as torch.empty leaves it on the card.
  std::vector<uint32_t> ws(size_t(K) * a.blocks_per_key * a.workspace_words, 0xA5A5A5A5u);
  std::vector<uint32_t> smem(dpf::megakernel_smem_words(a), 0xA5A5A5A5u);
  a.planes = planes.data(); a.control = control.data(); a.cw = cw.data();
  a.ccl = ccl.data(); a.ccr = ccr.data(); a.corr = corr.data();
  a.db = f[12] ? db.data() : nullptr; a.out = out.data(); a.workspace = ws.data();
  for (int k = 0; k < K; ++k)
    for (int b = 0; b < a.blocks_per_key; ++b)
      dpf::megakernel_block(a, k, b, dpf::QuadHost{}, 0, 1, smem.data());
  fwrite(out.data(), 4, out.size(), stdout);
  return 0;
}
// The value correction (mode 4): lpe party xor_group, then N blocks of 4
// hash limbs, N gate masks and 4 correction limbs (N a multiple of 32);
// out: the limbs corrected per block by correct_block (K7, K8), then by
// K5's column form correct_limbs_quad on groups of 32 blocks.
static int correction(int N) {
  int f[3];
  if (fread(f, 4, 3, stdin) != 3) return 1;
  auto v = rd(size_t(N) * 4), m = rd(N), corr = rd(4);
  std::vector<uint32_t> quad(v);
  for (int n = 0; n < N; ++n) dpf::correct_block(&v[4 * n], corr.data(), m[n], f[0], f[1], f[2]);
  for (int g = 0; g < N / 32; ++g) {
    uint32_t cols[4][32], ctrl = 0u;
    for (int i = 0; i < 32; ++i) {
      for (int c = 0; c < 4; ++c) cols[c][i] = quad[4 * (32 * g + i) + c];
      ctrl |= (m[32 * g + i] & 1u) << i;
    }
    dpf::correct_limbs_quad(cols, dpf::QuadHost{}, ctrl, corr.data(), f[0], f[1], f[2]);
    for (int i = 0; i < 32; ++i)
      for (int c = 0; c < 4; ++c) quad[4 * (32 * g + i) + c] = cols[c][i];
  }
  fwrite(v.data(), 4, v.size(), stdout);
  fwrite(quad.data(), 4, quad.size(), stdout);
  return 0;
}
// K5's column-split MMO hash (mode 11): planes; out: for each key table
// (left, right, value) K1's mmo_hash_rows, then aes_quad.cuh's
// mmo_hash_quad on the same words.
static int quad_hash(int K, int W) {
  uint32_t stash[128], s[128], cols[4][32];
  auto planes = rd(size_t(K) * 128 * W);
  std::vector<uint32_t> rows(planes.size()), quad(planes.size());
  for (int t = 0; t < 3; ++t) {
    for (int k = 0; k < K; ++k)
      for (int w = 0; w < W; ++w) {
        for (int p = 0; p < 128; ++p) s[p] = cols[p / 32][p % 32] = planes[(size_t(k) * 128 + p) * W + w];
        dpf::mmo_hash_rows(s, t, stash, 1);
        dpf::mmo_hash_quad(cols, dpf::QuadHost{}, t);
        for (int p = 0; p < 128; ++p) {
          rows[(size_t(k) * 128 + p) * W + w] = s[p];
          quad[(size_t(k) * 128 + p) * W + w] = cols[p / 32][p % 32];
        }
      }
    fwrite(rows.data(), 4, rows.size(), stdout);
    fwrite(quad.data(), 4, quad.size(), stdout);
  }
  return 0;
}
// K6 (mode 5): planes, control, path [W], cw, ccl, ccr; out: planes, control.
// Every (key, word) item runs its four column threads in lockstep
// (dpf::QuadHost); the outputs start as junk, as torch.empty leaves them.
static int walk_level(int K, int W) {
  auto planes = rd(size_t(K) * 128 * W), control = rd(size_t(K) * W), path = rd(W);
  auto cw = rd(size_t(K) * 128), ccl = rd(K), ccr = rd(K);
  std::vector<uint32_t> op(planes.size(), 0xA5A5A5A5u), oc(control.size(), 0xA5A5A5A5u);
  for (int64_t item = 0; item < int64_t(K) * W; ++item)
    dpf::walk_level_item_quad(planes.data(), control.data(), path.data(), cw.data(), ccl.data(),
                              ccr.data(), op.data(), oc.data(), item, W, dpf::QuadHost{}, true);
  fwrite(op.data(), 4, op.size(), stdout);
  fwrite(oc.data(), 4, oc.size(), stdout);
  return 0;
}
// K7 (mode 6): 5 ints (levels, lpe, keep, party, xor_group), the operands;
// out: the value rows. Every (key, word) item runs its four column threads
// in lockstep (dpf::QuadHost).
static int walk_megakernel(int K, int W) {
  int f[5];
  if (fread(f, 4, 5, stdin) != 5) return 1;
  dpf::WalkMegakernelArgs a{};
  a.levels = f[0]; a.words = W; a.lpe = f[1]; a.keep = f[2]; a.party = f[3]; a.xor_group = f[4];
  const int L = a.levels;
  auto seed = rd(size_t(K) * 128), path = rd(size_t(L) * W), cw = rd(size_t(K) * L * 128);
  auto ccl = rd(size_t(K) * L), ccr = rd(size_t(K) * L), corr = rd(size_t(K) * 4);
  auto sel = rd(size_t(a.keep) * W);
  // Every output starts as junk, as torch.empty leaves it on the card.
  std::vector<uint32_t> out(size_t(K) * a.lpe * 32 * W, 0xA5A5A5A5u);
  a.seed_planes = seed.data(); a.path = path.data(); a.cw = cw.data(); a.ccl = ccl.data();
  a.ccr = ccr.data(); a.corr = corr.data(); a.sel = sel.data(); a.out = out.data();
  for (int64_t item = 0; item < int64_t(K) * W; ++item)
    dpf::walk_megakernel_item_quad(a, item, dpf::QuadHost{}, true);
  fwrite(out.data(), 4, out.size(), stdout);
  return 0;
}
// K7's DCF form (mode 8): 5 ints (levels, lpe, keep, party, xor_group), the
// 4 words of the captures bitmask, the operands (corrections and select rows
// (levels + 1) * keep); out: the value rows. Items as in mode 6.
static int walk_dcf(int K, int W) {
  int f[5];
  if (fread(f, 4, 5, stdin) != 5) return 1;
  auto caps = rd(4);
  dpf::WalkMegakernelArgs a{};
  a.levels = f[0]; a.words = W; a.lpe = f[1]; a.keep = f[2]; a.party = f[3]; a.xor_group = f[4];
  for (int i = 0; i < 4; ++i) a.captures[i] = caps[i];
  const int L = a.levels, rows = (L + 1) * a.keep;
  auto seed = rd(size_t(K) * 128), path = rd(size_t(L) * W), cw = rd(size_t(K) * L * 128);
  auto ccl = rd(size_t(K) * L), ccr = rd(size_t(K) * L), corr = rd(size_t(K) * rows * a.lpe);
  auto sel = rd(size_t(rows) * W);
  std::vector<uint32_t> out(size_t(K) * a.lpe * 32 * W, 0xA5A5A5A5u);
  a.seed_planes = seed.data(); a.path = path.data(); a.cw = cw.data(); a.ccl = ccl.data();
  a.ccr = ccr.data(); a.corr = corr.data(); a.sel = sel.data(); a.out = out.data();
  for (int64_t item = 0; item < int64_t(K) * W; ++item)
    dpf::walk_megakernel_dcf_item_quad(a, item, dpf::QuadHost{}, true);
  fwrite(out.data(), 4, out.size(), stdout);
  return 0;
}
// K8 (mode 9): 8 ints (levels, lpe, keep, party, xor_group, entry lanes,
// exit lanes, segments G), G (base, lanes, depth) triples, the operands;
// the whole grid runs as one thread. Out: the value rows, the exit seeds
// and the exit control.
static int hier(int K, int W) {
  int f[8];
  if (fread(f, 4, 8, stdin) != 8) return 1;
  dpf::HierMegakernelArgs a{};
  a.levels = f[0]; a.words = W; a.lpe = f[1]; a.keep = f[2]; a.party = f[3];
  a.xor_group = f[4]; a.entry_lanes = f[5]; a.exit_lanes = f[6]; a.segments = f[7];
  a.n_rows = a.segments * a.keep;
  auto segs = rd(size_t(3) * a.segments);
  for (int t = 0; t < a.segments; ++t) {
    a.seg_base[t] = static_cast<int32_t>(segs[3 * t]);
    a.seg_lanes[t] = static_cast<int32_t>(segs[3 * t + 1]);
    a.seg_depth[t] = static_cast<int32_t>(segs[3 * t + 2]);
  }
  const int L = a.levels;
  const size_t M = a.entry_lanes, X = a.exit_lanes;
  auto seeds = rd(K * M * 4), control = rd(K * M), parent = rd(size_t(32) * W);
  auto path = rd(size_t(L) * W), cw = rd(size_t(K) * L * 128), ccl = rd(size_t(K) * L);
  auto ccr = rd(size_t(K) * L), corr = rd(size_t(K) * a.n_rows * a.lpe);
  auto sel = rd(size_t(a.n_rows) * W);
  const size_t scratch = a.seg_base[a.segments - 1] + 1;
  // Every output starts as garbage, as torch.empty leaves it on the card.
  const uint32_t junk = 0xA5A5A5A5u;
  std::vector<uint32_t> out(size_t(K) * a.keep * a.lpe * 32 * W, junk), ss(K * scratch * 4, junk),
      sc(K * scratch, junk), xs(K * X * 4, junk), xc(K * X, junk);
  a.entry_seeds = seeds.data(); a.entry_control = control.data();
  a.parent = reinterpret_cast<const int32_t*>(parent.data()); a.path = path.data();
  a.cw = cw.data(); a.ccl = ccl.data(); a.ccr = ccr.data(); a.corr = corr.data();
  a.sel = sel.data(); a.out = out.data(); a.state_seeds = ss.data(); a.state_control = sc.data();
  a.exit_seeds = xs.data(); a.exit_control = xc.data();
  uint32_t stash[128];
  dpf::hier_megakernel_grid(a, K, 0, 1, stash, 1);
  for (auto* v : {&out, &xs, &xc}) fwrite(v->data(), 4, v->size(), stdout);
  return 0;
}
// K9 (mode 10): levels, the 5 words of the captures bitmask, planes0,
// planes1, path [levels, W]; out: cw, cc, vh, ctrl. Each word runs its 16
// threads (4 items x 4 columns) in lockstep (dpf::KeygenHost).
static int keygen(int W) {
  int levels;
  if (fread(&levels, 4, 1, stdin) != 1) return 1;
  auto caps = rd(5);
  dpf::KeygenMegakernelArgs a{};
  a.levels = levels; a.words = W;
  for (int i = 0; i < 5; ++i) a.captures[i] = caps[i];
  for (int d = 0; d <= levels; ++d) a.slots += (caps[d >> 5] >> (d & 31)) & 1;
  auto p0 = rd(size_t(128) * W), p1 = rd(size_t(128) * W), path = rd(size_t(levels) * W);
  const uint32_t junk = 0xA5A5A5A5u;  // as torch.empty leaves the outputs on the card
  std::vector<uint32_t> cw(size_t(levels) * 128 * W, junk), cc(size_t(levels) * 2 * W, junk),
      vh(size_t(a.slots) * 256 * W, junk), ctrl(size_t(a.slots) * W, junk);
  a.planes0 = p0.data(); a.planes1 = p1.data(); a.path = path.data(); a.cw = cw.data();
  a.cc = cc.data(); a.vh = vh.data(); a.ctrl = ctrl.data();
  for (int w = 0; w < W; ++w) dpf::keygen_word_quad(a, w, dpf::KeygenHost{}, true);
  for (auto* v : {&cw, &cc, &vh, &ctrl}) fwrite(v->data(), 4, v->size(), stdout);
  return 0;
}
// K1's masked form (mode 7): planes, mask [W]; out: the hashed planes by
// K1's row form (mmo_hash_rows_masked), then by the column form
// (aes_quad.cuh QuadMaskedKey, K7's) on the same words.
static int masked_hash(int K, int W) {
  uint32_t stash[128], s[128], cols[4][32];
  auto planes = rd(size_t(K) * 128 * W), mask = rd(W);
  std::vector<uint32_t> rows(planes.size()), quad(planes.size());
  for (int k = 0; k < K; ++k)
    for (int w = 0; w < W; ++w) {
      for (int p = 0; p < 128; ++p) s[p] = cols[p / 32][p % 32] = planes[(size_t(k) * 128 + p) * W + w];
      dpf::mmo_hash_rows_masked(s, mask[w], stash, 1);
      dpf::mmo_hash_quad_with(cols, dpf::QuadHost{}, dpf::QuadMaskedKey{mask[w]});
      for (int p = 0; p < 128; ++p) {
        rows[(size_t(k) * 128 + p) * W + w] = s[p];
        quad[(size_t(k) * 128 + p) * W + w] = cols[p / 32][p % 32];
      }
    }
  fwrite(rows.data(), 4, rows.size(), stdout);
  fwrite(quad.data(), 4, quad.size(), stdout);
  return 0;
}
// sbox_byte (mode 12): W lane words of 8 bit-planes, [8][W]; out: the same
// after SubBytes.
static int sbox(int W) {
  auto planes = rd(size_t(8) * W);
  for (int w = 0; w < W; ++w) {
    uint32_t b[8];
    for (int i = 0; i < 8; ++i) b[i] = planes[size_t(i) * W + w];
    dpf::sbox_byte(b);
    for (int i = 0; i < 8; ++i) planes[size_t(i) * W + w] = b[i];
  }
  fwrite(planes.data(), 4, planes.size(), stdout);
  return 0;
}
// mix_column (mode 13): N columns of 32 words, then N round keys of 32
// words; out: each column after MixColumns and AddRoundKey.
static int mix(int N) {
  auto cols = rd(size_t(N) * 32), keys = rd(size_t(N) * 32);
  for (int n = 0; n < N; ++n) dpf::mix_column(&cols[32 * size_t(n)], &keys[32 * size_t(n)]);
  fwrite(cols.data(), 4, cols.size(), stdout);
  return 0;
}
int main() {
  int hdr[3];
  if (fread(hdr, 4, 3, stdin) != 3) return 1;
  const int mode = hdr[0], K = hdr[1], W = hdr[2];
  if (mode == 3) return megakernel(K);
  if (mode == 4) return correction(K);
  if (mode == 5) return walk_level(K, W);
  if (mode == 6) return walk_megakernel(K, W);
  if (mode == 7) return masked_hash(K, W);
  if (mode == 8) return walk_dcf(K, W);
  if (mode == 9) return hier(K, W);
  if (mode == 10) return keygen(W);
  if (mode == 11) return quad_hash(K, W);
  if (mode == 12) return sbox(W);
  if (mode == 13) return mix(K);
  auto planes = rd(size_t(K) * 128 * W);
  // K4 (mode 2): every (key, word) item, its four column threads in
  // lockstep (dpf::QuadHost), into junk.
  if (mode == 2) {
    std::vector<uint32_t> out(planes.size(), 0xA5A5A5A5u);
    for (int64_t item = 0; item < int64_t(K) * W; ++item)
      dpf::value_hash_item_quad(planes.data(), out.data(), item, W, dpf::QuadHost{}, true);
    fwrite(out.data(), 4, out.size(), stdout);
    return 0;
  }
  auto control = rd(size_t(K) * W), cw = rd(size_t(K) * 128), ccl = rd(K), ccr = rd(K);
  // Every output starts as junk, as torch.empty leaves it on the card.
  std::vector<uint32_t> op(size_t(K) * 256 * W, 0xA5A5A5A5u), oc(size_t(K) * 2 * W, 0xA5A5A5A5u);
  // K2 (mode 0) and K3 (mode 1): every (key, child, word) item, the four
  // column threads of its word in lockstep (dpf::QuadHost).
  for (int64_t item = 0; item < int64_t(K) * 2 * W; ++item) {
    if (mode == 0)
      dpf::expand_item_quad<false>(planes.data(), control.data(), cw.data(), ccl.data(),
                                   ccr.data(), op.data(), oc.data(), item, W, dpf::QuadHost{},
                                   true);
    else
      dpf::expand_item_quad<true>(planes.data(), control.data(), cw.data(), ccl.data(),
                                  ccr.data(), op.data(), oc.data(), item, W, dpf::QuadHost{},
                                  true);
  }
  fwrite(op.data(), 4, op.size(), stdout);
  fwrite(oc.data(), 4, oc.size(), stdout);
}
"""


def megakernel_cases():
    """(plan, bits, party, xor_group, keep, with a database) of K5's host
    test: no phase-A level, no phase-B level (fold width 1), one and both
    phase-B buffers, an entry tile of two words, every limb layout (Int(32)
    keeps four elements a block, Int(64) two, XorWrapper(128) one), fewer
    kept elements than a block holds, both parties and the database AND."""
    def plan(lds, vt, budget, host_levels=None):
        dpf = port.DistributedPointFunction.create(port.DpfParameters(lds, vt))
        return evaluator.plan_megakernel(dpf, host_levels=host_levels, budget=budget)

    return [
        (plan(9, port.Int(64), 8192, host_levels=7), 64, 1, False, 2, True),
        (plan(12, port.Int(64), 4096), 64, 0, False, 2, False),
        (plan(12, port.Int(32), 16384, host_levels=6), 32, 1, False, 4, True),
        (plan(12, port.XorWrapper(128), 65536), 128, 0, True, 1, True),
        # Two of a block's four Int(32) elements kept, as a domain smaller
        # than its blocks would.
        (plan(12, port.Int(32), 8192), 32, 0, False, 2, False),
        # Four limbs an element with carries and the database (the PIR
        # layout without the XOR group), and one of Int(64)'s two elements.
        (plan(12, port.Int(128), 16384), 128, 1, False, 1, True),
        (plan(12, port.Int(64), 16384), 64, 1, False, 1, False),
    ]


def run_megakernel_case(exe, case, seed, blocks_per_key=1):
    """K5's body on the host (harness mode 3) and its plain version, for
    `case` of ``megakernel_cases``: (got, want) as uint32[K, lpe, fold]."""
    plan, bits, party, xor_group, keep, with_db = case
    ops = megakernel_inputs(plan, bits, keep, with_db, seed=seed)
    fields = [plan.levels_a, plan.levels_b, plan.entry_words, plan.mid_words,
              plan.slab_words, plan.final_words, plan.fold_words, plan.num_slabs,
              bits // 32, keep, party, int(xor_group), int(with_db), blocks_per_key]
    out = run_harness(exe, [3, K, 0] + fields, *[a for a in ops if a is not None])
    want = backend_torch.megakernel_fold(
        *[None if a is None else words(a) for a in ops], plan=plan, bits=bits,
        party=party, xor_group=xor_group, keep=keep,
    )
    return out.reshape(K, bits // 32, plan.fold_words), aes_torch.from_words(want)


def megakernel_inputs(plan, bits, keep, with_db, seed):
    """uint32 numpy operands of K5 for K keys under `plan`."""
    rng = np.random.default_rng(seed)
    levels = plan.levels_a + plan.levels_b
    lpe = bits // 32

    def r(*shape):
        return rng.integers(0, 2**32, size=shape, dtype=np.uint32)

    db = r(keep * lpe * 32, plan.num_slabs * plan.final_words) if with_db else None
    return (r(K, 128, plan.entry_words), r(K, plan.entry_words), r(K, levels, 128),
            r(K, levels), r(K, levels), r(K, 128 // bits, lpe), db)


@pytest.fixture(scope="module")
def host_harness(tmp_path_factory):
    """_HARNESS and the csrc/ headers built with g++, once for the module."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ on this host")
    tmp_path = tmp_path_factory.mktemp("csrc")
    aes_cuda.write_key_headers(tmp_path)
    (tmp_path / "harness.cpp").write_text(_HARNESS)
    exe = tmp_path / "harness"
    subprocess.run(
        [gxx, "-O1", "-std=c++17", "-Wno-unknown-pragmas", "-I", str(tmp_path),
         "-I", str(aes_cuda.CSRC), "-o", str(exe), str(tmp_path / "harness.cpp")],
        check=True, capture_output=True, timeout=300,
    )
    return exe


def run_harness(exe, header, *arrays) -> np.ndarray:
    """The harness's output words for int32 `header` and uint32 operands."""
    out = subprocess.run(
        [str(exe)],
        input=np.asarray(header, np.int32).tobytes() + b"".join(a.tobytes() for a in arrays),
        check=True, capture_output=True, timeout=60,
    ).stdout
    return np.frombuffer(out, np.uint32)


def test_csrc_kernel_bodies_on_the_host_compiler(host_harness):
    """csrc/expand_rows.cuh — K2's and K3's column bodies (run over every
    (key, child, word) item, the four column threads of a word in lockstep
    by ``QuadHost``) and K4's column body (over every (key, word) item,
    likewise) — built with g++ equal the plain versions, ragged width
    included; and
    csrc/megakernel_rows.cuh, K5's per-key body (phase A, phase B, the
    tail's transpose, correction, database AND and fold), run as a block of
    one thread per key, equals K5's plain version on each plan of
    ``megakernel_cases``."""
    exe = host_harness
    w = WIDTHS[0]
    planes, control, cw, ccl, ccr = expand_inputs(w, 7)

    def run(mode, *arrays):
        return run_harness(exe, [mode, K, w], *arrays)

    plain = {
        0: backend_torch.expand_one_level,
        1: backend_torch.expand_and_hash_last_level,
    }
    for mode, fn in plain.items():
        out = run(mode, planes, control, cw, ccl, ccr)
        want_p, want_c = fn(*map(words, (planes, control, cw, ccl, ccr)))
        n = K * 128 * 2 * w
        assert np.array_equal(out[:n].reshape(K, 128, 2 * w), aes_torch.from_words(want_p))
        assert np.array_equal(out[n:].reshape(K, 2 * w), aes_torch.from_words(want_c))
    out = run(2, planes)
    want = aes_torch.from_words(backend_torch.hash_value_planes(words(planes)))
    assert np.array_equal(out.reshape(K, 128, w), want)

    for i, case in enumerate(megakernel_cases()):
        got, want = run_megakernel_case(exe, case, seed=i)
        assert np.array_equal(got, want), case[0]

    # The correction alone, on limbs whose carries a random hash almost never
    # produces: sums that wrap to exactly 0 (a carry out of every limb),
    # limbs at ~corr (a carry in makes them wrap: limb + corr = ~0, + 1), and
    # limbs of 0 or ~0.
    rng = np.random.default_rng(5)
    n = 64
    corr = rng.integers(0, 2**32, size=4, dtype=np.uint32)
    limbs = np.where(rng.integers(0, 2, size=(n, 4)) == 1, np.uint32(0xFFFFFFFF), np.uint32(0))
    limbs[: n // 2] = (-corr.astype(np.int64) % 2**32).astype(np.uint32)
    limbs[n // 4 : 3 * n // 4, 1:] = ~corr[1:]
    limbs[n // 2 : 3 * n // 4, 0] = rng.integers(0, 2**32, size=n // 4, dtype=np.uint32)
    gate = np.where(rng.integers(0, 4, size=n) > 0, np.uint32(0xFFFFFFFF), np.uint32(0))
    # Both forms: correct_block per block (K7, K8) and K5's correct_limbs_quad,
    # whose carries pass between the limb threads of an element.
    for bits, party, xor_group in ((32, 0, False), (32, 1, False), (64, 0, False),
                                   (64, 1, False), (128, 0, False), (128, 1, False),
                                   (128, 0, True)):
        lpe = bits // 32
        out = run_harness(exe, [4, n, 0, lpe, party, int(xor_group)], limbs, gate, corr)
        for got in out.reshape(2, n, 4):
            for e in range(4 // lpe):
                q = slice(e * lpe, (e + 1) * lpe)
                want = value_codec.rows_correct_element(
                    [words(limbs[:, i]) for i in range(q.start, q.stop)], words(gate),
                    [int(c) for c in corr[q].view(np.int32)], bits, party, xor_group,
                )
                assert np.array_equal(
                    got[:, q], np.stack([aes_torch.from_words(w) for w in want], 1)
                ), (bits, party, xor_group)


def test_megakernel_refuses_blocks_per_key_outside_its_slabs():
    """K5's blocks a key lie in 1 .. num_slabs; any count in it leaves the
    result as it is, and one outside it is refused on CPU tensors too."""
    plan, bits, party, xor_group, keep, with_db = megakernel_cases()[2]
    ops = [None if a is None else words(a)
           for a in megakernel_inputs(plan, bits, keep, with_db, seed=0)]
    kw = dict(plan=plan, bits=bits, party=party, xor_group=xor_group, keep=keep)
    want = backend_torch.megakernel_fold(*ops, **kw)
    assert torch.equal(aes_cuda.megakernel_fold(*ops, **kw, blocks_per_key=plan.num_slabs), want)
    for bad in (0, plan.num_slabs + 1):
        with pytest.raises(InvalidArgumentError, match="blocks_per_key"):
            aes_cuda.megakernel_fold(*ops, **kw, blocks_per_key=bad)


@pytest.mark.parametrize("case", [1, 2, 3, 5])
def test_csrc_megakernel_body_split_over_blocks(host_harness, case):
    """K5's body with a key's slabs split over several blocks, each
    expanding only the phase-A words its slabs descend from in its own
    workspace row and XORing its fold into the key's output: the slab
    counts do not divide by the blocks (ragged ranges), and the last split
    gives every slab its own block. Equal to the plain version."""
    plan = megakernel_cases()[case][0]
    for blocks in sorted({min(3, plan.num_slabs), plan.num_slabs}):
        got, want = run_megakernel_case(host_harness, megakernel_cases()[case], seed=case,
                                        blocks_per_key=blocks)
        assert np.array_equal(got, want), (plan, blocks)


def test_csrc_quad_hash_matches_k1_and_the_plain_version(host_harness):
    """aes_quad.cuh's column-split MMO hash (K5's core), the four column
    threads of each word run in lockstep on the host, equals K1's
    ``mmo_hash_rows`` and the plain version ``aes_torch.hash_planes`` under
    all three key schedules, on a ragged width."""
    w = WIDTHS[0]
    planes = expand_inputs(w, 11)[0]
    out = run_harness(host_harness, [11, K, w], planes).reshape(3, 2, K, 128, w)
    for t, table in enumerate(("left", "right", "value")):
        want = aes_torch.from_words(aes_torch.hash_planes(words(planes), backend_torch._rk_np(table)))
        assert np.array_equal(out[t, 0], want), table
        assert np.array_equal(out[t, 1], want), table


@pytest.mark.parametrize("w", [1, 3, 9, 40])
def test_csrc_column_expand_bodies_match_plain_versions(host_harness, w):
    """K2's and K3's column bodies (expand_rows.cuh ``expand_item_quad``,
    the four column threads of each word run in lockstep by ``QuadHost``)
    over every (key, child, word) item of K keys equal the plain versions,
    both children: one word, ragged widths, and one past a warp's eight
    items."""
    ops = expand_inputs(w, 100 + w)
    for mode, fn in ((0, backend_torch.expand_one_level),
                     (1, backend_torch.expand_and_hash_last_level)):
        out = run_harness(host_harness, [mode, K, w], *ops)
        want_p, want_c = fn(*map(words, ops))
        n = K * 128 * 2 * w
        assert np.array_equal(out[:n].reshape(K, 128, 2 * w), aes_torch.from_words(want_p)), mode
        assert np.array_equal(out[n:].reshape(K, 2 * w), aes_torch.from_words(want_c)), mode


def _lane_words(bits: np.ndarray) -> np.ndarray:
    """uint32 words of a [..., 32] 0/1 array, lane l at bit l."""
    return (bits.astype(np.uint64) << np.arange(32, dtype=np.uint64)).sum(-1).astype(np.uint32)


def _lane_bits(x: np.ndarray) -> np.ndarray:
    """The [..., 32] bits of uint32 words, lane l from bit l."""
    return ((x[..., None] >> np.arange(32, dtype=np.uint32)) & 1).astype(np.int64)


def test_csrc_sbox_byte_is_the_aes_sbox(host_harness):
    """aes_sbox.cuh's ``sbox_byte`` (the LOP3 netlist that every kernel
    runs) maps all 256 byte values, in the lanes of eight words, as the AES
    S-box of core/aes_numpy does."""
    x = np.arange(256)
    planes = np.stack([_lane_words(((x >> i) & 1).reshape(8, 32)) for i in range(8)])
    out = _lane_bits(run_harness(host_harness, [12, 1, 8], planes).reshape(8, 8))
    got = sum(out[i].reshape(256) << i for i in range(8))
    assert np.array_equal(got, np.asarray(aes_numpy.SBOX, dtype=np.int64)[x])


def _xtime(a: np.ndarray) -> np.ndarray:
    return ((a << 1) ^ np.where(a & 0x80, 0x1B, 0)) & 0xFF


def test_csrc_mix_column_matches_gf256_reference(host_harness):
    """aes_rows.cuh's ``mix_column``, MixColumns of one column then its
    round key (the one MixColumns of K1's row form and the column form), on
    random columns and keys equals MixColumns computed byte by byte in
    GF(2^8): row r becomes 2 a[r] + 3 a[r+1] + a[r+2] + a[r+3], then the
    key's byte is added."""
    n = 40
    rng = np.random.default_rng(13)
    cols, keys = rng.integers(0, 2**32, size=(2, n, 32), dtype=np.uint32)
    out = run_harness(host_harness, [13, n, 0], cols, keys).reshape(n, 32)

    def rows(x):  # [n, 4, 32 lanes] bytes of 32-word columns
        bits = _lane_bits(x).reshape(n, 4, 8, 32)
        return sum(bits[:, :, i] << i for i in range(8))

    a, k = rows(cols), rows(keys)
    want = np.empty_like(a)
    for r in range(4):
        a1, a2, a3 = (a[:, (r + d) % 4] for d in (1, 2, 3))
        want[:, r] = _xtime(a[:, r]) ^ _xtime(a1) ^ a1 ^ a2 ^ a3 ^ k[:, r]
    assert np.array_equal(rows(out), want)


def walk_inputs(levels, w, bits, keep, seed):
    """uint32 numpy operands of K7 for K keys at W words, and each point's
    block element (-1 for the last point: padding, selected by no row)."""
    rng = np.random.default_rng(seed)

    def r(*shape):
        return rng.integers(0, 2**32, size=shape, dtype=np.uint32)

    block_sel = rng.integers(0, keep, size=32 * w)
    block_sel[-1] = -1
    sel = aes_torch.pack_bit_mask(block_sel[None, :] == np.arange(keep)[:, None])
    return [backend_torch.cw_seed_planes(r(K, 4)), r(levels, w),
            backend_torch.cw_seed_planes(r(K, levels, 4)),
            backend_torch.control_masks(rng.integers(0, 2, size=(K, levels))),
            backend_torch.control_masks(rng.integers(0, 2, size=(K, levels))),
            r(K, 128 // bits, bits // 32), sel], block_sel


def carrying_corrections(ops, bits, party, block_sel):
    """Corrections under which, for each key and element, one point whose
    control bit is set sums to exactly 0 mod 2^bits: a carry out of every
    limb, and for party 1 a negation whose + 1 carries through every limb
    (a random hash almost never gives either)."""
    seed_planes, path, cw, ccl, ccr, corr, _ = map(words, ops)
    k, w, lpe = seed_planes.shape[0], path.shape[1], bits // 32
    planes = seed_planes[:, :, None].expand(k, 128, w).contiguous()
    control = torch.full((k, w), -1 if party else 0, dtype=torch.int32)
    planes, control = backend_torch.walk_levels(planes, control, path, cw, ccl, ccr)
    blocks = aes_torch.from_words(
        aes_torch.unpack_from_planes(backend_torch.hash_value_planes(planes))
    ).astype(np.uint64)  # [K, 32 W, 4]
    ctrl = aes_torch.from_words(backend_torch.unpack_mask_device(control))
    out = aes_torch.from_words(corr).copy()
    for key in range(k):
        for e in range(out.shape[1]):
            hits = np.nonzero((ctrl[key] == 1) & (block_sel == e))[0]
            if hits.size:
                value = sum(int(blocks[key, hits[0], e * lpe + l]) << (32 * l) for l in range(lpe))
                neg = -value % (1 << bits)
                out[key, e] = [(neg >> (32 * l)) & 0xFFFFFFFF for l in range(lpe)]
    return out


def dcf_walk_inputs(levels, w, bits, keep, seed):
    """uint32 numpy operands of K7's DCF form for K keys at W words: at each
    depth every point selects one element and accumulates at three depths
    in four; the last point is padding and selects nothing."""
    rng = np.random.default_rng(seed)

    def r(*shape):
        return rng.integers(0, 2**32, size=shape, dtype=np.uint32)

    rows = (levels + 1) * keep
    block_sel = rng.integers(0, keep, size=(levels + 1, 32 * w))
    block_sel[:, -1] = -1
    accumulate = rng.integers(0, 4, size=(levels + 1, 32 * w)) > 0
    sel = (block_sel[:, None, :] == np.arange(keep)[None, :, None]) & accumulate[:, None, :]
    return [backend_torch.cw_seed_planes(r(K, 4)), r(levels, w),
            backend_torch.cw_seed_planes(r(K, levels, 4)),
            backend_torch.control_masks(rng.integers(0, 2, size=(K, levels))),
            backend_torch.control_masks(rng.integers(0, 2, size=(K, levels))),
            r(K, rows, bits // 32), aes_torch.pack_bit_mask(sel.reshape(rows, 32 * w))]


def dcf_carrying_corrections(ops, bits, party, keep, captures):
    """Corrections of K7's DCF form under which, for each key and element,
    one point that the last capturing depth corrects sums to exactly 0 mod
    2^bits over the depths: the last add carries out of every limb, and
    party 1's negation of that 0 carries through every limb (its other
    points negate sums that are not 0)."""
    lpe, last = bits // 32, max(d for d, f in enumerate(captures) if f)
    kw = dict(bits=bits, party=party, xor_group=False, keep=keep, captures=captures)

    def sums(corr):  # [K, 32 W] python ints
        rows = aes_torch.from_words(backend_torch.walk_megakernel(
            *map(words, ops[:5] + [corr, ops[6]]), **kw)).astype(object)
        k, _, w = rows.shape
        limbs = rows.reshape(k, lpe, 32, w).transpose(0, 3, 2, 1).reshape(k, 32 * w, lpe)
        return sum(limbs[..., l] << (32 * l) for l in range(lpe))

    out = ops[5].copy()
    for e in range(keep):
        out[:, last * keep + e] = 0
        base = sums(out)
        probe = out.copy()
        probe[:, last * keep + e, 0] = 1
        moved = sums(probe) != base
        for key in range(out.shape[0]):
            hits = np.nonzero(moved[key])[0]
            if hits.size:
                total = base[key, hits[0]]
                total = -total if party else total  # party 1's sum comes out negated
                value = -total % (1 << bits)
                out[key, last * keep + e] = [(value >> (32 * l)) & 0xFFFFFFFF for l in range(lpe)]
    return out


def test_csrc_walk_bodies_on_the_host_compiler(host_harness):
    """csrc/walk_quad.cuh — K6's column body and K7's in both its forms,
    run over every (key, word) item with its four column threads in
    lockstep — and K1's masked hash in both forms (aes_rows.cuh
    ``mmo_hash_rows_masked``, K8's; aes_quad.cuh ``QuadMaskedKey``, K6's and
    K7's), built with g++, equal the plain versions: a ragged width, mixed path masks, both
    parties, keep 1, 2 and 4, every limb layout, the XOR group, and
    corrections whose limbs carry. The DCF form also with depths that do not
    capture, none that does, and sums that wrap to 0 before party 1's
    negation."""
    exe = host_harness
    w = WIDTHS[0]
    rng = np.random.default_rng(56)
    planes = rng.integers(0, 2**32, size=(K, 128, w), dtype=np.uint32)
    mask = rng.integers(0, 2**32, size=w, dtype=np.uint32)
    want = aes_torch.hash_planes(
        words(planes), backend_torch._rk_np("left"), backend_torch._rk_np("lr_diff"), words(mask)
    )
    got = run_harness(exe, [7, K, w], planes, mask).reshape(2, K, 128, w)
    assert np.array_equal(got[0], aes_torch.from_words(want))  # K1's row form (K8)
    assert np.array_equal(got[1], aes_torch.from_words(want))  # the column form (K6, K7)

    planes, control, cw, ccl, ccr = expand_inputs(w, 9)
    out = run_harness(exe, [5, K, w], planes, control, mask, cw, ccl, ccr)
    want_p, want_c = backend_torch.walk_level(*map(words, (planes, control, mask, cw, ccl, ccr)))
    n = K * 128 * w
    assert np.array_equal(out[:n].reshape(K, 128, w), aes_torch.from_words(want_p))
    assert np.array_equal(out[n:].reshape(K, w), aes_torch.from_words(want_c))

    for i, (levels, bits, keep, party, xor_group) in enumerate((
        (3, 32, 4, 1, False), (2, 64, 2, 0, False), (2, 64, 1, 1, False),
        (1, 128, 1, 1, True), (2, 128, 1, 1, False),
    )):
        ops, block_sel = walk_inputs(levels, w, bits, keep, seed=i)
        if not xor_group:
            ops[5] = carrying_corrections(ops, bits, party, block_sel)
        kw = dict(bits=bits, party=party, xor_group=xor_group, keep=keep)
        got = run_harness(exe, [6, K, w, levels, bits // 32, keep, party, int(xor_group)], *ops)
        want = backend_torch.walk_megakernel(*map(words, ops), **kw)
        assert np.array_equal(got.reshape(K, bits // 32 * 32, w), aes_torch.from_words(want)), kw

    for i, (bits, keep, party, xor_group, captures) in enumerate((
        (64, 2, 1, False, (True, False, True, True)), (64, 1, 0, False, (True, True, True)),
        (32, 4, 1, False, (False, True, True)), (128, 1, 1, False, (True, True)),
        (128, 1, 0, True, (True, False, True)), (64, 2, 1, False, (False, False, False)),
    )):
        levels = len(captures) - 1
        ops = dcf_walk_inputs(levels, w, bits, keep, seed=10 + i)
        if not xor_group and any(captures):
            ops[5] = dcf_carrying_corrections(ops, bits, party, keep, captures)
        kw = dict(bits=bits, party=party, xor_group=xor_group, keep=keep, captures=captures)
        words4 = np.array([sum(1 << d for d, f in enumerate(captures) if f), 0, 0, 0], np.uint32)
        got = run_harness(exe, [8, K, w, levels, bits // 32, keep, party, int(xor_group)],
                          words4, *ops)
        want = aes_torch.from_words(backend_torch.walk_megakernel(*map(words, ops), **kw))
        assert np.array_equal(got.reshape(K, bits // 32 * 32, w), want), kw
        if not any(captures):
            assert not want.any()


@pytest.mark.parametrize("w", [1, 3, 37])
@pytest.mark.parametrize("control", ["random", "whole"])
def test_csrc_column_value_hash_and_walk_level_bodies_match_plain_versions(host_harness, w,
                                                                          control):
    """K4's and K6's column bodies (expand_rows.cuh ``value_hash_item_quad``,
    walk_quad.cuh ``walk_level_item_quad``), the four column threads of each
    (key, word) item in lockstep by ``QuadHost``, equal the plain versions
    bit for bit over every item of 5 keys: K x W = 5, 15 and 185, none a
    multiple of a warp's eight items. Path masks of all zeros, all ones and
    random bits; control words random or whole (0 or ~0 by key); the keys'
    control corrections in all four (ccl, ccr) combinations and a fifth
    random pair."""
    keys = 5
    rng = np.random.default_rng(90 + w)
    planes = rng.integers(0, 2**32, size=(keys, 128, w), dtype=np.uint32)
    out = run_harness(host_harness, [2, keys, w], planes)
    want = aes_torch.from_words(backend_torch.hash_value_planes(words(planes)))
    assert np.array_equal(out.reshape(keys, 128, w), want)

    if control == "random":
        ctrl = rng.integers(0, 2**32, size=(keys, w), dtype=np.uint32)
    else:
        ctrl = np.repeat(backend_torch.control_masks(np.arange(keys) % 2)[:, None], w, 1)
    path = rng.integers(0, 2**32, size=w, dtype=np.uint32)
    path[0] = 0
    path[-1] = 0xFFFFFFFF if w > 1 else path[-1]
    cw = backend_torch.cw_seed_planes(rng.integers(0, 2**32, size=(keys, 4), dtype=np.uint32))
    ccl = backend_torch.control_masks(np.array([0, 1, 0, 1, rng.integers(0, 2)]))
    ccr = backend_torch.control_masks(np.array([0, 0, 1, 1, rng.integers(0, 2)]))
    ops = (planes, ctrl, path, cw, ccl, ccr)
    out = run_harness(host_harness, [5, keys, w], *ops)
    want_p, want_c = backend_torch.walk_level(*map(words, ops))
    n = keys * 128 * w
    assert np.array_equal(out[:n].reshape(keys, 128, w), aes_torch.from_words(want_p))
    assert np.array_equal(out[n:].reshape(keys, w), aes_torch.from_words(want_c))


@pytest.mark.parametrize("w", [1, 3, 37])
def test_csrc_quad_masked_hash_matches_k1_and_the_plain_version(host_harness, w):
    """aes_quad.cuh's column-split MMO hash under the per-lane key select
    (``QuadMaskedKey``, K7's walk hash), the four column threads of each
    word in lockstep on the host, equals K1's ``mmo_hash_rows_masked`` and
    the plain version ``aes_torch.hash_planes`` with the left key and the
    left-right difference, under masks of all zeros, all ones and random
    bits."""
    rng = np.random.default_rng(70 + w)
    planes = rng.integers(0, 2**32, size=(K, 128, w), dtype=np.uint32)
    mask = rng.integers(0, 2**32, size=w, dtype=np.uint32)
    mask[0] = 0
    mask[-1] = 0xFFFFFFFF if w > 1 else mask[-1]
    want = aes_torch.from_words(aes_torch.hash_planes(
        words(planes), backend_torch._rk_np("left"), backend_torch._rk_np("lr_diff"), words(mask)))
    got = run_harness(host_harness, [7, K, w], planes, mask).reshape(2, K, 128, w)
    assert np.array_equal(got[0], want)
    assert np.array_equal(got[1], want)


@pytest.mark.parametrize("w, levels, bits, keep, party, xor_group", [
    (1, 1, 32, 4, 0, False), (3, 5, 64, 2, 1, False), (37, 2, 128, 1, 0, False),
    (3, 3, 64, 1, 1, True), (37, 4, 32, 2, 1, False), (1, 3, 128, 1, 1, False),
])
def test_csrc_walk_column_body_matches_plain_version(host_harness, w, levels, bits, keep, party,
                                                     xor_group):
    """csrc/walk_quad.cuh, K7's EvaluateAt body on K1's column form, run
    over every (key, word) item with its four column threads in lockstep,
    equals K7's plain version: W = 1, 3 and 37 (K x W not a multiple of a
    warp's eight items), 1-5 levels, Int(32) keeping 4 and 2 elements,
    Int(64) keeping 2, Int(128), XorWrapper(64), both parties, and
    corrections whose limbs carry (and, for party 1, whose negation carries
    through every limb)."""
    ops, block_sel = walk_inputs(levels, w, bits, keep, seed=100 + levels * w)
    if not xor_group:
        ops[5] = carrying_corrections(ops, bits, party, block_sel)
    kw = dict(bits=bits, party=party, xor_group=xor_group, keep=keep)
    got = run_harness(host_harness, [6, K, w, levels, bits // 32, keep, party, int(xor_group)],
                      *ops)
    want = backend_torch.walk_megakernel(*map(words, ops), **kw)
    assert np.array_equal(got.reshape(K, bits // 32 * 32, w), aes_torch.from_words(want))


@pytest.mark.parametrize("w, bits, keep, party, xor_group, captures", [
    (1, 32, 4, 1, False, (True, False, False, True)), (3, 64, 2, 0, False, (True,) * 5),
    (37, 128, 1, 1, False, (False, False, True)), (3, 64, 1, 1, True, (True, True)),
    (37, 64, 2, 1, False, (True, False, False, False, False, True)),
    (1, 32, 2, 0, False, (False, True, False)), (3, 128, 1, 0, True, (False,) * 4),
])
def test_csrc_walk_dcf_column_body_matches_plain_version(host_harness, w, bits, keep, party,
                                                         xor_group, captures):
    """csrc/walk_quad.cuh, K7's DCF body on K1's column form, equals the
    plain version: W = 1, 3 and 37, 1-5 levels, captures at the first and
    the last depth with none between, at every depth, at the last or an
    inner one only, and at none; Int(32), Int(64), Int(128) and
    XorWrapper(64); both parties; sums that wrap to 0 before party 1's
    negation, so that the adds carry and the negation borrows through every
    limb."""
    levels = len(captures) - 1
    ops = dcf_walk_inputs(levels, w, bits, keep, seed=200 + levels * w + bits)
    if not xor_group and any(captures):
        ops[5] = dcf_carrying_corrections(ops, bits, party, keep, captures)
    kw = dict(bits=bits, party=party, xor_group=xor_group, keep=keep, captures=captures)
    mask = sum(1 << d for d, f in enumerate(captures) if f)
    words4 = np.array([mask, 0, 0, 0], np.uint32)
    got = run_harness(host_harness, [8, K, w, levels, bits // 32, keep, party, int(xor_group)],
                      words4, *ops)
    want = aes_torch.from_words(backend_torch.walk_megakernel(*map(words, ops), **kw))
    assert np.array_equal(got.reshape(K, bits // 32 * 32, w), want)


@pytest.mark.parametrize("w, captures", [
    (1, (True, True)), (3, (True, False, False, True)), (37, (False,) * 5 + (True,)),
    (3, (True,) * 4), (37, (True, False, True)),
])
def test_csrc_keygen_column_body_matches_plain_version(host_harness, w, captures):
    """csrc/keygen_rows.cuh, K9's body on K1's column form, a key word's
    four (party, branch) items of four column threads run in lockstep on the
    host, equals K9's plain version (cw, cc, vh, ctrl): W = 1, 3 and 37
    (an odd number of key words, so the card's last warp straddles), 1-5
    levels, captures at the first and the last depth with none between, at
    the last only and at every depth, lanes whose parties share a seed and
    zero seeds."""
    levels = len(captures) - 1
    ops = keygen_inputs(levels, w, seed=300 + w * levels)
    mask = sum(1 << d for d, flag in enumerate(captures) if flag)
    mask_words = np.array([(mask >> (32 * j)) & 0xFFFFFFFF for j in range(5)], np.uint32)
    got = run_harness(host_harness, [10, 1, w, levels], mask_words, *ops)
    want = [aes_torch.from_words(t) for t in
            backend_torch.keygen_megakernel(*map(words, ops), captures=captures)]
    assert got.size == sum(a.size for a in want)
    for g, a in zip(np.split(got, np.cumsum([a.size for a in want])[:-1]), want):
        assert np.array_equal(g.reshape(a.shape), a)


def test_csrc_hier_body_on_the_host_compiler(host_harness):
    """csrc/hier_rows.cuh, K8's body, built with g++ and run as a grid of
    one thread, equals K8's plain version (every value row, the exit seeds
    and the exit control) on the windows of ops/hier_cases.py:
    prefix windows of real small hierarchies with random entry states,
    Int(32) keeping 2 and 4 elements, Int(64), Int(128) and XorWrapper(128),
    both parties, a zero-level first step, steps of two and three tree
    levels, words that straddle segments, pad lanes in the exit, and
    corrections that wrap to exactly 0 at each capture, so that the add
    carries out of every limb and party 1's negation through every limb."""
    exe = host_harness
    pads = straddles = 0
    for name in hier_cases.CASES:
        case = hier_cases.window_case(name, device="cpu")
        args, kw, win = case["args"], case["kw"], case["win"]
        segs = kw["segments"]
        pads += kw["state_cap"] > segs[-1][1]
        straddles += any(seg[0] % 32 for seg in segs[1:])
        k, m = args[0].shape[:2]
        header = [9, k, win.plan.padded_words, win.depth, kw["bits"] // 32, kw["keep"],
                  kw["party"], int(kw["xor_group"]), m, kw["state_cap"], len(segs)]
        header += [x for seg in segs for x in seg[:3]]
        got = run_harness(exe, header, *(aes_torch.from_words(a) for a in args[:2] + args[3:]))
        want = [aes_torch.from_words(t) for t in aes_cuda.hier_megakernel(*args, **kw)]
        sizes = np.cumsum([a.size for a in want])[:-1]
        assert got.size == sum(a.size for a in want), name
        for g, a in zip(np.split(got, sizes), want):
            assert np.array_equal(g.reshape(a.shape), a), name
    assert pads and straddles


def keygen_inputs(levels, w, seed):
    """uint32 numpy operands of K9 at W words: both parties' seed planes,
    random but for lanes 0-7 of word 0, where party 1 has party 0's seeds
    (their seed corrections are 0), and lanes 8-15, where both seeds are 0;
    and path rows of all zeros (level 0), all ones (level 1) and random
    bits."""
    rng = np.random.default_rng(seed)
    p0, p1 = rng.integers(0, 2**32, size=(2, 128, w), dtype=np.uint32)
    same, zero = np.uint32(0x000000FF), np.uint32(0x0000FF00)
    p1[:, 0] = (p1[:, 0] & ~same) | (p0[:, 0] & same)
    p0[:, 0] &= ~zero
    p1[:, 0] &= ~zero
    path = rng.integers(0, 2**32, size=(levels, w), dtype=np.uint32)
    path[0] = 0
    if levels > 1:
        path[1] = 0xFFFFFFFF
    return p0, p1, path


def test_csrc_keygen_body_on_the_host_compiler(host_harness):
    """csrc/keygen_rows.cuh, K9's column body, built with g++ and run over
    every word, its 16 threads (four (party, branch) items of four column
    threads) in lockstep, equals K9's plain version (cw, cc, vh, ctrl): one and
    several levels, depths that capture and depths that do not (the last
    always does), captures past depth 32 (the second word of the bitmask),
    path rows of all zeros, all ones and random bits, lanes whose parties
    share a seed and zero seeds. K9 has no limb arithmetic (its corrections
    are XORs and selects; the typed value corrections are the host's), so
    there is no carry to force."""
    exe = host_harness
    w = WIDTHS[0]
    for i, captures in enumerate((
        (True, True), (True, False, True, True), (False, False, False, True),
        (True,) * 5, tuple(d in (0, 33, 40) for d in range(41)),
    )):
        levels = len(captures) - 1
        ops = keygen_inputs(levels, w, seed=30 + i)
        mask = sum(1 << d for d, flag in enumerate(captures) if flag)
        mask_words = np.array([(mask >> (32 * j)) & 0xFFFFFFFF for j in range(5)], np.uint32)
        got = run_harness(exe, [10, 1, w, levels], mask_words, *ops)
        want = [aes_torch.from_words(t) for t in
                backend_torch.keygen_megakernel(*map(words, ops), captures=captures)]
        sizes = np.cumsum([a.size for a in want])[:-1]
        assert got.size == sum(a.size for a in want)
        for g, a in zip(np.split(got, sizes), want):
            assert np.array_equal(g.reshape(a.shape), a), captures


def test_library_loads_once_when_threads_reach_a_cold_process(monkeypatch, tmp_path):
    """Two servers' workers in one fresh process call the kernels together:
    one build and one import, and every thread gets that module."""
    import threading
    import time

    import torch.utils.cpp_extension as cpp_extension

    calls = []

    def fake_load(**kwargs):
        calls.append(kwargs["name"])
        time.sleep(0.2)
        return object()

    monkeypatch.setattr(cpp_extension, "load", fake_load)
    monkeypatch.setattr(aes_cuda, "BUILD_DIR", tmp_path)
    aes_cuda._load_library.cache_clear()
    got = []
    try:
        threads = [threading.Thread(target=lambda: got.append(aes_cuda.library()))
                   for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    finally:
        aes_cuda._load_library.cache_clear()
    assert calls == ["dpf_tpu_torch_kernels"] and len(got) == 4 and len({id(m) for m in got}) == 1
