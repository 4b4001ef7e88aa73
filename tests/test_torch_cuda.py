"""The PyTorch/CUDA port on a CUDA card: kernels against their plain
versions, and the fold and PIR paths through the kernels (K2-K4, and K5 in
mode="megakernel"), batched EvaluateAt (K6 and K4 in mode="walk", K7 in
mode="walkkernel"; its codec walk), full-domain evaluation with values out
(IntModN and a two-block tuple: K2 and K4, or K6 and K4), the DCF's
batch_evaluate (K6 and K4 in mode="walk", K7's DCF form in
mode="walkkernel"; tuple payloads) and the FSS gates on it, the
hierarchical advance (K2 and K4 in mode="fused", K8 in mode="hierkernel";
one level a call through evaluate_until_batch), the host API's
TorchBackend (K6, K2, K4), PIR in modes levels, walk and fused, and batched
keygen (K2's one-key view and K4 in mode="perlevel", K9 in
mode="megakernel") against the same paths on the CPU; the pipelined
executor against the serial one at the fold's full plan, a real
out-of-memory error through the degradation chain, and the serving plane:
a served batch of every op on the card against the same door on the CPU,
with the launches of the direct call, two servers' PIR over loopback, a
heavy-hitter stream window in each mode against the CPU, a round trip
through a one-replica fleet a party (ReplicaPool, --device cuda), and the
multi-device path (the mesh megakernel PIR, the sharded PIR, full domain
and EvaluateUntil) on a mesh whose four shards name the one card and on a
mesh over two cards (which skips with fewer), against one device; and the
whole-path device check (utils/integrity.run_device_check) in every mode,
with an injected fault counted.

Every test here needs a card and skips without one. The file imports no
JAX, so on a machine without JAX it runs without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import collections

import numpy as np
import pytest
import torch

import distributed_point_functions_tpu_torch as port
from distributed_point_functions_tpu_torch.core.dpf import NumpyBackend
from distributed_point_functions_tpu_torch.dcf import batch as dcf_batch
from distributed_point_functions_tpu_torch.ops import aes_cuda, backend_torch, evaluator
from distributed_point_functions_tpu_torch.ops import hier_cases, hierarchical, keygen_batch
from distributed_point_functions_tpu_torch.ops.aes_torch import as_words, from_words, pack_bit_mask
from distributed_point_functions_tpu_torch.parallel import pir
from distributed_point_functions_tpu_torch.utils.errors import InvalidArgumentError

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def expand_inputs(k: int, w: int, device):
    rng = np.random.default_rng(w)
    arrays = (
        rng.integers(0, 2**32, size=(k, 128, w), dtype=np.uint32),
        rng.integers(0, 2**32, size=(k, w), dtype=np.uint32),
        backend_torch.cw_seed_planes(rng.integers(0, 2**32, size=(k, 4), dtype=np.uint32)),
        backend_torch.control_masks(rng.integers(0, 2, size=k)),
        backend_torch.control_masks(rng.integers(0, 2, size=k)),
    )
    return [torch.from_numpy(as_words(a)).to(device) for a in arrays]


@pytest.mark.parametrize("w", [1, 3, 5, 7, 9, 13, 40, 77, 1037])
def test_kernels_match_plain_versions(cuda, w):
    """K2, K3 and K4 on the card equal their plain versions on the same
    tensors, ragged widths included: at 3 keys every width but 40 leaves a
    last warp of K2's and K3's eight (key, child, word) items and of K4's
    eight (key, word) items part-filled; each launch is counted once."""
    args = expand_inputs(3, w, cuda)
    aes_cuda.reset_launch_counts()
    for kernel, plain in (
        (aes_cuda.expand_one_level, backend_torch.expand_one_level),
        (aes_cuda.expand_and_hash_last_level, backend_torch.expand_and_hash_last_level),
    ):
        got, want = kernel(*args), plain(*args)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert torch.equal(
        aes_cuda.hash_value_planes(args[0]), backend_torch.hash_value_planes(args[0])
    )
    assert [k.launches for k in aes_cuda.KERNELS] == [1, 1, 1, 0, 0, 0, 0, 0, 0]


def megakernel_plan(lds, value_type, budget, host_levels=None):
    dpf = port.DistributedPointFunction.create(port.DpfParameters(lds, value_type))
    return evaluator.plan_megakernel(dpf, host_levels=host_levels, budget=budget)


@pytest.mark.parametrize(
    "lds, value_type, budget, host_levels, party, with_db",
    [
        (9, port.Int(64), 8192, 7, 1, True),  # no phase-A level
        (12, port.Int(64), 4096, None, 0, False),  # no phase-B level, fold width 1
        (12, port.Int(32), 16384, 6, 1, True),  # two-word entry tile, one buffer
        (12, port.XorWrapper(128), 65536, None, 0, True),  # both buffers
        (16, port.Int(64), evaluator.MEGAKERNEL_BUDGET, None, 1, False),  # full slab
    ],
)
def test_megakernel_matches_plain_version(cuda, lds, value_type, budget, host_levels, party, with_db):
    """K5 on the card equals its plain version on the same tensors, for
    ragged, multi-slab and full-width plans; one launch per call."""
    plan = megakernel_plan(lds, value_type, budget, host_levels)
    bits = value_type.bitsize
    lpe, levels = bits // 32, plan.levels_a + plan.levels_b
    keep = 128 // bits
    rng = np.random.default_rng(lds)

    def r(*shape):
        return torch.from_numpy(as_words(rng.integers(0, 2**32, size=shape, dtype=np.uint32))).to(cuda)

    k = 3
    args = (r(k, 128, plan.entry_words), r(k, plan.entry_words), r(k, levels, 128),
            r(k, levels), r(k, levels), r(k, 128 // bits, lpe),
            r(keep * lpe * 32, plan.num_slabs * plan.final_words) if with_db else None)
    kw = dict(plan=plan, bits=bits, party=party,
              xor_group=isinstance(value_type, port.XorWrapper), keep=keep)
    aes_cuda.reset_launch_counts()
    got = aes_cuda.megakernel_fold(*args, **kw)
    assert aes_cuda.K5.launches == 1
    assert torch.equal(got, backend_torch.megakernel_fold(*args, **kw))


@pytest.mark.parametrize(
    "lds, value_type, budget, k, blocks_per_key, with_db",
    [
        (12, port.Int(64), 4096, 1, None, False),  # one-word slabs, fold width 1, K = 1
        (12, port.Int(32), 16384, 3, 3, True),  # 8 slabs over 3 blocks a key, fold width 4
        (12, port.XorWrapper(128), 65536, 5, 8, True),  # a block a slab, fold width 16
        (16, port.Int(64), 262144, 7, 5, False),  # 16 slabs over 5 blocks, fold width 64
        (16, port.Int(128), evaluator.MEGAKERNEL_BUDGET, 1, None, True),  # four carrying limbs
        (20, port.Int(64), evaluator.MEGAKERNEL_BUDGET, 3, None, False),  # the main plan, K = 3
    ],
)
def test_megakernel_split_over_blocks_matches_plain_version(
    cuda, lds, value_type, budget, k, blocks_per_key, with_db
):
    """K5 with each key's slabs over several blocks (the card's choice, or
    a count that does not divide the slabs) equals its plain version, on
    ragged plans with and without a database; one launch per call."""
    plan = megakernel_plan(lds, value_type, budget)
    bits = value_type.bitsize
    lpe, levels = bits // 32, plan.levels_a + plan.levels_b
    keep = 128 // bits
    rng = np.random.default_rng(lds + k)

    def r(*shape):
        return torch.from_numpy(as_words(rng.integers(0, 2**32, size=shape, dtype=np.uint32))).to(cuda)

    args = (r(k, 128, plan.entry_words), r(k, plan.entry_words), r(k, levels, 128),
            r(k, levels), r(k, levels), r(k, 128 // bits, lpe),
            r(keep * lpe * 32, plan.num_slabs * plan.final_words) if with_db else None)
    kw = dict(plan=plan, bits=bits, party=k % 2,
              xor_group=isinstance(value_type, port.XorWrapper), keep=keep)
    aes_cuda.reset_launch_counts()
    got = aes_cuda.megakernel_fold(*args, **kw, blocks_per_key=blocks_per_key)
    assert aes_cuda.K5.launches == 1
    assert torch.equal(got, backend_torch.megakernel_fold(*args, **kw))


def test_megakernel_refuses_a_slab_larger_than_shared_memory(cuda):
    """A plan whose phase-B slab needs more shared memory than a block may
    have is refused on the card, not run elsewhere."""
    plan = megakernel_plan(20, port.Int(64), 4 * evaluator.MEGAKERNEL_BUDGET)
    assert plan.final_words == 1024 and plan.levels_b >= 2
    levels = plan.levels_a + plan.levels_b

    def z(*shape):
        return torch.zeros(shape, dtype=torch.int32, device=cuda)

    args = (z(1, 128, 1), z(1, 1), z(1, levels, 128), z(1, levels), z(1, levels), z(1, 2, 2))
    aes_cuda.reset_launch_counts()
    with pytest.raises(InvalidArgumentError, match="shared memory"):
        aes_cuda.megakernel_fold(*args, plan=plan, bits=64, party=0, xor_group=False, keep=2)
    assert aes_cuda.K5.launches == 0


def test_kernels_reject_non_contiguous_operands(cuda):
    args = expand_inputs(2, 8, cuda)
    with pytest.raises(InvalidArgumentError, match="contiguous"):
        aes_cuda.hash_value_planes(args[0].transpose(0, 1).contiguous().transpose(0, 1))


def test_kernels_launch_on_their_operands_device(cuda):
    """A launch runs on the card its operands lie on, whichever card is
    current; operands on two cards are refused before any launch."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    second = torch.device("cuda", 1)
    args = expand_inputs(2, 40, second)
    with torch.cuda.device(0):
        got = aes_cuda.expand_one_level(*args)
        hashed = aes_cuda.hash_value_planes(args[0])
    assert got[0].device == second and hashed.device == second
    assert all(torch.equal(a, b) for a, b in zip(got, backend_torch.expand_one_level(*args)))
    assert torch.equal(hashed, backend_torch.hash_value_planes(args[0]))
    with pytest.raises(InvalidArgumentError, match="one CUDA device"):
        aes_cuda.expand_one_level(args[0].to(cuda), *args[1:])


@pytest.mark.parametrize("fuse_last_hash", [False, True])
def test_fold_on_the_card_matches_the_cpu(cuda, fuse_last_hash):
    dpf = port.DistributedPointFunction.create(port.DpfParameters(12, port.Int(64)))
    rng = np.random.default_rng(12)
    seeds = rng.integers(0, 2**32, size=(5, 2, 4), dtype=np.uint32)
    keys, _ = dpf.generate_keys_batch([0, 1, 77, 4000, 4095], [[3, 4, 5, 6, 7]], seeds=seeds)

    def fold(device):
        return np.concatenate([
            from_words(f)[:v]
            for v, f in evaluator.full_domain_fold_chunks(
                dpf, keys, key_chunk=2, fuse_last_hash=fuse_last_hash, device=device
            )
        ])

    aes_cuda.reset_launch_counts()
    on_card = fold(cuda)
    assert aes_cuda.K2.launches > 0
    assert (aes_cuda.K3 if fuse_last_hash else aes_cuda.K4).launches > 0
    assert np.array_equal(on_card, fold("cpu"))


@pytest.mark.parametrize("party", [0, 1])
def test_megakernel_fold_on_the_card_matches_the_cpu(cuda, party, monkeypatch):
    """mode="megakernel" on the card equals the same mode on the CPU, with
    and without a megakernel-order database, one K5 launch per chunk and no
    other kernel; and equals mode="fold". The keys evaluate on device="cuda"
    and the database tensor lies on cuda:0: the same card. A small
    megakernel budget gives the plan several slabs."""
    dpf = port.DistributedPointFunction.create(port.DpfParameters(13, port.Int(64)))
    rng = np.random.default_rng(13)
    seeds = rng.integers(0, 2**32, size=(5, 2, 4), dtype=np.uint32)
    keys = dpf.generate_keys_batch([0, 1, 77, 4000, 8191], [[3, 4, 5, 6, 7]], seeds=seeds)[party]
    monkeypatch.setattr(evaluator, "MEGAKERNEL_BUDGET", 16384)
    plan = evaluator.plan_megakernel(dpf)
    assert plan.num_slabs > 1
    db = evaluator.megakernel_db_rows(
        dpf, rng.integers(0, 2**32, size=(1 << 13, 2), dtype=np.uint32), plan
    )

    def fold(device, db_rows=None, mode="megakernel"):
        if db_rows is not None:
            db_rows = torch.from_numpy(as_words(db_rows)).to(device)
        return np.concatenate([
            from_words(f)[:v]
            for v, f in evaluator.full_domain_fold_chunks(
                dpf, keys, key_chunk=2, db_lane=db_rows, mode=mode, device=device,
            )
        ])

    aes_cuda.reset_launch_counts()
    on_card = fold(cuda)
    assert [k.launches for k in aes_cuda.KERNELS] == [0, 0, 0, 3, 0, 0, 0, 0, 0]
    assert np.array_equal(on_card, fold("cpu"))
    assert np.array_equal(on_card, fold("cpu", mode="fold"))
    assert np.array_equal(fold(cuda, db), fold("cpu", db))


def test_pir_on_the_card_reconstructs(cuda):
    dpf = port.DistributedPointFunction.create(port.DpfParameters(11, port.XorWrapper(128)))
    rng = np.random.default_rng(11)
    db = rng.integers(0, 2**32, size=(1 << 11, 4), dtype=np.uint32)
    targets = [5, 1000, 2047]
    ka, kb = dpf.generate_keys_batch(targets, [(1 << 128) - 1])
    prepared = pir.prepare_pir_database(dpf, db)
    assert prepared.lane_db.is_cuda
    ra = pir.pir_query_batch_chunked(dpf, ka, prepared)
    rb = pir.pir_query_batch_chunked(dpf, kb, prepared)
    assert np.array_equal(ra ^ rb, db[targets])


@pytest.mark.parametrize("w", [1, 3, 7, 9, 40, 77, 1037])
def test_walk_level_matches_plain_version(cuda, w):
    """K6 on the card equals its plain version, ragged widths and a mixed
    path mask included: at 3 keys every width but 40 leaves the last warp
    of eight (key, word) items part-filled; one launch per call."""
    args = expand_inputs(3, w, cuda)
    path = args[1][0].contiguous()
    aes_cuda.reset_launch_counts()
    got = aes_cuda.walk_level(args[0], args[1], path, *args[2:])
    assert aes_cuda.K6.launches == 1
    want = backend_torch.walk_level(args[0], args[1], path, *args[2:])
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize(
    "levels, w, bits, keep, party, xor_group",
    [(1, 1, 32, 4, 1, False), (5, 3, 64, 2, 0, False), (4, 37, 64, 1, 1, False),
     (3, 8, 128, 1, 1, True), (6, 40, 128, 1, 1, False)],
)
def test_walk_megakernel_matches_plain_version(cuda, levels, w, bits, keep, party, xor_group):
    """K7 on the card equals its plain version for every limb layout, kept
    element count, party and group; one launch per call."""
    rng = np.random.default_rng(levels * w)

    def r(*shape):
        return rng.integers(0, 2**32, size=shape, dtype=np.uint32)

    block_sel = rng.integers(0, keep, size=32 * w)
    arrays = (backend_torch.cw_seed_planes(r(3, 4)), r(levels, w),
              backend_torch.cw_seed_planes(r(3, levels, 4)),
              backend_torch.control_masks(rng.integers(0, 2, size=(3, levels))),
              backend_torch.control_masks(rng.integers(0, 2, size=(3, levels))),
              r(3, 128 // bits, bits // 32),
              pack_bit_mask(block_sel[None, :] == np.arange(keep)[:, None]))
    args = [torch.from_numpy(as_words(a)).to(cuda) for a in arrays]
    kw = dict(bits=bits, party=party, xor_group=xor_group, keep=keep)
    aes_cuda.reset_launch_counts()
    got = aes_cuda.walk_megakernel(*args, **kw)
    assert aes_cuda.K7.launches == 1
    assert torch.equal(got, backend_torch.walk_megakernel(*args, **kw))


@pytest.mark.parametrize("party", [0, 1])
@pytest.mark.parametrize("mode", ["walk", "walkkernel"])
def test_evaluate_at_batch_on_the_card_matches_the_cpu(cuda, mode, party):
    """Both modes on the card equal the same call on the CPU, in chunks of 2
    keys (3 chunks, the last padded): one K6 launch per tree level and one
    K4 per chunk in mode "walk", one K7 per chunk and nothing else in mode
    "walkkernel"; the result stays on the card with device_output."""
    dpf = port.DistributedPointFunction.create(port.DpfParameters(13, port.Int(64)))
    rng = np.random.default_rng(13)
    alphas = [0, 1, 77, 4000, 8191]
    seeds = rng.integers(0, 2**32, size=(5, 2, 4), dtype=np.uint32)
    keys = dpf.generate_keys_batch(alphas, [[3, 4, 5, 6, 7]], seeds=seeds)[party]
    points = alphas + [int(p) for p in rng.integers(0, 1 << 13, size=95)]

    def run(device, **kw):
        return evaluator.evaluate_at_batch(dpf, keys, points, key_chunk=2, mode=mode,
                                           device=device, **kw)

    aes_cuda.reset_launch_counts()
    on_card = run(cuda, device_output=True)
    assert on_card.is_cuda
    levels = dpf.validator.hierarchy_to_tree[0]
    want = [3 * levels, 3, 0] if mode == "walk" else [0, 0, 3]
    assert [aes_cuda.K6.launches, aes_cuda.K4.launches, aes_cuda.K7.launches] == want
    assert np.array_equal(from_words(on_card), run("cpu"))


CODEC_TYPES = {
    "IntModN(64)": port.IntModN(64, 2**64 - 59),
    "Tuple(5 x Int32)": port.TupleType(*[port.Int(32)] * 5),  # two value blocks
}


@pytest.mark.parametrize("party", [0, 1])
@pytest.mark.parametrize("name", list(CODEC_TYPES))
def test_full_domain_codec_on_the_card_matches_the_cpu(cuda, name, party):
    """``full_domain_evaluate_chunks`` of IntModN(64) and of the 160-bit
    tuple (two K4 launches a chunk) on the card, in modes "levels" and
    "walk", equals the CPU in chunks of 2 keys (3 chunks, the last padded):
    K2 a device level and K4 a value block, or K6 a tree level and K4 a
    block; and the codec walk of ``evaluate_at_batch`` equals the CPU."""
    vt = CODEC_TYPES[name]
    dpf = port.DistributedPointFunction.create(port.DpfParameters(11, vt))
    rng = np.random.default_rng(11)
    alphas = [0, 5, 700, 2047, 1024]
    betas = ([int(b) for b in rng.integers(1, 2**62, size=5)] if name == "IntModN(64)"
             else [tuple(int(x) for x in rng.integers(0, 2**32, size=5)) for _ in alphas])
    seeds = rng.integers(0, 2**32, size=(5, 2, 4), dtype=np.uint32)
    keys = dpf.generate_keys_batch(alphas, [betas], seeds=seeds)[party]
    levels = dpf.validator.hierarchy_to_tree[0]
    blocks = dpf.validator.blocks_needed[0]

    def run(device, mode):
        outs = []
        for valid, out in evaluator.full_domain_evaluate_chunks(
                dpf, keys, key_chunk=2, mode=mode, device=device):
            out = out if isinstance(out, tuple) else (out,)
            outs.append([from_words(o[:valid]) for o in out])
        return [np.concatenate([o[c] for o in outs]) for c in range(len(outs[0]))]

    for mode, want in (("levels", [3 * (levels - 5), 3 * blocks, 0]),
                       ("walk", [0, 3 * blocks, 3 * levels])):
        aes_cuda.reset_launch_counts()
        on_card = run(cuda, mode)
        assert [aes_cuda.K2.launches, aes_cuda.K4.launches, aes_cuda.K6.launches] == want
        assert all(np.array_equal(a, b) for a, b in zip(on_card, run("cpu", mode))), mode
    points = alphas + [int(p) for p in rng.integers(0, 1 << 11, size=60)]
    on_card, on_cpu = (evaluator.evaluate_at_batch(dpf, keys, points, key_chunk=2, device=d)
                       for d in (cuda, "cpu"))
    on_card, on_cpu = ((x,) if not isinstance(x, tuple) else x for x in (on_card, on_cpu))
    assert all(np.array_equal(a, b) for a, b in zip(on_card, on_cpu))


@pytest.mark.parametrize(
    "captures, w, bits, keep, party, xor_group",
    [((True, True), 1, 32, 4, 1, False), ((True, False, True, True), 3, 64, 2, 1, False),
     ((False, True, True, False, True), 37, 64, 1, 0, False),
     ((True, False, True), 8, 128, 1, 1, True), ((True,) * 7, 40, 128, 1, 1, False),
     ((False, False, False), 3, 64, 2, 1, False)],
)
def test_walk_megakernel_dcf_matches_plain_version(cuda, captures, w, bits, keep, party, xor_group):
    """K7's DCF form on the card equals its plain version for every limb
    layout, kept element count, party and group, with depths that do not
    capture and with none that does; one launch of the DCF form per call
    and none of the EvaluateAt form."""
    levels = len(captures) - 1
    rng = np.random.default_rng(levels * w + bits)

    def r(*shape):
        return rng.integers(0, 2**32, size=shape, dtype=np.uint32)

    rows = (levels + 1) * keep
    arrays = (backend_torch.cw_seed_planes(r(3, 4)), r(levels, w),
              backend_torch.cw_seed_planes(r(3, levels, 4)),
              backend_torch.control_masks(rng.integers(0, 2, size=(3, levels))),
              backend_torch.control_masks(rng.integers(0, 2, size=(3, levels))),
              r(3, rows, bits // 32), r(rows, w))
    args = [torch.from_numpy(as_words(a)).to(cuda) for a in arrays]
    kw = dict(bits=bits, party=party, xor_group=xor_group, keep=keep, captures=captures)
    aes_cuda.reset_launch_counts()
    got = aes_cuda.walk_megakernel(*args, **kw)
    assert (aes_cuda.K7_DCF.launches, aes_cuda.K7.launches) == (1, 0)
    assert torch.equal(got, backend_torch.walk_megakernel(*args, **kw))


@pytest.mark.parametrize("party", [0, 1])
@pytest.mark.parametrize("mode", ["walk", "walkkernel"])
def test_dcf_batch_evaluate_on_the_card_matches_the_cpu(cuda, mode, party):
    """Both modes of the DCF's batch_evaluate on the card equal the same call
    on the CPU, in chunks of 2 keys (3 chunks, the last padded): T K6 and T
    + 1 K4 launches per chunk in mode "walk", one launch of K7's DCF form
    per chunk and nothing else in mode "walkkernel"."""
    dcf = port.DistributedComparisonFunction.create(12, port.Int(64))
    rng = np.random.default_rng(12)
    alphas = [0, 1, 77, 4000, 4095]
    seeds = rng.integers(0, 2**32, size=(5, 2, 4), dtype=np.uint32)
    keys = dcf.generate_keys_batch(alphas, [3, 4, 5, 6, 7], seeds=seeds)[party]
    xs = alphas + [76, 3999] + [int(x) for x in rng.integers(0, 1 << 12, size=60)]

    def run(device, **kw):
        return dcf_batch.batch_evaluate(dcf, keys, xs, key_chunk=2, mode=mode, device=device, **kw)

    aes_cuda.reset_launch_counts()
    on_card = run(cuda, device_output=True)
    assert on_card.is_cuda
    t = 11
    want = {"walk": [3 * t, 3 * (t + 1), 0, 0], "walkkernel": [0, 0, 0, 3]}[mode]
    got = [aes_cuda.K6.launches, aes_cuda.K4.launches, aes_cuda.K7.launches,
           aes_cuda.K7_DCF.launches]
    assert got == want
    assert np.array_equal(from_words(on_card), run("cpu"))


@pytest.mark.parametrize("party", [0, 1])
@pytest.mark.parametrize("widths", [(32,) * 16, (64,) * 3, (32,) * 4, (128,) * 2])
def test_dcf_tuple_payload_on_the_card_matches_the_cpu(cuda, widths, party):
    """The tuple capture on the card equals the same call on the CPU, in
    chunks of 2 keys (3 chunks, the last padded), nb = 4, 2, 1 and 2 value
    blocks: T K6 launches and T + 1 K4 launches a chunk, every block of a
    depth in one K4 launch."""
    dcf = port.DistributedComparisonFunction.create(
        10, port.TupleType(*(port.Int(b) for b in widths)))
    rng = np.random.default_rng(len(widths))
    alphas = [0, 1, 77, 1000, 1023]
    betas = [tuple(int(v) for v in rng.integers(0, 2**31, size=len(widths))) for _ in alphas]
    seeds = rng.integers(0, 2**32, size=(5, 2, 4), dtype=np.uint32)
    keys = dcf.generate_keys_batch(alphas, betas, seeds=seeds)[party]
    xs = alphas + [76, 999] + [int(x) for x in rng.integers(0, 1 << 10, size=90)]
    aes_cuda.reset_launch_counts()
    on_card = dcf_batch.batch_evaluate(dcf, keys, xs, key_chunk=2)
    assert [aes_cuda.K6.launches, aes_cuda.K4.launches] == [3 * 9, 3 * 10]
    assert on_card.shape == (5, len(xs), len(widths), 4)
    assert np.array_equal(on_card, dcf_batch.batch_evaluate(dcf, keys, xs, key_chunk=2,
                                                            device="cpu"))


def test_gates_on_the_card_match_the_cpu(cuda):
    """A sigmoid gate (a four-block tuple payload) and a DReLU gate in both
    modes evaluate on the card as on the CPU, batch_eval and bundle_eval,
    both parties."""
    from distributed_point_functions_tpu_torch import gates

    rng = np.random.default_rng(16)
    for gate, modes in ((gates.SigmoidGate.create(12, frac_bits=4), dcf_batch.MODES[:1]),
                        (gates.DReluGate.create(12), dcf_batch.MODES)):
        pair = gate.gen(77, [5], prng=gates.CounterRng(b"card"))
        xs = [int(x) for x in rng.integers(0, gate.n, size=100)]
        bundle = gate.gen_bundle([3, 4, 5], [[1], [2], [3]])
        for party in (0, 1):
            want = gate.batch_eval(pair[party], xs, device="cpu")
            for mode in modes:
                assert gate.batch_eval(pair[party], xs, mode=mode).tolist() == want.tolist()
            assert gates.bundle_eval(gate, bundle[party], xs[:3]).tolist() == (
                gates.bundle_eval(gate, bundle[party], xs[:3], device="cpu").tolist())


def test_gate_timings_on_the_card_give_the_card_seconds(cuda):
    """On the card ``batch_eval(timings=)`` gives the same shares, every
    step's host seconds and the DCF steps' "_card" seconds (CUDA events),
    the card's part of the walk no longer than the synchronized step."""
    from distributed_point_functions_tpu_torch import gates

    gate = gates.ReluGate.create(12, payload="vector")
    pair = gate.gen(77, [5], prng=gates.CounterRng(b"card"))
    xs = [int(x) for x in np.random.default_rng(17).integers(0, gate.n, size=100)]
    timings = {}
    got = gate.batch_eval(pair[0], xs, timings=timings)
    assert got.tolist() == gate.batch_eval(pair[0], xs, device="cpu").tolist()
    steps = ["plan", "tables", "walk", "pull", "ints", "combine"]
    assert sorted(timings) == sorted(steps + ["tables_card", "walk_card", "pull_card"])
    assert 0 < timings["walk_card"] <= timings["walk"] + 1e-3


@pytest.mark.parametrize("name", list(hier_cases.CASES))
def test_hier_megakernel_matches_plain_version(cuda, name):
    """K8 on the card equals its plain version (every value row, the exit
    seeds and the exit control, pad lanes included) on the windows of
    ops/hier_cases.py: prefix windows of real small hierarchies,
    every limb layout and kept element count, both parties, a zero-level
    first step, steps of two and three tree levels, words that straddle
    segments, and corrections that carry through every limb; one
    cooperative launch per call."""
    case = hier_cases.window_case(name, device=cuda)
    aes_cuda.reset_launch_counts()
    got = aes_cuda.hier_megakernel(*case["args"], **case["kw"])
    assert aes_cuda.K8.launches == 1
    want = backend_torch.hier_window(*case["args"][:3], *case["args"][4:], **case["kw"])
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("party", [0, 1])
@pytest.mark.parametrize("mode", hierarchical.MODES)
def test_evaluate_levels_fused_on_the_card_matches_the_cpu(cuda, mode, party):
    """Both modes of the hierarchical advance on the card equal the same call
    on the CPU, on a 66-level bit-wise Int(64) hierarchy (U128 prefixes from
    level 64) of 5 keys: in mode "fused" one K2 launch per tree level and
    one K4 launch per hierarchy level, in mode "hierkernel" one K8 launch per
    window and chunk of 2 keys (3 chunks, the last padded), and nothing
    else; the contexts end in the same state."""
    levels = 66
    dpf = port.DistributedPointFunction.create_incremental(
        [port.DpfParameters(i + 1, port.Int(64)) for i in range(levels)])
    rng = np.random.default_rng(66)
    alphas = hierarchical.draw_random_finals(levels, 5, rng)
    plan = hierarchical.bitwise_hierarchy_plan(
        levels, hierarchical.draw_random_finals(levels, 20, rng) + alphas)
    seeds = rng.integers(0, 2**32, size=(5, 2, 4), dtype=np.uint32)
    keys = dpf.generate_keys_batch(alphas, [[7] * 5] * levels, seeds=seeds)[party]

    def run(device, **kw):
        ctx = hierarchical.BatchedContext.create(dpf, keys)
        outs = hierarchical.evaluate_levels_fused(ctx, plan[:-1], group=16, mode=mode,
                                                  key_chunk=2, device=device, **kw)
        return outs, ctx

    aes_cuda.reset_launch_counts()
    on_card, card_ctx = run(cuda, device_output=True)
    windows = -(-(levels - 1) // 16)
    want = {"fused": [levels - 2, 0, levels - 1, 0], "hierkernel": [0, 0, 0, 3 * windows]}[mode]
    counts = {k.name: k.launches for k in aes_cuda.KERNELS}
    assert [aes_cuda.K2.launches, aes_cuda.K3.launches, aes_cuda.K4.launches,
            aes_cuda.K8.launches] == want, counts
    assert sum(counts.values()) == sum(want)
    on_cpu, cpu_ctx = run("cpu")
    for a, b in zip(on_card, on_cpu):
        assert a.is_cuda and np.array_equal(from_words(a), b)
    assert card_ctx.seeds.is_cuda and np.array_equal(from_words(card_ctx.seeds),
                                                     from_words(cpu_ctx.seeds))
    assert np.array_equal(from_words(card_ctx.control), from_words(cpu_ctx.control))


@pytest.mark.parametrize(
    "captures, w",
    [((True, True), 1), ((True, False, True, True), 3), ((False,) * 4 + (True,), 37),
     (tuple(d in (0, 33, 40) for d in range(41)), 2), ((False,) * 127 + (True,), 32)],
)
def test_keygen_megakernel_matches_plain_version(cuda, captures, w):
    """K9 on the card equals its plain version: one to 127 levels, depths
    that do not capture, captures past depth 32, ragged widths; one launch."""
    rng = np.random.default_rng(w + len(captures))
    levels = len(captures) - 1
    ops = [torch.from_numpy(as_words(rng.integers(0, 2**32, size=shape, dtype=np.uint32))).to(cuda)
           for shape in ((128, w), (128, w), (levels, w))]
    aes_cuda.reset_launch_counts()
    got = aes_cuda.keygen_megakernel(*ops, captures=captures)
    assert aes_cuda.K9.launches == 1
    want = backend_torch.keygen_megakernel(*ops, captures=captures)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("w", [1, 7, 33, 8192])
def test_k2_one_key_view_matches_plain_version(cuda, w):
    """K2's one-key view at one word (two items: one warp, mostly past the
    end), ragged widths, and benchmarks/micro_tpu.py's W = 8192."""
    args = [a[0] for a in expand_inputs(1, w, cuda)]
    aes_cuda.reset_launch_counts()
    got = aes_cuda.expand_one_level_single(*args)
    assert aes_cuda.K2.launches == 1
    want = backend_torch.expand_one_level_single(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("log_domain, value_type", [(20, port.Int(64)), (128, port.XorWrapper(128))])
def test_keygen_modes_on_the_card_match_the_host_dealer(cuda, log_domain, value_type):
    """Modes perlevel (one K2 a level, one K4 a capture) and megakernel (one
    K9) on the card give the host dealer's keys; so does the DCF's dealer."""
    dpf = port.DistributedPointFunction.create(port.DpfParameters(log_domain, value_type))
    rng = np.random.default_rng(log_domain)
    k = 70
    alphas = [int.from_bytes(rng.bytes(16), "little") % (1 << log_domain) for _ in range(k)]
    betas = [int(x) for x in rng.integers(1, 2**62, size=k)]
    seeds = rng.integers(0, 2**32, size=(k, 2, 4), dtype=np.uint32)
    want = dpf.generate_keys_batch(alphas, [betas], seeds=seeds)
    levels = dpf.validator.tree_levels_needed - 1
    for mode, counts in (("perlevel", {aes_cuda.K2: levels, aes_cuda.K4: 1}),
                         ("megakernel", {aes_cuda.K9: 1})):
        aes_cuda.reset_launch_counts()
        got = keygen_batch.generate_keys_batch(dpf, alphas, [betas], mode=mode, seeds=seeds)
        assert got == want, mode
        assert {k: k.launches for k in aes_cuda.KERNELS if k.launches} == counts
    dcf = port.DistributedComparisonFunction.create(12, port.Int(64))
    dalphas = [a % 4096 for a in alphas[:9]]
    want = dcf.generate_keys_batch(dalphas, betas[:9], seeds=seeds[:9])
    got = dcf.generate_keys_batch(dalphas, betas[:9], seeds=seeds[:9], mode="megakernel")
    assert got == want


@pytest.mark.parametrize("n", [1, 37, 4096])
def test_torch_backend_on_the_card_matches_numpy(cuda, n):
    """TorchBackend's three primitives on the card (K6, K2, K4) equal the
    numpy backend's, at lane counts that are and are not whole words."""
    rng = np.random.default_rng(n)
    seeds = rng.integers(0, 2**32, size=(n, 4), dtype=np.uint32)
    control = rng.integers(0, 2, size=n).astype(bool)
    paths = rng.integers(0, 2**32, size=(n, 4), dtype=np.uint32)
    cs = rng.integers(0, 2**32, size=(7, 4), dtype=np.uint32)
    ccl, ccr = rng.integers(0, 2, size=(2, 7)).astype(bool)
    tb, nb = backend_torch.TorchBackend(cuda), NumpyBackend()
    aes_cuda.reset_launch_counts()
    for got, want in ((tb.evaluate_seeds(seeds, control, paths, cs, ccl, ccr),
                       nb.evaluate_seeds(seeds, control, paths, cs, ccl, ccr)),
                      (tb.expand_seeds(seeds, control, cs[:4], ccl[:4], ccr[:4]),
                       nb.expand_seeds(seeds, control, cs[:4], ccl[:4], ccr[:4]))):
        assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
    for blocks in (1, 2):
        assert np.array_equal(tb.hash_expanded_seeds(seeds, blocks),
                              nb.hash_expanded_seeds(seeds, blocks))
    assert aes_cuda.K6.launches == 7 and aes_cuda.K2.launches == 4
    assert aes_cuda.K4.launches == 3


@pytest.mark.parametrize("value_type", [port.Int(64), port.IntModN(64, 2**64 - 59),
                                        port.TupleType(port.Int(32), port.Int(32))])
def test_evaluate_until_batch_on_the_card_matches_the_cpu(cuda, value_type):
    """Three levels (a first call, whose pad lanes are dropped on the card
    after 5 levels, a call under about 40 parents, one under 3), both
    parties: the card's outputs and context state equal the CPU's, through
    K2 and K4."""
    dpf = port.DistributedPointFunction.create_incremental(
        [port.DpfParameters(d, value_type) for d in (10, 16, 22)])
    rng = np.random.default_rng(22)
    alphas = [int(a) for a in rng.integers(0, 1 << 22, size=5)]
    sample = ((1, 2) if isinstance(value_type, port.TupleType) else 3)
    keys = dpf.generate_keys_batch(alphas, [[sample] * 5] * 3,
                                   seeds=rng.integers(0, 2**32, size=(5, 2, 4), dtype=np.uint32))
    plan = [[], sorted({a >> 12 for a in alphas} | set(range(0, 1 << 10, 29))),
            sorted({a >> 6 for a in alphas})]
    for party in (0, 1):
        ctxs = [hierarchical.BatchedContext.create(dpf, keys[party]) for _ in range(2)]
        aes_cuda.reset_launch_counts()
        for level, prefixes in enumerate(plan):
            got, want = (hierarchical.evaluate_until_batch(c, level, prefixes, device=d)
                         for c, d in zip(ctxs, (cuda, "cpu")))
            got, want = (x if isinstance(x, tuple) else (x,) for x in (got, want))
            assert all(np.array_equal(a, b) for a, b in zip(got, want)), level
            if level < 2:
                assert torch.equal(ctxs[0].seeds.cpu(), ctxs[1].seeds)
                assert torch.equal(ctxs[0].control.cpu(), ctxs[1].control)
        assert aes_cuda.K2.launches > 0 and aes_cuda.K4.launches > 0


@pytest.mark.parametrize("mode", ["levels", "walk", "fused"])
def test_pir_natural_modes_on_the_card_match_the_cpu(cuda, mode):
    dpf = port.DistributedPointFunction.create(port.DpfParameters(14, port.XorWrapper(128)))
    rng = np.random.default_rng(14)
    db = rng.integers(0, 2**32, size=(1 << 14, 4), dtype=np.uint32)
    targets = [int(t) for t in rng.integers(0, 1 << 14, size=5)]
    qa, qb = dpf.generate_keys_batch(targets, [(1 << 128) - 1],
                                     seeds=rng.integers(0, 2**32, size=(5, 2, 4), dtype=np.uint32))
    order = pir.MODE_ORDER[mode]
    answers = [pir.pir_query_batch_chunked(
        dpf, qa, pir.prepare_pir_database(dpf, db, order=order, device=d), key_chunk=2,
        mode=mode) for d in (cuda, "cpu")]
    assert np.array_equal(answers[0], answers[1])
    rb = pir.pir_query_batch_chunked(dpf, qb, pir.prepare_pir_database(dpf, db, order=order,
                                                                       device=cuda), mode=mode)
    assert np.array_equal(answers[0] ^ rb, db[targets])


@pytest.mark.parametrize("mode", ["fold", "megakernel"])
def test_pipelined_fold_at_the_full_plan_matches_serial(cuda, mode):
    """The pinned-ring executor at the fold's full plan (log-domain 20,
    Int(64), key chunk 128, three chunks): pipeline=True equals
    pipeline=False chunk for chunk, with the same launches."""
    from distributed_point_functions_tpu_torch.ops import pipeline

    dpf = port.DistributedPointFunction.create(port.DpfParameters(20, port.Int(64)))
    rng = np.random.default_rng(20)
    n = 300
    keys, _ = dpf.generate_keys_batch([int(a) for a in rng.integers(0, 1 << 20, size=n)],
                                      [[int(b) for b in rng.integers(1, 2**63, size=n,
                                                                     dtype=np.uint64)]],
                                      seeds=rng.integers(0, 2**32, size=(n, 2, 4),
                                                         dtype=np.uint32))
    runs, launches = [], []
    for pipe in (False, True):
        aes_cuda.reset_launch_counts()
        runs.append([(v, from_words(f).copy()) for v, f in evaluator.full_domain_fold_chunks(
            dpf, keys, key_chunk=128, mode=mode, device=cuda, pipeline=pipe)])
        launches.append([k.launches for k in aes_cuda.KERNELS])
    assert launches[0] == launches[1] and sum(launches[0]) > 0
    assert [v for v, _ in runs[0]] == [v for v, _ in runs[1]] == [128, 128, 44]
    assert all(np.array_equal(a, b) for (_, a), (_, b) in zip(*runs))
    assert pipeline.resolve(None, cuda) is True


def test_real_out_of_memory_is_classified_and_halved(cuda):
    """A real torch.OutOfMemoryError (an allocation past the card's memory)
    is ResourceExhaustedError to the chain, which halves the chunk; and the
    robust full domain answers bit-exact after the halvings."""
    from distributed_point_functions_tpu_torch.ops import degrade
    from distributed_point_functions_tpu_torch.utils.errors import ResourceExhaustedError

    total = torch.cuda.get_device_properties(cuda).total_memory
    with pytest.raises(torch.OutOfMemoryError) as ei:
        torch.empty(2 * total, dtype=torch.uint8, device=cuda)
    assert isinstance(degrade.classify_exception(ei.value), ResourceExhaustedError)
    torch.cuda.empty_cache()

    dpf = port.DistributedPointFunction.create(port.DpfParameters(12, port.Int(64)))
    keys, _ = dpf.generate_keys_batch([1, 2, 3, 4], [[5, 6, 7, 8]],
                                      seeds=np.arange(32, dtype=np.uint32).reshape(4, 2, 4))
    calls = []
    real = evaluator.full_domain_evaluate

    def oom_over_two(dpf_, keys_, *a, key_chunk=32, **kw):
        calls.append(key_chunk)
        if key_chunk > 2:
            torch.empty(2 * total, dtype=torch.uint8, device=cuda)  # a real OOM
        return real(dpf_, keys_, *a, key_chunk=key_chunk, **kw)

    evaluator.full_domain_evaluate = oom_over_two
    try:
        got = degrade.full_domain_evaluate_robust(
            dpf, keys, key_chunk=8, device=cuda,
            policy=degrade.DegradationPolicy(backoff_seconds=0.0))
    finally:
        evaluator.full_domain_evaluate = real
    assert calls == [8, 4, 2]
    assert np.array_equal(got, evaluator.full_domain_evaluate(dpf, keys, device="cpu"))


def _served_requests(op):
    """Small requests of one op for the serving legs: (requests, kernels
    the card must launch)."""
    from distributed_point_functions_tpu_torch import gates
    from distributed_point_functions_tpu_torch.serving import Request

    rng = np.random.default_rng(len(op))
    seeds = lambda n: rng.integers(0, 2**32, size=(n, 2, 4), dtype=np.uint32)
    if op in ("full_domain", "evaluate_at"):
        dpf = port.DistributedPointFunction.create(port.DpfParameters(12, port.Int(64)))
        keys, _ = dpf.generate_keys_batch([5, 77, 4095], [[1, 2, 3]], seeds=seeds(3))
        if op == "full_domain":
            return [Request.full_domain(dpf, keys[:1]), Request.full_domain(dpf, keys[1:])]
        return [Request.evaluate_at(dpf, keys[:2], [5, 6]), Request.evaluate_at(dpf, keys[2:], [4095])]
    if op == "dcf":
        dcf = port.DistributedComparisonFunction.create(12, port.Int(64))
        keys, _ = dcf.generate_keys_batch([9, 3000], [4, 5], seeds=seeds(2))
        return [Request.dcf(dcf, keys[:1], [8, 9]), Request.dcf(dcf, keys[1:], [2999, 4000])]
    if op == "gate":
        gate = gates.DReluGate.create(12)
        key = gate.gen(77, [5], prng=gates.CounterRng(b"served"),
                       dcf_seeds=[(11, 22)] * gate.num_components)[0]
        return [Request.gate(gate, key, [1, 2]), Request.gate(gate, key, [3000])]
    if op == "pir":
        dpf = port.DistributedPointFunction.create(port.DpfParameters(12, port.XorWrapper(128)))
        keys, _ = dpf.generate_keys_batch([1, 2, 4000], [(1 << 128) - 1], seeds=seeds(3))
        db = rng.integers(0, 2**32, size=(4096, 4), dtype=np.uint32)
        return [Request.pir(dpf, keys[:2], db), Request.pir(dpf, keys[2:], db)]
    if op == "hierarchical":
        dpf = port.DistributedPointFunction.create_incremental(
            [port.DpfParameters(i + 1, port.Int(64)) for i in range(6)])
        keys, _ = dpf.generate_keys_batch([5, 40], [[1, 1]] * 6, seeds=seeds(2))
        plan = hierarchical.bitwise_hierarchy_plan(6, [5, 40])
        return [Request.hierarchical(dpf, keys[:1], plan), Request.hierarchical(dpf, keys[1:], plan)]
    dpf = port.DistributedPointFunction.create(port.DpfParameters(20, port.Int(64)))
    return [Request.keygen(dpf, [1, 2], [3]), Request.keygen(dpf, [99], [4])]


SERVED = [("full_domain", None), ("evaluate_at", "walk"), ("evaluate_at", "walkkernel"),
          ("dcf", "walk"), ("dcf", "walkkernel"), ("gate", "walk"), ("pir", "fold"),
          ("pir", "megakernel"), ("hierarchical", "fused"), ("hierarchical", "hierkernel"),
          ("keygen", "megakernel"), ("keygen", "perlevel")]


@pytest.mark.parametrize("op, mode", SERVED, ids=[f"{o}-{m}" for o, m in SERVED])
def test_served_batch_on_the_card_matches_the_cpu(cuda, op, mode):
    """One merged batch through FrontDoor(engine="device") on the card (the
    default device) equals the same door on the CPU, and launches kernels;
    keygen's random seeds differ between the doors, so its pairs are checked
    by their reconstruction instead."""
    from distributed_point_functions_tpu_torch import serving
    from distributed_point_functions_tpu_torch.serving import wire

    def serve(device):
        door = serving.FrontDoor(engine="device", mode=mode, device=device, width_target=4,
                                 key_chunk=2, max_wait_ms=1.0)
        aes_cuda.reset_launch_counts()
        out = door.serve(_served_requests(op), timeout=600)
        assert len(door.batches) == 1 and door.batches[0]["choice"].startswith("device")
        return out, {k.name: k.launches for k in aes_cuda.KERNELS if k.launches}

    on_card, launches = serve(None)
    assert launches, "no kernel launched on the card"
    if op == "keygen":
        reqs = _served_requests(op)
        dpf = reqs[0].obj
        for blobs, req in zip(on_card, reqs):
            k0, k1 = wire.keygen_keys_from_arrays(blobs)
            for i, alpha in enumerate(req.points):
                s = (int(dpf.evaluate_at(k0[i], 0, [alpha])[0])
                     + int(dpf.evaluate_at(k1[i], 0, [alpha])[0])) % (1 << 64)
                assert s == req.betas[0][i]
        return
    on_cpu, cpu_launches = serve("cpu")
    assert not cpu_launches
    for a, b in zip(on_card, on_cpu):
        for x, y in zip(a if isinstance(a, list) else [a], b if isinstance(b, list) else [b]):
            assert np.array_equal(np.asarray(x), np.asarray(y))


def test_two_servers_on_the_card_reconstruct_pir(cuda):
    from distributed_point_functions_tpu_torch import serving

    reqs = _served_requests("pir")
    dpf, db = reqs[0].obj, reqs[0].db
    k0 = dpf.generate_keys_batch([7, 4095, 0, 1234], [(1 << 128) - 1],
                                 seeds=np.arange(32, dtype=np.uint32).reshape(4, 2, 4))
    params = dpf.validator.parameters
    with serving.DpfServer(engine="device", key_chunk=2) as a, \
            serving.DpfServer(engine="device", key_chunk=2) as b:
        for srv in (a, b):
            srv.register_db("db", db)
        with serving.TwoServerClient([("127.0.0.1", a.port), ("127.0.0.1", b.port)]) as tsc:
            r0, r1 = tsc.pir(params, k0, "db", deadline=600)
        assert a.door.device.type == "cuda"
    assert np.array_equal(r0 ^ r1, db[[7, 4095, 0, 1234]])


@pytest.mark.parametrize("mode", hierarchical.MODES)
def test_stream_window_on_the_card_matches_the_cpu(cuda, mode, tmp_path):
    """One heavy-hitter stream window advanced on the card (the stream's
    default device) in each mode equals the same window on the CPU, level
    for level, share for share, and launches that mode's kernels (K2 and
    K4 in mode "fused", K8 in mode "hierkernel")."""
    from distributed_point_functions_tpu_torch import serving
    from distributed_point_functions_tpu_torch.protos import serialization as ser

    cfg = serving.StreamConfig.bitwise("card", 12, 2, 2, window_keys=64, mode=mode)
    dpf = port.DistributedPointFunction.create_incremental(list(cfg.parameters))
    rng = np.random.default_rng(41)
    values = [int(v) for v in rng.choice([5, 5, 5, 900, 900, 4000, 17, 2048], size=64)]
    k0, k1 = dpf.generate_keys_batch(values, [[1] * 64] * len(cfg.parameters),
                                     seeds=rng.integers(0, 2**32, size=(64, 2, 4),
                                                        dtype=np.uint32))
    blobs = [[ser.serialize_dpf_key(k, cfg.parameters) for k in ks] for ks in (k0, k1)]

    def run(device, where):
        leader = serving.HeavyHitterStream(cfg, str(where / "l"), peer=("127.0.0.1", 1),
                                           device=device)
        follower = serving.HeavyHitterStream(cfg, str(where / "f"), device=device)
        leader.ingest(cfg.parameters, blobs[0], "b-0", flush=True)
        follower.ingest(cfg.parameters, blobs[1], "b-0", flush=True)
        leader._peer_level = lambda w, member, trail: follower.aggregate(
            w.generation, list(member), trail)
        aes_cuda.reset_launch_counts()
        with leader._lock:
            w = leader._pending_locked()[0]
        leader._advance_window(w)
        launches = {k.name: k.launches for k in aes_cuda.KERNELS if k.launches}
        rec = leader.snapshot()["published"][0]
        leader.stop()
        follower.stop()
        return (rec["prefixes"], rec["counts"]), launches

    on_card, launches = run(None, tmp_path / "card")
    on_cpu, cpu_launches = run("cpu", tmp_path / "cpu")
    assert on_card == on_cpu and not cpu_launches
    want = (aes_cuda.K8.name,) if mode == "hierkernel" else (aes_cuda.K2.name, aes_cuda.K4.name)
    assert set(want) <= set(launches), launches
    counts = {int(p): int(c) for p, c in zip(*on_card)}
    assert counts == {v: c for v, c in collections.Counter(values).items() if c >= 2}


def test_one_replica_fleet_on_the_card_round_trip(cuda, tmp_path):
    """A FleetProxy over a ReplicaPool of one port server process on the
    card (--device cuda --engine device): an EvaluateAt batch through the
    proxy reconstructs, and the proxy's merged launches are the replica's
    and show the walk's kernels."""
    from distributed_point_functions_tpu_torch import serving

    dpf = port.DistributedPointFunction.create(port.DpfParameters(10, port.Int(64)))
    alphas = [3, 77, 1000, 512]
    k0, k1 = dpf.generate_keys_batch(alphas, [[7] * 4],
                                     seeds=np.arange(32, dtype=np.uint32).reshape(4, 2, 4))
    params = dpf.validator.parameters
    pools = [serving.ReplicaPool(replicas=1, server_args=["--engine", "device"],
                                 base_dir=str(tmp_path / f"p{p}"), device="cuda")
             for p in (0, 1)]
    proxies = []
    try:
        for pool in pools:
            pool.start(timeout=600)
            proxies.append(serving.FleetProxy(pool.endpoints).start())
        with serving.TwoServerClient([("127.0.0.1", px.port) for px in proxies]) as tsc:
            tsc.wait_ready(timeout=600)
            s0, s1 = tsc.evaluate_at(params, (k0, k1), alphas + [0, 5], deadline=600)
            st = tsc.clients[0].stats()
        total = (s0.astype(np.uint64)[..., 0] | (s0.astype(np.uint64)[..., 1] << np.uint64(32))) \
            + (s1.astype(np.uint64)[..., 0] | (s1.astype(np.uint64)[..., 1] << np.uint64(32)))
        for i, a in enumerate(alphas):
            assert [int(v) for v in total[i]] == [7 if p == a else 0 for p in alphas + [0, 5]]
        direct = serving.DpfClient("127.0.0.1", pools[0].ports[0]).stats()["launches"]
        assert st["launches"] == direct
        assert direct[aes_cuda.K6.name] + direct[aes_cuda.K7.name] > 0
    finally:
        for px in proxies:
            px.stop()
        for pool in pools:
            pool.stop()


def _mesh_paths(mesh, dev):
    """The multi-device paths on `mesh` against one device `dev`: the
    mesh megakernel PIR, the sharded PIR in both modes, the sharded full
    domain and EvaluateUntil on the mesh, with K5, K6, K2, K3 and K4
    launched on the mesh's paths."""
    from distributed_point_functions_tpu_torch.parallel import sharded

    dpf = port.DistributedPointFunction.create(port.DpfParameters(14, port.XorWrapper(128)))
    rng = np.random.default_rng(22)
    targets = [int(a) for a in rng.integers(0, 1 << 14, size=9)]
    keys, _ = dpf.generate_keys_batch(targets, [[(1 << 128) - 1] * 9],
                                      seeds=rng.integers(0, 2**32, size=(9, 2, 4), dtype=np.uint32))
    db = rng.integers(0, 2**32, size=(1 << 14, 4), dtype=np.uint32)
    megakernel = pir.MODES[1]
    want = pir.pir_query_batch_chunked(dpf, keys, db, mode=megakernel, key_chunk=4, device=dev)
    aes_cuda.reset_launch_counts()
    mdb = pir.prepare_pir_database(dpf, db, order="megakernel", mesh=mesh)
    got = pir.pir_query_batch_chunked(dpf, keys, mdb, mode=megakernel, key_chunk=4, mesh=mesh,
                                      integrity=True)
    assert np.array_equal(got, want)
    # Three chunks of 4 keys (the probe makes 10, padded to the 'keys' axis).
    assert aes_cuda.K5.launches == 3 * mesh.size
    for mode, kernels in (("expand", (aes_cuda.K6, aes_cuda.K2, aes_cuda.K3)),
                          ("walk", (aes_cuda.K6, aes_cuda.K4))):
        aes_cuda.reset_launch_counts()
        assert np.array_equal(sharded.pir_query_batch(dpf, keys, db, mesh, mode=mode), want)
        assert all(k.launches for k in kernels), mode
    mdpf = port.DistributedPointFunction.create(port.DpfParameters(12, port.IntModN(64, 2**64 - 59)))
    mkeys, _ = mdpf.generate_keys_batch([5, 4000, 77], [[1, 2, 3]],
                                        seeds=rng.integers(0, 2**32, size=(3, 2, 4), dtype=np.uint32))
    full = sharded.sharded_full_domain_evaluate(mdpf, mkeys, mesh)
    assert all(t.device == d for row, drow in zip(full.shards, mesh.devices)
               for t, d in zip(row, drow))
    assert np.array_equal(full.numpy(), evaluator.full_domain_evaluate(mdpf, mkeys, device=dev,
                                                                       integrity=False))
    hdpf = port.DistributedPointFunction.create_incremental(
        [port.DpfParameters(l, port.Int(64)) for l in (4, 8, 12)])
    hkeys, _ = hdpf.generate_keys_batch([9, 3000], [[1, 2]] * 3,
                                        seeds=rng.integers(0, 2**32, size=(2, 2, 4), dtype=np.uint32))
    a = hierarchical.BatchedContext.create(hdpf, hkeys)
    b = hierarchical.BatchedContext.create(hdpf, hkeys)
    for h, prefixes in enumerate([[], [0, 9, 11], [150, 151, 187]]):
        assert np.array_equal(hierarchical.evaluate_until_batch(a, h, prefixes, mesh=mesh),
                              hierarchical.evaluate_until_batch(b, h, prefixes, device=dev))


def test_mesh_on_one_card_matches_one_device(cuda):
    """A 2 x 2 mesh whose four shards all name the one card runs every line
    of the multi-device code there, and equals one device."""
    from distributed_point_functions_tpu_torch.parallel import sharded

    _mesh_paths(sharded.make_mesh(2, 2, devices=[torch.device("cuda:0")] * 4),
                torch.device("cuda:0"))


def test_mesh_over_two_cards_matches_one_device(cuda):
    """A 1 x 2 mesh over two distinct cards (each shard launching on its
    own card, the partials copied to the first) equals one device."""
    from distributed_point_functions_tpu_torch.parallel import sharded

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    _mesh_paths(sharded.make_mesh(1, 2), torch.device("cuda:0"))


@pytest.mark.parametrize("mode", ["levels", "fused", "walk", "fold", "megakernel", "walkkernel",
                                  "hierkernel", "supervisor", "router", "keygen", "sharded"])
def test_device_check_on_the_card(cuda, mode):
    """Each mode of the device check verifies on the card (hierkernel reads
    its shape as keys x levels)."""
    from distributed_point_functions_tpu_torch.utils import integrity

    shapes = ((8, 12),) if mode == "hierkernel" else ((16, 12),)
    lines = []
    assert integrity.run_device_check(shapes=shapes, mode=mode, report=lines.append) == 0, lines


def test_device_check_counts_an_injected_fault_on_the_card(cuda):
    from distributed_point_functions_tpu_torch.utils import faultinject, integrity

    with integrity.capture_events() as events:
        with faultinject.inject(faultinject.FaultPlan(stage="seeds", bit=11, key_row=1)):
            bad = integrity.run_device_check(shapes=((8, 12),), report=lambda s: None,
                                             selftest=False)
    assert bad == 1 and [e.kind for e in events] == ["corruption"]
