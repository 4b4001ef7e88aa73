"""The PyTorch/CUDA port on a CUDA card: kernels against their plain
versions, and the fold and PIR paths through the kernels against the same
paths on the CPU.

Every test here needs a card and skips without one. The file imports no
JAX, so on a machine without JAX it runs without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import distributed_point_functions_tpu_torch as port
from distributed_point_functions_tpu_torch.ops import aes_cuda, backend_torch, evaluator
from distributed_point_functions_tpu_torch.ops.aes_torch import as_words, from_words
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


@pytest.mark.parametrize("w", [1, 3, 40, 1037])
def test_kernels_match_plain_versions(cuda, w):
    """K2, K3 and K4 on the card equal their plain versions on the same
    tensors, ragged widths included; each launch is counted once."""
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
    assert [k.launches for k in aes_cuda.KERNELS] == [1, 1, 1]


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
