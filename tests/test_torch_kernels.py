"""The PyTorch/CUDA port's kernel modules against the JAX package, on the CPU.

K1 (bitsliced AES, ops/aes_torch.py), K2/K3/K4 (ops/backend_torch.py, the
plain versions the CUDA wrappers in ops/aes_cuda.py run for CPU tensors) are
held bit-exact against ``jax.vmap(backend_jax.expand_one_level)``,
``jax.vmap(backend_jax.hash_value_planes)`` and their composition. Every
comparison is exact (``np.array_equal``): the outputs are integers. The
CUDA sources themselves are built with the host compiler and held against
the plain versions too; the kernels on the card are tests/test_torch_cuda.py.
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
from distributed_point_functions_tpu.core import constants as jax_constants
from distributed_point_functions_tpu.ops import aes_jax, backend_jax
from distributed_point_functions_tpu_torch.core import aes_numpy, backend_numpy, constants
from distributed_point_functions_tpu_torch.ops import aes_cuda, aes_torch, backend_torch
from distributed_point_functions_tpu_torch.utils.errors import InvalidArgumentError

RNG_SEED = 20261016
K = 3  # keys
WIDTHS = (3, 40)  # lane words: a ragged width and one past a warp

_jax_expand = jax.jit(jax.vmap(backend_jax.expand_one_level))
_jax_hash = jax.jit(jax.vmap(backend_jax.hash_value_planes))


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
    want = np.stack([np.asarray(aes_jax.pack_to_planes(jnp.asarray(b))) for b in x])
    assert np.array_equal(aes_torch.from_words(planes), want)
    assert np.array_equal(aes_torch.from_words(aes_torch.unpack_from_planes(planes)), x)
    bits = np.random.default_rng(n + 1).integers(0, 2, size=(2, n)).astype(bool)
    assert np.array_equal(aes_torch.pack_bit_mask(bits), aes_jax.pack_bit_mask(bits))
    mask = aes_torch.pack_bit_mask(bits)
    assert np.array_equal(
        aes_torch.from_words(backend_torch.unpack_mask_device(words(mask))),
        np.asarray(jax.vmap(backend_jax.unpack_mask_device)(jnp.asarray(mask))),
    )


@pytest.mark.parametrize("w", WIDTHS)
def test_k2_expand_one_level_matches_jax(w):
    args = expand_inputs(w, RNG_SEED + w)
    want = [np.asarray(a) for a in _jax_expand(*map(jnp.asarray, args))]
    for fn in (backend_torch.expand_one_level, aes_cuda.expand_one_level):
        got = fn(*map(words, args))
        assert np.array_equal(aes_torch.from_words(got[0]), want[0])
        assert np.array_equal(aes_torch.from_words(got[1]), want[1])


@pytest.mark.parametrize("w", [2 * w for w in WIDTHS])
def test_k4_hash_value_planes_matches_jax(w):
    planes = np.random.default_rng(RNG_SEED - w).integers(
        0, 2**32, size=(K, 128, w), dtype=np.uint32
    )
    want = np.asarray(_jax_hash(jnp.asarray(planes)))
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
    children, control = _jax_expand(*map(jnp.asarray, args))
    want = (np.asarray(_jax_hash(children)), np.asarray(control))
    for fn in (backend_torch.expand_and_hash_last_level, aes_cuda.expand_and_hash_last_level):
        got = fn(*map(words, args))
        assert np.array_equal(aes_torch.from_words(got[0]), want[0])
        assert np.array_equal(aes_torch.from_words(got[1]), want[1])


def test_wrappers_take_the_plain_version_only_for_cpu_tensors():
    """On CPU tensors the wrappers run the plain versions and launch
    nothing; operands they cannot take are refused before any dispatch."""
    aes_cuda.reset_launch_counts()
    args = [words(a) for a in expand_inputs(3, 1)]
    aes_cuda.expand_one_level(*args)
    aes_cuda.hash_value_planes(args[0])
    assert [k.launches for k in aes_cuda.KERNELS] == [0, 0, 0]
    with pytest.raises(InvalidArgumentError, match="int32"):
        aes_cuda.hash_value_planes(args[0].to(torch.int64))
    with pytest.raises(InvalidArgumentError, match="shape"):
        aes_cuda.expand_one_level(args[0], args[1][:, :2], *args[2:])
    with pytest.raises(InvalidArgumentError, match="one CUDA device"):
        aes_cuda.hash_value_planes(torch.empty((1, 128, 1), dtype=torch.int32, device="meta"))
    with pytest.raises(InvalidArgumentError, match="one CUDA device"):
        aes_cuda.expand_one_level(args[0].to("meta"), *args[1:])


def test_round_key_header_holds_the_plain_versions_tables():
    """The constant-memory tables the kernels are built with are the round
    keys the plain version uses."""
    nums = re.findall(r"0xffffffffu|0u", aes_cuda.round_key_header().split("{", 1)[1])
    got = np.array([0xFFFFFFFF if n != "0u" else 0 for n in nums], np.uint32)
    want = np.stack(
        [backend_torch._rk_np(t) for t in ("left", "right", "value")]
    ).reshape(-1)
    assert np.array_equal(got, want)


_HARNESS = r"""
#include <cstdio>
#include <vector>
#include "expand_rows.cuh"
// stdin: mode K W, then the operands; stdout: the outputs.
static std::vector<uint32_t> rd(size_t n) {
  std::vector<uint32_t> v(n);
  if (fread(v.data(), 4, n, stdin) != n) throw 1;
  return v;
}
int main() {
  int hdr[3];
  if (fread(hdr, 4, 3, stdin) != 3) return 1;
  const int mode = hdr[0], K = hdr[1], W = hdr[2];
  uint32_t stash[128];
  auto planes = rd(size_t(K) * 128 * W);
  if (mode == 2) {
    std::vector<uint32_t> out(planes.size());
    for (int k = 0; k < K; ++k)
      for (int w = 0; w < W; ++w)
        dpf::value_hash_word(planes.data(), out.data(), k, w, W, stash, 1);
    fwrite(out.data(), 4, out.size(), stdout);
    return 0;
  }
  auto control = rd(size_t(K) * W), cw = rd(size_t(K) * 128), ccl = rd(K), ccr = rd(K);
  std::vector<uint32_t> op(size_t(K) * 256 * W), oc(size_t(K) * 2 * W);
  for (int k = 0; k < K; ++k)
    for (int c = 0; c < 2; ++c)
      for (int w = 0; w < W; ++w) {
        if (mode == 0)
          dpf::expand_word<false>(planes.data(), control.data(), cw.data(), ccl.data(),
                                  ccr.data(), op.data(), oc.data(), k, c, w, W, stash, 1);
        else
          dpf::expand_word<true>(planes.data(), control.data(), cw.data(), ccl.data(),
                                 ccr.data(), op.data(), oc.data(), k, c, w, W, stash, 1);
      }
  fwrite(op.data(), 4, op.size(), stdout);
  fwrite(oc.data(), 4, oc.size(), stdout);
}
"""


def test_csrc_kernel_bodies_on_the_host_compiler(tmp_path):
    """csrc/expand_rows.cuh and aes_rows.cuh — the bodies K2, K3 and K4
    launch per lane word — built with g++ and run over every (key, child,
    word) equal the plain versions, ragged width included."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ on this host")
    (tmp_path / "dpf_round_keys.h").write_text(aes_cuda.round_key_header())
    (tmp_path / "harness.cpp").write_text(_HARNESS)
    exe = tmp_path / "harness"
    subprocess.run(
        [gxx, "-O1", "-std=c++17", "-Wno-unknown-pragmas", "-I", str(tmp_path),
         "-I", str(aes_cuda.CSRC), "-o", str(exe), str(tmp_path / "harness.cpp")],
        check=True, capture_output=True, timeout=300,
    )
    w = WIDTHS[0]
    planes, control, cw, ccl, ccr = expand_inputs(w, 7)

    def run(mode, *arrays):
        head = np.array([mode, K, w], np.int32).tobytes()
        out = subprocess.run(
            [str(exe)], input=head + b"".join(a.tobytes() for a in arrays),
            check=True, capture_output=True, timeout=60,
        ).stdout
        return np.frombuffer(out, np.uint32)

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
