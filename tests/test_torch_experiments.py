"""The port's sparse-histogram experiments
(``distributed_point_functions_tpu_torch/experiments/``) against the JAX
package's CLI (``experiments/gen_data.py``, ``experiments/
synthetic_data_benchmarks.py``, loaded by path) and its host engine, on the
CPU.

- ``gen_data``: the same bucket ids for every skew, and the committed
  4096-nonzero fixtures regenerated byte for byte;
- ``read_nonzeros``, ``compute_prefixes`` and ``compute_levels_to_evaluate``
  equal to the JAX CLI's at log-domain 20 on the committed fixtures and at
  log-domain 128 (U128 arrays) on a 512-nonzero fixture;
- ``run_hierarchical`` and ``run_direct``: the port's native host engine
  on a committed fixture, and the device path's plain versions on a small
  one, each equal level by level to the JAX package's host engine on the
  same key, dealt by the JAX package and carried across as wire bytes.

Nothing here compiles JAX. Every comparison is exact.
"""

import functools
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from distributed_point_functions_tpu.core import host_eval as jax_host
from distributed_point_functions_tpu.core.dpf import DistributedPointFunction as JaxDpf
from distributed_point_functions_tpu.core.params import DpfParameters as JaxParams
from distributed_point_functions_tpu.core.value_types import Int as JaxInt
from distributed_point_functions_tpu.ops import hierarchical as jax_hier
from distributed_point_functions_tpu.protos import serialization as jax_ser
from distributed_point_functions_tpu_torch.core import uint128
from distributed_point_functions_tpu_torch.experiments import gen_data
from distributed_point_functions_tpu_torch.experiments import synthetic_data_benchmarks as sdb
from distributed_point_functions_tpu_torch.protos import serialization as port_ser
from distributed_point_functions_tpu_torch.utils.errors import UnavailableError
from torch_fold_case import one_torch_thread  # noqa: F401 (autouse fixture)

REPO = Path(__file__).resolve().parent.parent
FIXTURES = REPO / "experiments" / "data"
SKEWS = {"0.1": 0.1, "0.5": 0.5, "uniform": "uniform"}
WIDE_NONZEROS = 512
FACTORS = (2, 4)


def _load(name: str):
    spec = importlib.util.spec_from_file_location(
        f"jax_experiments_{name}", REPO / "experiments" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@functools.lru_cache(maxsize=None)
def jax_cli():
    return _load("synthetic_data_benchmarks")


@functools.lru_cache(maxsize=None)
def jax_gen():
    return _load("gen_data")


def same_arrays(a: np.ndarray, b: np.ndarray) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and bool(np.all(a == b))


@pytest.mark.parametrize("log_domain,num", [(12, 300), (128, 64)])
@pytest.mark.parametrize("skew", sorted(SKEWS))
def test_sample_unique_matches_jax(skew, log_domain, num):
    s = SKEWS[skew]
    assert gen_data.sample_unique(num, log_domain, s) == jax_gen().sample_unique(
        num, log_domain, s)


def test_regenerated_fixtures_are_the_committed_ones(tmp_path):
    assert gen_data.main(["--log_domain_size", "20", "--num_nonzeros", "4096",
                          "--out_dir", str(tmp_path)]) == 0
    for skew in SKEWS:
        name = gen_data.fixture_name(20, 4096, skew)
        assert (tmp_path / name).read_bytes() == (FIXTURES / name).read_bytes(), name


@functools.lru_cache(maxsize=None)
def wide_fixture() -> str:
    """A 512-nonzero fixture at log-domain 128, skew 0.1 (gen_data's file)."""
    import tempfile

    out = tempfile.mkdtemp(prefix="dpf-experiments-")
    return gen_data.write_fixture(out, 128, WIDE_NONZEROS, "0.1")


def _fixture(skew: str, log_domain: int) -> str:
    if log_domain == 128:
        return wide_fixture()
    return str(FIXTURES / gen_data.fixture_name(20, 4096, skew))


@pytest.mark.parametrize("log_domain,skew", [(20, "0.1"), (20, "0.5"), (20, "uniform"),
                                             (128, "0.1")])
def test_cli_helpers_match_jax(log_domain, skew):
    path = _fixture(skew, log_domain)
    jc = jax_cli()
    mine, theirs = sdb.read_nonzeros(path, log_domain), jc.read_nonzeros(path, log_domain)
    assert mine.dtype == (uint128.U128 if log_domain >= 64 else np.uint64)
    assert same_arrays(mine, theirs)
    pm, pt = sdb.compute_prefixes(mine, log_domain), jc.compute_prefixes(theirs, log_domain)
    assert len(pm) == len(pt) == log_domain + 1
    assert all(same_arrays(a, b) for a, b in zip(pm, pt))
    for factor in FACTORS:
        assert (sdb.compute_levels_to_evaluate(pm, log_domain, factor)
                == jc.compute_levels_to_evaluate(pt, log_domain, factor))
    # Unsorted input with repeats: sorted once, the same prefixes.
    shuffled = np.concatenate([mine[::-1], mine[:7]])
    assert all(same_arrays(a, b) for a, b in zip(sdb.compute_prefixes(shuffled, log_domain), pm))


def _keys(levels, alpha):
    """Both parties' keys of beta = 1 dealt by the JAX package over `levels`,
    carried to the port as wire bytes."""
    params = [JaxParams(lds, JaxInt(32)) for lds in levels]
    jdpf = (JaxDpf.create(params[0]) if len(levels) == 1
            else JaxDpf.create_incremental(params))
    pair = (jdpf.generate_keys(alpha, 1) if len(levels) == 1
            else jdpf.generate_keys_incremental(alpha, [1] * len(levels)))
    ported = [port_ser.parse_dpf_key(jax_ser.serialize_dpf_key(k, params)) for k in pair]
    return jdpf, list(pair), ported


def _jax_levels(jdpf, key, plan) -> list:
    ctx = jax_hier.BatchedContext.create(jdpf, [key])
    return [np.asarray(jax_hier.evaluate_until_batch(ctx, h, p, engine="host"))
            for h, p in plan]


def _reconstructs(s0, s1, hit) -> bool:
    return bool(np.array_equal((s0.astype(np.uint64) + s1) % (1 << 32), hit.astype(np.uint64)))


@functools.lru_cache(maxsize=None)
def histogram(log_domain: int, num: int, skew: str):
    """A small histogram's nonzeros, prefixes and factor-4 levels."""
    values = gen_data.sample_unique(num, log_domain, SKEWS[skew])
    nz = (uint128.u128_array(values) if log_domain >= 64
          else np.array(values, dtype=np.uint64))
    prefixes = sdb.compute_prefixes(nz, log_domain)
    return nz, prefixes, sdb.compute_levels_to_evaluate(prefixes, log_domain, 4)


@pytest.mark.parametrize("case", ["host engine, committed fixture", "plain versions, fused",
                                  "plain versions, hierkernel"])
def test_run_hierarchical_matches_jax_host_engine(case):
    if case.startswith("host"):
        nz = sdb.read_nonzeros(_fixture("0.1", 20), 20)
        prefixes = sdb.compute_prefixes(nz, 20)
        levels = sdb.compute_levels_to_evaluate(prefixes, 20, 4)
        run = dict(engine="host")
    else:
        nz, prefixes, levels = histogram(14, 40, "0.5")
        run = dict(engine="device", device="cpu", mode=case.split(", ")[1])
    alpha = int(nz[len(nz) // 3])
    jdpf, jkeys, keys = _keys(levels, alpha)
    dpf = sdb.create_dpf(levels[-1], levels)
    plan = sdb.hierarchical_plan(prefixes, levels)
    shares = []
    for party in (0, 1):
        got = sdb.run_hierarchical(dpf, [keys[party]], plan, num_iterations=1, **run)
        want = _jax_levels(jdpf, jkeys[party], plan)
        assert len(got.outputs) == len(levels)
        for h, (g, w) in enumerate(zip(got.outputs, want)):
            assert g.dtype == np.uint32 and same_arrays(g, w.astype(np.uint32)), (case, party, h)
        assert (got.prepare_seconds is None) == (run["engine"] == "host")
        shares.append(got.outputs)
    for h, (lds, (_, parents)) in enumerate(zip(levels, plan)):
        cand = jax_hier.candidate_children(list(parents), levels[h - 1] if h else 0, lds)
        hit = np.asarray(cand, dtype=np.uint64) == np.uint64(alpha >> (levels[-1] - lds))
        assert hit.sum() == 1 and _reconstructs(shares[0][h][0], shares[1][h][0], hit), h


@pytest.mark.parametrize("log_domain,mode", [(20, "host"), (14, "walk"), (14, "walkkernel"),
                                             (128, "host"), (128, "walk")])
def test_run_direct_matches_jax_host_engine(log_domain, mode):
    if log_domain == 20:
        nz = sdb.read_nonzeros(_fixture("0.1", 20), 20)
    elif log_domain == 128:
        nz = sdb.read_nonzeros(wide_fixture(), 128)[:64]
    else:
        nz = histogram(14, 40, "0.5")[0]
    alpha = (uint128.u128_to_ints(nz[5:6])[0] if nz.dtype == uint128.U128 else int(nz[5]))
    jdpf, jkeys, keys = _keys([log_domain], alpha)
    dpf = sdb.create_dpf(log_domain)
    run = (dict(engine="host") if mode == "host"
           else dict(engine="device", device="cpu", mode=mode))
    shares = []
    for party in (0, 1):
        got = sdb.run_direct(dpf, [keys[party]], nz, num_iterations=1, **run)
        want = jax_host.evaluate_at_host(jdpf, [jkeys[party]], nz)
        (out,) = got.outputs
        assert out.dtype == np.uint32 and same_arrays(out, want.astype(np.uint32)), party
        assert (got.host_seconds is None) == (mode == "host")
        shares.append(out[0])
    hit = np.zeros(len(nz), dtype=bool)
    hit[5] = True
    assert _reconstructs(shares[0], shares[1], hit)


def test_hierkernel_refuses_a_plan_k8_cannot_express():
    """Ten Int(32) levels 7 bits apart put 68 tree levels into one window of
    16 advances, past K8's 62: mode hierkernel raises, as the JAX package's
    does, and does not run another mode."""
    nz, prefixes, _ = histogram(70, 16, "uniform")
    levels = list(range(7, 71, 7))
    _, _, keys = _keys(levels, uint128.u128_to_ints(nz[:1])[0])
    dpf = sdb.create_dpf(70, levels)
    with pytest.raises(NotImplementedError):
        sdb.run_hierarchical(dpf, [keys[0]], sdb.hierarchical_plan(prefixes, levels),
                             mode="hierkernel", device="cpu")


def test_engine_auto_never_falls_back(monkeypatch, capsys):
    assert sdb.resolve_engine("auto", None) == "device"
    assert sdb.resolve_engine("auto", "cuda") == "device"
    assert sdb.resolve_engine("auto", "cpu") == "host"
    assert sdb.resolve_engine("device", "cpu") == "device"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fixture = str(FIXTURES / gen_data.fixture_name(20, 4096, "0.1"))
    for extra in ([], ["--only_nonzeros"]):
        with pytest.raises(UnavailableError):
            sdb.main(["--input", fixture, "--num_iterations", "1", *extra])
    with pytest.raises(SystemExit):
        sdb.main(["--only_nonzeros", "--mode", "fused", "--device", "cpu"])


@pytest.mark.parametrize("extra", [[], ["--only_nonzeros"]])
def test_main_prints_the_jax_record(extra, capsys):
    """The last line is the JAX CLI's JSON record (its keys, with the
    device in place of the JAX platform)."""
    import json

    fixture = str(FIXTURES / gen_data.fixture_name(20, 4096, "uniform"))
    assert sdb.main(["--input", fixture, "--log_domain_size", "20", "--max_expansion_factor",
                     "4", "--num_iterations", "2", "--device", "cpu", *extra]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["bench"] == "experiments" and rec["unit"] == "s/key/iteration"
    assert rec["mode"] == ("direct" if extra else "hierarchical")
    assert rec["num_nonzeros"] == 4096 and rec["engine"] == "host" and rec["device"] == "cpu"
    assert rec["levels"][-1] == 20 and (len(rec["levels"]) == 1) == bool(extra)
    assert rec["value"] > 0
