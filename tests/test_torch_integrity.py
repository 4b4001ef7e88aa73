"""The port's runtime integrity layer (utils/integrity.py, utils/faultinject.py,
utils/errors.py, ops/degrade.classify_exception) against the JAX package's.

The known-answer tables and the lane diagnosis are compared with the JAX
module's; the sentinel probe is driven through the port's entry points on
the CPU (``device="cpu"``) under every fault class, and must detect each.
"""

import numpy as np
import pytest
import torch

from distributed_point_functions_tpu.utils import errors as jax_errors
from distributed_point_functions_tpu.utils import integrity as jax_integrity
import distributed_point_functions_tpu_torch as port
from distributed_point_functions_tpu_torch.core import host_eval
from distributed_point_functions_tpu_torch.ops import aes_cuda, degrade, evaluator
from distributed_point_functions_tpu_torch.parallel import pir
from distributed_point_functions_tpu_torch.utils import errors, faultinject, integrity
from distributed_point_functions_tpu_torch.utils.errors import (
    DataCorruptionError,
    DataLossError,
    InternalError,
    InvalidArgumentError,
    ResourceExhaustedError,
    UnavailableError,
)
from torch_fold_case import one_torch_thread  # noqa: F401 (autouse fixture)


@pytest.fixture()
def small_dpf():
    dpf = port.DistributedPointFunction.create(port.DpfParameters(10, port.Int(64)))
    keys, _ = dpf.generate_keys_batch([3, 700, 901], [[5, 9, 40]],
                                      seeds=np.arange(24, dtype=np.uint32).reshape(3, 2, 4))
    return dpf, keys


def host_limbs(dpf, keys):
    return host_eval.values_to_limbs(host_eval.full_domain_evaluate_host(dpf, keys), 64)


def fde(dpf, keys, **kw):
    return evaluator.full_domain_evaluate(dpf, keys, device="cpu", integrity=True, **kw)


# ---------------------------------------------------------------------------
# Taxonomy, switches, tables
# ---------------------------------------------------------------------------


def test_error_taxonomy_matches_jax():
    """Every JAX error class has a port class of the same name and the same
    bases' names; DataCorruptionError carries the same diagnostics."""
    names = [n for n in dir(jax_errors) if n.endswith("Error")]
    assert names
    for name in names:
        jcls, pcls = getattr(jax_errors, name), getattr(errors, name)
        assert [b.__name__ for b in pcls.__mro__] == [b.__name__ for b in jcls.__mro__], name
    e = DataCorruptionError("x", key_index=3, lanes=(1, 2), pattern="p", backend="cuda")
    assert (e.key_index, e.lanes, e.pattern, e.backend) == (3, [1, 2], "p", "cuda")
    assert isinstance(e, DataLossError)


def test_env_switch_strict_parsing(monkeypatch):
    monkeypatch.delenv("DPF_TPU_INTEGRITY", raising=False)
    assert integrity.enabled() is False and integrity.enabled(True) is True
    for val, want in (("1", True), ("true", True), ("ON", True),
                      ("0", False), ("no", False), ("", False)):
        monkeypatch.setenv("DPF_TPU_INTEGRITY", val)
        assert integrity.enabled() is want, val
    monkeypatch.setenv("DPF_TPU_INTEGRITY", "maybe")
    with pytest.raises(InvalidArgumentError):
        integrity.enabled()
    assert integrity.enabled(False) is False


def test_kat_tables_equal_jax_and_the_oracle():
    assert integrity._KAT_INPUTS == jax_integrity._KAT_INPUTS
    assert integrity._KAT_EXPECTED == jax_integrity._KAT_EXPECTED
    np.testing.assert_array_equal(integrity._kat_input_limbs(), jax_integrity._kat_input_limbs())
    assert (integrity._PROBE_SEEDS, integrity._PROBE_ALPHA, integrity._PROBE_BETA) == (
        jax_integrity._PROBE_SEEDS, jax_integrity._PROBE_ALPHA, jax_integrity._PROBE_BETA)
    integrity.selftest_host()


def test_selftest_passes_and_is_cached():
    integrity._selftest_done.clear()
    with integrity.capture_events() as events:
        integrity.ensure_selftest("cpu")
        integrity.ensure_selftest("cpu")
    assert [e.kind for e in events] == ["selftest-ok"]


def test_selftest_detects_miscomputing_device(monkeypatch):
    """K4 (here its plain version, the wrapper's CPU path) hashing wrong
    fails the KAT with the mismatching inputs named."""
    real = aes_cuda.hash_value_planes
    monkeypatch.setattr(aes_cuda, "hash_value_planes", lambda planes: real(planes) ^ -1)
    with pytest.raises(DataCorruptionError) as ei:
        integrity.selftest_device("cpu")
    assert ei.value.lanes == [0, 1, 2]
    monkeypatch.undo()
    integrity.selftest_device("cpu")


def test_selftest_host_drift_is_internal_error(monkeypatch):
    bad = dict(integrity._KAT_EXPECTED)
    bad["left"] = (1, 2, 3)
    monkeypatch.setattr(integrity, "_KAT_EXPECTED", bad)
    with pytest.raises(InternalError):
        integrity.selftest_host()


def _strip(msg: str) -> str:
    return msg.split(" (the ")[0]


@pytest.mark.parametrize("bad,total", [
    (np.nonzero((np.arange(1024) >> 4) & 1)[0], 1024),
    (np.nonzero((np.arange(256) >> 5) & 1)[0], 256),
    (np.array([48, 49, 50]), 256),
    (np.array([0, 3]), 256),
    (np.array([], dtype=int), 64),
    (np.array([7]), 1),
    (np.arange(16, 32), 32),
], ids=["bit4", "bit5", "common-bits", "structureless", "empty", "one", "upper-half"])
def test_diagnose_lanes_matches_jax(bad, total):
    got = integrity.diagnose_lanes(bad, total)
    want = jax_integrity.diagnose_lanes(bad, total)
    assert _strip(got) == _strip(want)


# ---------------------------------------------------------------------------
# Detection through the port's entry points
# ---------------------------------------------------------------------------


def test_detects_seed_flip(small_dpf):
    dpf, keys = small_dpf
    plan = faultinject.FaultPlan(stage="seeds", bit=7, key_row=-1)
    with faultinject.inject(plan):
        with pytest.raises(DataCorruptionError) as ei:
            fde(dpf, keys)
    assert ei.value.key_index == len(keys) and ei.value.lanes and ei.value.pattern
    assert plan.fires == 1


def test_detects_cw_flip(small_dpf):
    dpf, keys = small_dpf
    with faultinject.inject(faultinject.FaultPlan(stage="cw", bit=3, key_row=-1, level=4)):
        with pytest.raises(DataCorruptionError) as ei:
            fde(dpf, keys)
    assert 0 < len(ei.value.lanes) <= 1 << 10


def test_detects_wire_truncation(small_dpf):
    dpf, keys = small_dpf
    with faultinject.inject(faultinject.FaultPlan(stage="wire", wire_mode="truncate",
                                                  wire_arg=3)):
        with pytest.raises(DataLossError):
            fde(dpf, keys)


def test_detects_wire_bit_flip(small_dpf):
    dpf, keys = small_dpf
    with faultinject.inject(faultinject.FaultPlan(stage="wire", wire_mode="flip", wire_arg=4,
                                                  bit=2)):
        with pytest.raises(DataCorruptionError):
            fde(dpf, keys)


@pytest.mark.parametrize("pipeline", [False, True])
def test_detects_output_lane_corruption(small_dpf, pipeline):
    dpf, keys = small_dpf
    with faultinject.inject(faultinject.FaultPlan(stage="device_output", pattern="lane",
                                                  lane=5, key_row=-1)):
        with pytest.raises(DataCorruptionError) as ei:
            fde(dpf, keys, pipeline=pipeline, key_chunk=2)
    assert ei.value.lanes == [5]


def test_detects_bit4_replay(small_dpf):
    dpf, keys = small_dpf
    with faultinject.inject(faultinject.FaultPlan(stage="device_output", pattern="bit4",
                                                  key_row=-1)):
        with pytest.raises(DataCorruptionError) as ei:
            fde(dpf, keys)
    assert "index bit 4" in ei.value.pattern


def test_detects_on_evaluate_at_path(small_dpf):
    dpf, keys = small_dpf
    with faultinject.inject(faultinject.FaultPlan(stage="device_output", pattern="lane",
                                                  lane=2, key_row=-1)):
        with pytest.raises(DataCorruptionError) as ei:
            evaluator.evaluate_at_batch(dpf, keys, [0, 3, 700, 901, 1023], device="cpu",
                                        integrity=True)
    assert ei.value.lanes == [2]
    # device_output: the probe row is pulled and checked on the host.
    out = evaluator.evaluate_at_batch(dpf, keys, [0, 3, 700], device="cpu", integrity=True,
                                      device_output=True)
    assert isinstance(out, torch.Tensor) and tuple(out.shape) == (3, 3, 2)


@pytest.mark.parametrize("mode", ["fold", "megakernel", "walk", "fused"])
def test_detects_on_pir_fold_path(mode):
    dpf = port.DistributedPointFunction.create(port.DpfParameters(10, port.XorWrapper(128)))
    keys, _ = dpf.generate_keys_batch([5, 77], [[1, 2]], seeds=np.ones((2, 2, 4), np.uint32))
    db = np.random.default_rng(0).integers(0, 1 << 32, size=(1024, 4), dtype=np.uint32)
    pdb = pir.prepare_pir_database(dpf, db, order=pir.MODE_ORDER[mode], device="cpu")
    with integrity.capture_events() as events:
        clean = pir.pir_query_batch_chunked(dpf, keys, pdb, mode=mode, integrity=True)
    assert clean.shape == (2, 4)
    assert [e.kind for e in events if e.kind == "sentinel-ok"] == ["sentinel-ok"]
    with faultinject.inject(faultinject.FaultPlan(stage="device_output", pattern="lane",
                                                  lane=0, key_row=-1)):
        with pytest.raises(DataCorruptionError, match="fold"):
            pir.pir_query_batch_chunked(dpf, keys, pdb, mode=mode, integrity=True)


def test_prepared_db_natural_copy_cached():
    dpf = port.DistributedPointFunction.create(port.DpfParameters(10, port.XorWrapper(128)))
    keys, _ = dpf.generate_keys_batch([5, 77], [[1, 2]], seeds=np.ones((2, 2, 4), np.uint32))
    db = np.random.default_rng(1).integers(0, 1 << 32, size=(1024, 4), dtype=np.uint32)
    prepared = pir.prepare_pir_database(dpf, db, order="lane", device="cpu")
    a = pir.pir_query_batch_chunked(dpf, keys, prepared, integrity=True)
    np.testing.assert_array_equal(prepared._nat_host, db)
    cached = prepared._nat_host
    b = pir.pir_query_batch_chunked(dpf, keys, prepared, integrity=True)
    assert prepared._nat_host is cached
    np.testing.assert_array_equal(a, b)


def test_probe_rides_chunked_batches(small_dpf):
    dpf, keys = small_dpf
    np.testing.assert_array_equal(fde(dpf, keys, key_chunk=2), host_limbs(dpf, keys))
    with faultinject.inject(faultinject.FaultPlan(stage="seeds", bit=0, key_row=-1)):
        with pytest.raises(DataCorruptionError):
            fde(dpf, keys, key_chunk=2)


def test_codec_value_types_skip_with_event():
    dpf = port.DistributedPointFunction.create(
        port.DpfParameters(6, port.TupleType(port.Int(32), port.Int(32))))
    keys, _ = dpf.generate_keys_batch([5], [[(1, 2)]])
    with integrity.capture_events() as events:
        out = fde(dpf, keys)
    assert isinstance(out, tuple)
    assert [e.kind for e in events] == ["integrity-skip"]


def test_no_false_positives_100_clean_batches():
    dpf = port.DistributedPointFunction.create(port.DpfParameters(6, port.Int(64)))
    rng = np.random.default_rng(0xC1EA)
    with integrity.capture_events() as events:
        for _ in range(100):
            alphas = [int(x) for x in rng.integers(0, 64, size=2)]
            betas = [[int(x) for x in rng.integers(1, 1000, size=2)]]
            keys, _ = dpf.generate_keys_batch(alphas, betas)
            assert fde(dpf, keys, pipeline=False).shape == (2, 64, 2)
    kinds = {e.kind for e in events}
    assert "corruption" not in kinds
    assert sum(e.kind == "sentinel-ok" for e in events) == 100


def test_injection_off_means_no_faults():
    assert not faultinject.is_active()
    seeds = np.arange(12, dtype=np.uint32).reshape(3, 4)
    assert faultinject.corrupt_seeds(seeds) is seeds
    assert faultinject.corrupt_wire(b"abc") == b"abc"
    plan = faultinject.FaultPlan(stage="seeds")
    with faultinject.inject(plan):
        pass
    assert not faultinject.is_active() and plan.fires == 0
    with pytest.raises(InvalidArgumentError):
        faultinject.FaultPlan(stage="nowhere")


def test_fault_hooks_match_jax():
    """The corruptors change the same bits as the JAX package's."""
    from distributed_point_functions_tpu.utils import faultinject as jax_fi

    rng = np.random.default_rng(5)
    seeds = rng.integers(0, 2**32, size=(4, 4), dtype=np.uint32)
    cw = rng.integers(0, 2**32, size=(4, 6, 4), dtype=np.uint32)
    vals = rng.integers(0, 2**32, size=(3, 64, 2), dtype=np.uint32)
    blob = bytes(range(40))
    cases = [
        (dict(stage="seeds", bit=45, key_row=-2), lambda fi: fi.corrupt_seeds(seeds)),
        (dict(stage="cw", bit=70, key_row=1, level=8), lambda fi: fi.corrupt_cw(cw)),
        (dict(stage="wire", wire_mode="flip", wire_arg=7, bit=3),
         lambda fi: fi.corrupt_wire(blob)),
        (dict(stage="wire", wire_mode="truncate", wire_arg=5), lambda fi: fi.corrupt_wire(blob)),
        (dict(stage="device_output", pattern="bit4"), lambda fi: fi.corrupt_output(vals)),
        (dict(stage="device_output", pattern="lane", lane=70), lambda fi: fi.corrupt_output(vals)),
    ]
    for kw, call in cases:
        with faultinject.inject(faultinject.FaultPlan(**kw)):
            got = call(faultinject)
        with jax_fi.inject(jax_fi.FaultPlan(**kw)):
            want = call(jax_fi)
        assert np.array_equal(np.frombuffer(got, np.uint8) if isinstance(got, bytes) else got,
                              np.frombuffer(want, np.uint8) if isinstance(want, bytes) else want)


def test_event_hooks_receive_and_survive_failure(small_dpf):
    dpf, keys = small_dpf
    seen = []

    def bad_hook(ev):
        raise RuntimeError("broken operator hook")

    integrity.add_event_hook(bad_hook)
    integrity.add_event_hook(seen.append)
    try:
        out = fde(dpf, keys)
    finally:
        integrity.remove_event_hook(bad_hook)
        integrity.remove_event_hook(seen.append)
    np.testing.assert_array_equal(out, host_limbs(dpf, keys))
    assert any(e.kind == "sentinel-ok" for e in seen)


# ---------------------------------------------------------------------------
# classify_exception on PyTorch's errors
# ---------------------------------------------------------------------------


def test_classify_exception_on_torch_errors():
    oom = torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 20.00 GiB")
    assert isinstance(degrade.classify_exception(oom), ResourceExhaustedError)
    launch = RuntimeError("CUDA error: invalid configuration argument\nCUDA kernel errors "
                          "might be asynchronously reported")
    err = degrade.classify_exception(launch)
    assert isinstance(err, UnavailableError) and err.__cause__ is launch
    # A failed build of the kernels is the library's own fault: it
    # propagates, never degraded around.
    assert degrade.classify_exception(InternalError("building the kernels failed")) is None
    assert degrade.classify_exception(ValueError("a caller's bug")) is None
    for text, cls in (("RESOURCE_EXHAUSTED: x", ResourceExhaustedError),
                      ("UNAVAILABLE: x", UnavailableError),
                      ("DEADLINE_EXCEEDED: x", UnavailableError)):
        assert isinstance(degrade.classify_exception(RuntimeError(text)), cls)
    assert degrade.classify_exception(RuntimeError("some other failure")) is None
