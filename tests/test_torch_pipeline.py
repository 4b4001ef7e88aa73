"""The port's pipelined chunk executor (ops/pipeline.py) on the CPU.

``pipeline=True`` against ``pipeline=False`` bit for bit, in the same
order, on every entry point that takes it; the finalize stage off the
calling thread; drain on error; the overlap proxy (``chunk_delay``); the
drain-timeout event; ``chunk_indices`` against the JAX package's.
"""

import threading
import time

import numpy as np
import pytest
import torch

from distributed_point_functions_tpu.ops import pipeline as jax_pipeline
import distributed_point_functions_tpu_torch as port
from distributed_point_functions_tpu_torch.core import host_eval
from distributed_point_functions_tpu_torch.dcf import batch as dcf_batch
from distributed_point_functions_tpu_torch.ops import aes_torch, evaluator, pipeline
from distributed_point_functions_tpu_torch.parallel import pir
from distributed_point_functions_tpu_torch.utils import faultinject, integrity
from distributed_point_functions_tpu_torch.utils.errors import (
    DataCorruptionError,
    InvalidArgumentError,
)
from torch_fold_case import one_torch_thread  # noqa: F401 (autouse fixture)


@pytest.fixture(scope="module")
def small_dpf():
    dpf = port.DistributedPointFunction.create(port.DpfParameters(8, port.Int(64)))
    rng = np.random.default_rng(8)
    n = 7
    keys, _ = dpf.generate_keys_batch([int(a) for a in rng.integers(0, 256, size=n)],
                                      [[int(b) for b in rng.integers(1, 2**63, size=n,
                                                                     dtype=np.uint64)]],
                                      seeds=rng.integers(0, 2**32, size=(n, 2, 4),
                                                         dtype=np.uint32))
    return dpf, keys


def host_limbs(dpf, keys):
    return host_eval.values_to_limbs(host_eval.full_domain_evaluate_host(dpf, keys), 64)


def _np(items):
    out = []
    for valid, vals in items:
        vals = vals if isinstance(vals, tuple) else (vals,)
        out.append((valid, tuple(aes_torch.from_words(v).copy() for v in vals)))
    return out


def _same(a, b):
    assert len(a) == len(b)
    for (va, xa), (vb, xb) in zip(a, b):
        assert va == vb and len(xa) == len(xb)
        for p, q in zip(xa, xb):
            assert np.array_equal(p, q)


@pytest.mark.parametrize("num,chunk", [(0, 4), (3, 4), (4, 4), (9, 4), (10, 3), (1, 1)])
def test_chunk_indices_match_jax(num, chunk):
    got = list(pipeline.chunk_indices(num, chunk))
    want = list(jax_pipeline.chunk_indices(num, chunk))
    assert len(got) == len(want)
    for (gi, gv), (wi, wv) in zip(got, want):
        assert gv == wv and np.array_equal(gi, wi)


def test_resolve_and_depth_defaults(monkeypatch):
    monkeypatch.delenv("DPF_TPU_PIPELINE", raising=False)
    assert pipeline.resolve(None, torch.device("cpu")) is False
    assert pipeline.resolve(None, torch.device("cuda", 0)) is True
    assert pipeline.resolve(True, torch.device("cpu")) is True
    monkeypatch.setenv("DPF_TPU_PIPELINE", "1")
    assert pipeline.resolve(None, torch.device("cpu")) is True
    monkeypatch.setenv("DPF_TPU_PIPELINE", "")
    assert pipeline.resolve(None, torch.device("cuda", 0)) is False
    monkeypatch.setenv("DPF_TPU_PIPELINE", "ture")
    with pytest.raises(InvalidArgumentError):
        pipeline.resolve(None, torch.device("cpu"))
    monkeypatch.setenv("DPF_TPU_PIPELINE_DEPTH", "0")
    assert pipeline.depth_default() == 1
    monkeypatch.setenv("DPF_TPU_PIPELINE_DEPTH", "3")
    assert pipeline.depth_default() == 3


# ---------------------------------------------------------------------------
# pipeline=True == pipeline=False on every entry point that takes it
# ---------------------------------------------------------------------------


def test_full_domain_evaluate_bitexact(small_dpf):
    dpf, keys = small_dpf
    want = host_limbs(dpf, keys)
    for pipe in (False, True):
        got = evaluator.full_domain_evaluate(dpf, keys, key_chunk=2, device="cpu",
                                             pipeline=pipe, integrity=True)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode,leaf_order", [("levels", True), ("levels", False),
                                             ("fused", True), ("walk", True)])
def test_evaluate_chunks_modes_bitexact(small_dpf, mode, leaf_order):
    dpf, keys = small_dpf
    runs = [_np(evaluator.full_domain_evaluate_chunks(
        dpf, keys, key_chunk=3, mode=mode, leaf_order=leaf_order, device="cpu", pipeline=p))
        for p in (False, True)]
    _same(*runs)


def test_evaluate_chunks_lane_slab_and_codec_bitexact(small_dpf):
    dpf, keys = small_dpf
    runs = [_np(evaluator.full_domain_evaluate_chunks(
        dpf, keys, key_chunk=3, mode="fused", host_levels=6, lane_slab=32, device="cpu",
        pipeline=p)) for p in (False, True)]
    assert len(runs[0]) == 3 * 2  # 3 chunks of 2 pieces
    _same(*runs)
    tdpf = port.DistributedPointFunction.create(
        port.DpfParameters(7, port.TupleType(port.Int(32), port.IntModN(64, 2**64 - 59))))
    tkeys, _ = tdpf.generate_keys_batch([3, 100, 5], [[(1, 2), (3, 4), (5, 6)]],
                                        seeds=np.ones((3, 2, 4), np.uint32))
    _same(*[_np(evaluator.full_domain_evaluate_chunks(tdpf, tkeys, key_chunk=2, device="cpu",
                                                      pipeline=p)) for p in (False, True)])


@pytest.mark.parametrize("mode", ["fold", "megakernel"])
def test_fold_chunks_bitexact(small_dpf, mode):
    dpf, keys = small_dpf
    runs = [_np(evaluator.full_domain_fold_chunks(dpf, keys, key_chunk=2, mode=mode,
                                                  device="cpu", pipeline=p))
            for p in (False, True)]
    _same(*runs)
    folds = np.concatenate([x[0][:v] for v, x in runs[0]])
    want = host_limbs(dpf, keys)
    np.testing.assert_array_equal(folds, np.bitwise_xor.reduce(want, axis=1))


@pytest.mark.parametrize("mode", ["walk", "walkkernel"])
def test_evaluate_at_batch_chunked_bitexact(small_dpf, mode):
    dpf, keys = small_dpf
    points = [0, 5, 255, 17, 100]
    outs = [evaluator.evaluate_at_batch(dpf, keys, points, key_chunk=2, mode=mode, device="cpu",
                                        pipeline=p, integrity=True) for p in (False, True)]
    np.testing.assert_array_equal(outs[0], outs[1])
    want = host_eval.values_to_limbs(host_eval.evaluate_at_host(dpf, keys, points), 64)
    np.testing.assert_array_equal(outs[0], want)


@pytest.mark.parametrize("mode", ["walk", "walkkernel"])
def test_dcf_batch_chunked_bitexact(mode):
    dcf = port.DistributedComparisonFunction.create(7, port.Int(64))
    keys, _ = dcf.generate_keys_batch([3, 90, 127, 40, 1], [5, 6, 7, 8, 9],
                                      seeds=np.arange(40, dtype=np.uint32).reshape(5, 2, 4))
    xs = [0, 2, 3, 4, 89, 90, 126, 127]
    outs = [dcf_batch.batch_evaluate(dcf, keys, xs, key_chunk=2, mode=mode, device="cpu",
                                     pipeline=p) for p in (False, True)]
    np.testing.assert_array_equal(outs[0], outs[1])
    want = [[dcf.evaluate(k, x) for x in xs] for k in keys]
    np.testing.assert_array_equal(evaluator.values_to_numpy(outs[0], 64),
                                  np.array(want, dtype=np.uint64))


@pytest.mark.parametrize("mode", pir.MODES)
def test_pir_chunked_modes_bitexact(mode):
    dpf = port.DistributedPointFunction.create(port.DpfParameters(8, port.XorWrapper(128)))
    rng = np.random.default_rng(12)
    db = rng.integers(0, 2**32, size=(256, 4), dtype=np.uint32)
    targets = [int(x) for x in rng.integers(0, 256, size=5)]
    qa, qb = dpf.generate_keys_batch(targets, [(1 << 128) - 1],
                                     seeds=rng.integers(0, 2**32, size=(5, 2, 4), dtype=np.uint32))
    pdb = pir.prepare_pir_database(dpf, db, order=pir.MODE_ORDER[mode], device="cpu")
    answers = {p: [pir.pir_query_batch_chunked(dpf, q, pdb, key_chunk=2, mode=mode,
                                               pipeline=p, integrity=True) for q in (qa, qb)]
               for p in (False, True)}
    for a, b in zip(answers[False], answers[True]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(answers[True][0] ^ answers[True][1], db[targets])


# ---------------------------------------------------------------------------
# The executor itself
# ---------------------------------------------------------------------------


def test_finalize_runs_off_thread_in_order():
    caller = threading.get_ident()
    seen = []

    def fin(x):
        seen.append(threading.get_ident())
        return x * 10

    thunks = [lambda i=i: i for i in range(6)]
    assert list(pipeline.map_chunks(thunks, fin, True, depth=2)) == [0, 10, 20, 30, 40, 50]
    assert seen and all(t != caller for t in seen)
    seen.clear()
    assert list(pipeline.map_chunks(thunks, fin, False)) == [0, 10, 20, 30, 40, 50]
    assert seen == [caller] * 6


def test_launch_window_runs_ahead_only_when_pipelined():
    launched = []
    thunks = [lambda i=i: launched.append(i) or i for i in range(5)]
    it = pipeline.prefetch_thunks(iter(thunks), True, depth=2)
    assert next(it) == 0 and launched == [0, 1, 2]
    launched.clear()
    it = pipeline.prefetch_thunks(iter(thunks), False)
    assert next(it) == 0 and launched == [0]


def test_error_drains_in_flight_work():
    """A failing finalize propagates only after every finalize already
    started has finished: no background thread outlives the error."""
    running = []
    done = []

    def fin(x):
        running.append(x)
        if x == 1:
            raise DataCorruptionError("chunk 1 is corrupt")
        time.sleep(0.05)
        done.append(x)
        return x

    with pytest.raises(DataCorruptionError):
        list(pipeline.map_chunks([lambda i=i: i for i in range(6)], fin, True, depth=3))
    assert set(running) - {1} <= set(done)


def test_chunk_launch_fault_raises_after_drain(small_dpf):
    dpf, keys = small_dpf
    plan = faultinject.FaultPlan(stage="chunk_launch", exception=RuntimeError("launch died"),
                                 skip_fires=2)
    with faultinject.inject(plan):
        with pytest.raises(RuntimeError, match="launch died"):
            evaluator.full_domain_evaluate(dpf, keys, key_chunk=2, device="cpu", pipeline=True)
    assert plan.fires == 3


def test_overlap_proxy_pipelined_hides_injected_latency():
    """A per-chunk launch latency and pull cost injected at the stage
    boundaries (``chunk_delay``: 100 ms a launch, 140 ms a pull) overlap
    when pipelined: over 16 chunks the wall is at most 0.65x the serial
    run's, with the same values.

    The launch stage also runs the chunk's own CPU compute c (~20 ms idle,
    ~35 ms under a loaded suite), so the pipelined wall is about 16 x
    max(100 ms + c, 140 ms) plus the last two pulls, and the serial one 16 x
    (240 ms + c): the ratio stays at 0.56-0.62 for c from 0 to 60 ms (the
    pull's extra 40 ms keeps the pipelined wall pull-bound while c grows),
    where 8 chunks of 200 ms each read 0.65-0.68 once c passed 30 ms."""
    dpf = port.DistributedPointFunction.create(port.DpfParameters(6, port.Int(64)))
    rng = np.random.default_rng(11)
    keys, _ = dpf.generate_keys_batch([int(x) for x in rng.integers(0, 64, size=32)],
                                      [[int(x) for x in rng.integers(1, 1000, size=32)]])
    want = host_limbs(dpf, keys)

    def timed(pipe):
        plan = faultinject.FaultPlan(stage="chunk_delay", delay_launch=0.1,
                                     delay_finalize=0.14)
        with faultinject.inject(plan):
            t0 = time.perf_counter()
            out = evaluator.full_domain_evaluate(dpf, keys, key_chunk=2, device="cpu",
                                                 pipeline=pipe)
            return time.perf_counter() - t0, out

    sync_s, sync_out = timed(False)
    piped_s, piped_out = timed(True)
    np.testing.assert_array_equal(sync_out, want)
    np.testing.assert_array_equal(piped_out, want)
    assert piped_s / sync_s <= 0.65, (piped_s, sync_s)


def test_drain_timeout_event(monkeypatch):
    """A finalize still running when the drain's bound expires is reported
    ("drain-timeout" event), not silently left behind: chunk 0's finalize
    hangs, chunk 2's launch fails meanwhile."""
    monkeypatch.setenv("DPF_TPU_DRAIN_TIMEOUT", "0.05")
    started, release = threading.Event(), threading.Event()

    def fin(x):
        started.set()
        release.wait(5.0)
        return x

    def failing_launch():
        started.wait(5.0)
        raise RuntimeError("chunk 2's launch failed")

    thunks = [lambda: 0, lambda: 1, failing_launch]
    with integrity.capture_events() as events:
        with pytest.raises(RuntimeError, match="launch failed"):
            list(pipeline.map_chunks(thunks, fin, True, depth=1))
    release.set()
    drains = [e for e in events if e.kind == "drain-timeout"]
    assert len(drains) == 1 and drains[0].data["pending"] == 1


def test_pinned_ring_on_cpu_shares_memory():
    ring = pipeline.PinnedRing(torch.device("cpu"), 3)
    a = np.arange(8, dtype=np.uint32).reshape(2, 4)
    (t,) = ring.upload([a])
    assert t.dtype == torch.int32 and np.shares_memory(t.numpy(), a)
    pull = pipeline.HostPull((t, t + 1))
    x, y = pull.result()
    assert torch.equal(x, t) and torch.equal(y, t + 1)
