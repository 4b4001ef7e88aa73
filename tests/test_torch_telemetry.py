"""The port's telemetry bus (utils/telemetry.py) and profiling helpers
(utils/profiling.py) on the CPU: the disabled path emits nothing over 100
chunks; the spans and counters are the same pipelined and serial; the JSONL
sink round-trips; a raising subscriber cannot break a pipelined run; byte
counts read torch tensors; decisions carry their source. The aggregation
and the text summary are held against the JAX package's on the same
records.
"""

import json
import threading
import time

import numpy as np
import pytest
import torch

from distributed_point_functions_tpu.utils import telemetry as jax_telemetry
import distributed_point_functions_tpu_torch as port
from distributed_point_functions_tpu_torch.ops import evaluator
from distributed_point_functions_tpu_torch.parallel import pir
from distributed_point_functions_tpu_torch.utils import integrity, profiling, telemetry
from torch_fold_case import one_torch_thread  # noqa: F401 (autouse fixture)


@pytest.fixture(scope="module")
def dpf6():
    return port.DistributedPointFunction.create(port.DpfParameters(6, port.Int(64)))


@pytest.fixture(scope="module")
def keys16(dpf6):
    rng = np.random.default_rng(5)
    keys, _ = dpf6.generate_keys_batch([int(x) for x in rng.integers(0, 64, size=16)],
                                       [[int(x) for x in rng.integers(1, 1000, size=16)]],
                                       seeds=rng.integers(0, 2**32, size=(16, 2, 4),
                                                          dtype=np.uint32))
    return keys


def _span_shape(snap):
    return sorted((e["name"], e.get("data", {}).get("chunk", -1)) for e in snap["spans"])


def test_spans_and_counters_pipelined_equals_sync(dpf6, keys16):
    def run(pipe):
        with telemetry.capture() as tel:
            out = evaluator.full_domain_evaluate(dpf6, keys16[:4], key_chunk=2, device="cpu",
                                                 pipeline=pipe)
        return out, tel.snapshot()

    out_s, snap_s = run(False)
    out_p, snap_p = run(True)
    np.testing.assert_array_equal(out_s, out_p)
    assert not telemetry.enabled()
    assert snap_s["counters"] == snap_p["counters"]
    assert snap_s["counters"]["pipeline.chunks_launched[full_domain_evaluate_chunks]"] == 2
    assert snap_s["counters"]["bytes.h2d"] > 0
    assert snap_s["counters"]["bytes.d2h[full_domain_evaluate_chunks]"] == 4 * 64 * 2 * 4
    assert _span_shape(snap_s) == _span_shape(snap_p)
    for snap in (snap_s, snap_p):
        launches = [e for e in snap["spans"] if e["name"] == "pipeline.launch"]
        finals = [e for e in snap["spans"] if e["name"] == "pipeline.finalize"]
        entry = [e for e in snap["spans"] if e["name"] == "full_domain_evaluate"]
        assert len(launches) == 2 and len(finals) == 2 and len(entry) == 1
        assert {e["data"]["chunk"] for e in launches} == {0, 1}
        assert {e["data"]["chunk"] for e in finals} == {0, 1}
        for e in launches + finals:
            assert e["parent_id"] == entry[0]["span_id"]
        assert snap["dispatch_count"] == 2
        assert snap["stage_seconds"]["launch"] > 0 and snap["stage_seconds"]["finalize"] > 0
    threads_p = {e["thread"] for e in snap_p["spans"] if e["name"] == "pipeline.finalize"}
    assert any(t.startswith("dpf-pipeline") for t in threads_p)
    text = telemetry.summary(snap_p)
    assert "pipeline.launch" in text and "chunk dispatches" in text
    fields = telemetry.bench_fields(snap_p)
    assert fields["dispatch_count"] == 2
    assert set(fields["stage_seconds"]) == {"launch", "finalize"}
    assert "dispatch_latency_ms" in fields


def test_disabled_path_emits_nothing_on_100_chunks(dpf6, monkeypatch):
    rng = np.random.default_rng(9)
    keys, _ = dpf6.generate_keys_batch([int(x) for x in rng.integers(0, 64, size=200)],
                                       [[int(x) for x in rng.integers(1, 1000, size=200)]])
    calls = {"n": 0}

    def spy(*a, **k):
        calls["n"] += 1

    for name in ("_emit", "counter", "observe", "gauge", "decision"):
        monkeypatch.setattr(telemetry, name, spy)
    assert not telemetry.enabled()
    assert telemetry.span("x", op="y") is telemetry._NULL_SPAN
    out = evaluator.full_domain_evaluate(dpf6, keys, key_chunk=2, device="cpu", pipeline=True)
    assert out.shape[0] == 200  # 100 chunks of 2 really ran
    assert calls["n"] == 0


def test_decision_sources():
    dpf = port.DistributedPointFunction.create(port.DpfParameters(8, port.XorWrapper(128)))
    keys, _ = dpf.generate_keys_batch([3], [[7]], seeds=np.ones((1, 2, 4), np.uint32))
    db = np.zeros((256, 4), np.uint32)
    with telemetry.capture() as tel:
        list(evaluator.full_domain_fold_chunks(dpf, keys, device="cpu"))
        list(evaluator.full_domain_fold_chunks(dpf, keys, mode="megakernel", device="cpu"))
        evaluator.evaluate_at_batch(dpf, keys, [1, 2], device="cpu")
        pir.pir_query_batch_chunked(dpf, keys, db, mode="walk", device="cpu")
    got = [(d["name"], d["data"]["choice"], d["data"]["source"])
           for d in tel.snapshot()["decisions"]]
    assert got == [
        ("full_domain_fold_chunks", "fold", "default"),
        ("full_domain_fold_chunks", "megakernel", "explicit"),
        ("evaluate_at_batch", "walk", "default"),
        ("pir_query_batch_chunked", "walk", "explicit"),
    ]
    spans = {s["name"] for s in tel.snapshot()["spans"]}
    assert {"evaluate_at_batch", "pir_query_batch_chunked"} <= spans


def test_raising_subscriber_cannot_corrupt_pipelined_run(dpf6, keys16):
    want = evaluator.full_domain_evaluate(dpf6, keys16, key_chunk=2, device="cpu",
                                          pipeline=False)
    hostile = telemetry.Collector()
    hostile.add_event = lambda rec: (_ for _ in ()).throw(RuntimeError("boom"))
    telemetry._add_collector(hostile)
    try:
        with telemetry.capture() as tel:
            out = evaluator.full_domain_evaluate(dpf6, keys16, key_chunk=2, device="cpu",
                                                 pipeline=True)
    finally:
        telemetry._remove_collector(hostile)
    np.testing.assert_array_equal(out, want)
    snap = tel.snapshot()
    assert snap["dispatch_count"] == 8
    assert len([e for e in snap["spans"] if e["name"] == "pipeline.finalize"]) == 8


def test_snapshot_concurrent_with_emit():
    errors = []
    with telemetry.capture() as tel:
        stop = threading.Event()

        def reader():
            try:
                while not stop.is_set():
                    telemetry.summary(tel.snapshot())
            except Exception as e:  # pragma: no cover - the failure under test
                errors.append(e)

        t = threading.Thread(target=reader)
        t.start()
        try:
            for i in range(2000):
                with telemetry.span("race.probe", i=i):
                    pass
        finally:
            stop.set()
            t.join(timeout=30)
    assert not errors, errors
    assert tel.snapshot()["histograms"]["span.race.probe"]["count"] == 2000


def test_integrity_hooks_locked_and_exception_isolated():
    seen = []

    def bad(ev):
        raise RuntimeError("hostile hook")

    integrity.add_event_hook(bad)
    integrity.add_event_hook(seen.append)
    try:
        with telemetry.capture() as tel:
            integrity.emit_event("sentinel-ok", "a verdict", "cuda", op="x")
    finally:
        integrity.remove_event_hook(bad)
        integrity.remove_event_hook(seen.append)
        integrity.remove_event_hook(bad)  # a second remove is benign
    assert [e.kind for e in seen] == ["sentinel-ok"]
    assert tel.snapshot()["integrity_by_kind"] == {"sentinel-ok": 1}


def test_jsonl_sink_roundtrip(tmp_path, monkeypatch):
    path = tmp_path / "telemetry.jsonl"
    monkeypatch.setenv("DPF_TPU_TELEMETRY_LOG", str(path))
    telemetry.configure_from_env()
    try:
        assert telemetry.enabled()
        with telemetry.span("jsonl.region", op="test"):
            time.sleep(0.001)
        telemetry.decision("evaluate_at_batch", "walk", "explicit")
        integrity.emit_event("sentinel-ok", "jsonl round-trip", "cpu", foo=1)
    finally:
        monkeypatch.delenv("DPF_TPU_TELEMETRY_LOG")
        telemetry.configure_from_env()  # closes the sink, writes the summary
    assert not telemetry.enabled()
    records = [json.loads(line) for line in path.read_text().splitlines()]
    kinds = [r["kind"] for r in records]
    assert kinds.count("span") == 1 and kinds.count("decision") == 1
    assert kinds.count("integrity") == 1 and kinds[-1] == "summary"
    span_rec = next(r for r in records if r["kind"] == "span")
    assert span_rec["name"] == "jsonl.region" and span_rec["duration"] > 0
    dec = next(r for r in records if r["kind"] == "decision")
    assert dec["data"] == {"choice": "walk", "source": "explicit"}
    ev = next(r for r in records if r["kind"] == "integrity")
    assert ev["name"] == "sentinel-ok" and ev["data"]["foo"] == 1
    assert "span.jsonl.region" in records[-1]["histograms"]


def test_global_ring_and_dispatch_latency(dpf6, keys16, monkeypatch):
    monkeypatch.setenv("DPF_TPU_TELEMETRY", "1")
    telemetry.configure_from_env()
    try:
        evaluator.full_domain_evaluate(dpf6, keys16[:4], key_chunk=2, device="cpu")
        lat = telemetry.dispatch_latency("full_domain_evaluate_chunks")
        assert lat["count"] == 2 and lat["mean"] > 0
        assert telemetry.snapshot()["dispatch_count"] == 2
    finally:
        monkeypatch.delenv("DPF_TPU_TELEMETRY")
        telemetry.configure_from_env()
    assert telemetry.snapshot() is None and telemetry.dispatch_latency() is None


def test_pipeline_occupancy_matches_overlap_proxy(dpf6, keys16):
    from distributed_point_functions_tpu_torch.utils import faultinject

    def occupancy(pipe):
        plan = faultinject.FaultPlan(stage="chunk_delay", delay_launch=0.15, delay_finalize=0.15)
        with faultinject.inject(plan), telemetry.capture() as tel:
            evaluator.full_domain_evaluate(dpf6, keys16, key_chunk=2, device="cpu", pipeline=pipe)
        return tel.snapshot()["pipeline_occupancy"]

    assert occupancy(False) <= 1.05
    assert occupancy(True) >= 1.2


def test_nbytes_of_counts_tensors_and_arrays():
    t = torch.zeros((3, 5), dtype=torch.int32)
    a = np.zeros((2, 4), np.uint64)
    assert telemetry.nbytes_of(t) == 60
    assert telemetry.nbytes_of((7, [t, a])) == 60 + 64
    assert telemetry.nbytes_of("x") == 0


def test_aggregation_and_summary_match_jax():
    """The same records through both packages' collectors give the same
    counters, histograms and summary table."""
    def drive(tm):
        with tm.capture() as tel:
            for i in range(5):
                tm.observe_span("pipeline.launch", 0.01 * (i + 1), op="op")
                tm.counter("pipeline.chunks_launched", op="op")
            tm.gauge("pipeline.queue_depth", 3, op="op")
            tm.gauge("pipeline.queue_depth", 1, op="op")
        snap = tel.snapshot()
        snap["wall_seconds"] = 1.0
        snap["pipeline_occupancy"] = None
        return snap

    got, want = drive(telemetry), drive(jax_telemetry)
    for key in ("counters", "gauges", "histograms", "dispatch_count", "stage_seconds"):
        assert got[key] == want[key], key
    assert telemetry.summary(got) == jax_telemetry.summary(want)
    assert telemetry.bench_fields(got) == jax_telemetry.bench_fields(want)


def test_profiling_stopwatch_and_null_annotate(monkeypatch):
    monkeypatch.delenv("DPF_TPU_PROFILE_DIR", raising=False)
    with profiling.annotate("nothing listens"):
        pass
    with profiling.trace():  # no directory: a no-op
        pass
    sw = profiling.Stopwatch()
    with telemetry.capture() as tel:
        sw.lap("a")
        sw.lap("b")
    assert [n for n, _ in sw.phases] == ["a", "b"] and "total" in sw.report()
    assert {s["name"] for s in tel.snapshot()["spans"]} == {"stopwatch.a", "stopwatch.b"}


def test_profiling_trace_writes_a_chrome_trace(tmp_path, dpf6, keys16):
    with profiling.trace(str(tmp_path)):
        assert telemetry.enabled()
        with profiling.annotate("region"):
            evaluator.full_domain_evaluate(dpf6, keys16[:2], key_chunk=2, device="cpu")
    assert not telemetry.enabled()
    names = {e.get("name") for e in json.loads((tmp_path / "trace.json").read_text())["traceEvents"]}
    assert {"region", "full_domain_evaluate", "pipeline.launch"} <= names
