"""The port's cost-model router (distributed_point_functions_tpu_torch/
serving/router.py), with hand-written state and with no anchor, and its
loop through the front door on the CPU: the work and dispatch model, the
online rate and dispatch EWMAs, degrade penalties and their decay, the
calibration file, the ``decision(source="router")`` record, the gating of
modes that have no measured anchor, and the anchors' provenance (the
card's own numbers, no figure of another device).
"""

import inspect
import json

import numpy as np
import pytest

import distributed_point_functions_tpu_torch as port
from distributed_point_functions_tpu_torch import serving
from distributed_point_functions_tpu_torch.ops import keygen_batch
from distributed_point_functions_tpu_torch.parallel import pir
from distributed_point_functions_tpu_torch.serving import router as router_mod
from distributed_point_functions_tpu_torch.serving.router import (
    CostModel,
    Router,
    Workload,
)
from distributed_point_functions_tpu_torch.utils import faultinject, telemetry
from distributed_point_functions_tpu_torch.utils.errors import InvalidArgumentError
from torch_fold_case import one_torch_thread  # noqa: F401 (autouse fixture)

HAND = {
    ("evaluate_at", "host", None): {"u64": 1e6},
    ("evaluate_at", "device", "walk"): {"u64": 1e8},
    ("pir", "host", None): {"u64": 1e7},
    ("pir", "device", "fold"): {"u64": 1e9, "u128": 5e8},
    ("keygen", "host", None): {"u64": 1e5},
}


def _router(anchors=HAND, dispatch=0.01):
    return Router(model=CostModel(dispatch_seconds=dispatch, anchors=anchors), calibration="")


@pytest.mark.parametrize("w,items,dispatches", [
    (Workload("full_domain", num_keys=100, log_domain=10, key_chunk=32), 100 * 1024, 4),
    (Workload("pir", num_keys=64, log_domain=24, device_num_keys=72, key_chunk=8),
     64 * 2**24, 9),
    (Workload("evaluate_at", num_keys=3, points=5, device_num_keys=64, device_points=64), 15, 1),
    (Workload("dcf", num_keys=2, points=7), 14, 1),
    (Workload("gate", num_keys=4, points=10), 40, 1),
    (Workload("hierarchical", num_keys=8, levels=33, avg_prefixes=10, group=16,
              key_chunk=4), 8 * 33 * 10, 3),
    (Workload("keygen", num_keys=1024, levels=19), 1024 * 19, 19),
], ids=["full_domain", "pir", "evaluate_at", "dcf", "gate", "hierarchical", "keygen"])
def test_work_and_dispatch_model(w, items, dispatches):
    assert w.work_items() == items
    assert w.dispatches("fold") == dispatches
    if w.op == "keygen":
        assert w.dispatches("megakernel") == 1
    if w.op == "hierarchical":
        assert w.dispatches("hierkernel") == 3 * 2  # windows x key chunks
    if w.device_num_keys:  # the device runs the padded batch
        assert w.work_items("device") > w.work_items("host") == items


def test_hand_state_picks_by_size_and_records_the_decision():
    r = _router()
    small = Workload("evaluate_at", num_keys=1, points=4)
    wide = Workload("evaluate_at", num_keys=1024, points=4096)
    with telemetry.capture() as tel:
        assert r.route(small).choice == "host"  # 4 us vs 10 ms of dispatch
        d = r.route(wide)
    assert d.choice == "device/walk"
    assert d.costs == {"host": pytest.approx(4.194304), "device/walk": pytest.approx(0.051943)}
    rec = tel.decision_records(source="router")
    assert [x["data"]["choice"] for x in rec] == ["host", "device/walk"]
    assert rec[1]["data"]["costs_ms"]["host"] == pytest.approx(4194.304)
    assert rec[1]["data"]["work_items"] == 1024 * 4096
    # Width-kind fallback: a u128 batch without its own rate halves u64's.
    m = CostModel(dispatch_seconds=0.0, anchors=HAND)
    assert m.rate("evaluate_at", "device", "walk", "u128", 128) == 5e7
    assert m.rate("pir", "device", "fold", "u128", 128) == 5e8
    assert m.rate("mic", "host", None, "u64", 64) is None  # rides DCF's: none here


def test_no_anchor_routes_nothing_until_learned():
    """An op with no anchor has no candidate (the route raises); a learned
    or calibrated rate makes its mode a candidate, as an unverified mode
    becomes one."""
    r = _router(anchors={})
    w = Workload("dcf", num_keys=64, points=64, log_domain=24)
    assert r.model.candidates("dcf") == (("host", None),)
    with pytest.raises(InvalidArgumentError, match="no routable candidate"):
        r.route(w)
    r.observe(w, "device", "walkkernel", 0.5)
    assert ("device", "walkkernel") in r.model.candidates("mic")  # gates ride DCF
    assert r.route(w).choice == "device/walkkernel"
    # Every device mode of the port is anchored or unverified, never both.
    device_modes = {
        "full_domain": {"levels"}, "evaluate_at": {"walk", "walkkernel"},
        "dcf": {"walk", "walkkernel"}, "hierarchical": {"fused", "hierkernel"},
        "pir": set(pir.MODES),
        "keygen": set(keygen_batch.KEYGEN_MODES) - set(keygen_batch.HOST_MODES),
    }
    for op, modes in device_modes.items():
        anchored = {m for (o, e, m) in router_mod.ANCHORS if o == op and e == "device"}
        unverified = set(router_mod.UNVERIFIED_MODES.get((op, "device"), ()))
        assert anchored | unverified == modes and not anchored & unverified, op
    with pytest.raises(InvalidArgumentError, match="unknown router op"):
        r.model.predict(Workload("hh_ingest"))


def test_online_learning_dispatch_and_penalties():
    r = _router()
    w = Workload("pir", num_keys=64, log_domain=20, key_chunk=64)
    assert r.route(w).choice == "device/fold"
    # A measured slow batch: wall 40 s less one dispatch; the host's 6.7 s
    # now wins.
    r.observe(w, "device", "fold", 40.0)
    assert r.model.learned[("pir", "device", "fold", "u64")] == pytest.approx(
        64 * 2**20 / 39.99)
    assert r.route(w).choice == "host"
    r.observe_dispatch(0.2)
    r.observe_dispatch(0.1)
    assert r.model.dispatch_seconds("device") == pytest.approx(0.3 * 0.1 + 0.7 * 0.2)
    assert r.model.dispatch_seconds("host") == 0.0
    # Degrade penalties stack 4x (capped at 256x) and decay with service.
    r2 = _router()
    for _ in range(5):
        r2.on_degrade("pir", "device", "fold", "corruption")
    assert r2.model.penalty[("pir", "device", "fold")] == 256.0
    r2.observe(w, "device", "fold", 0.1)
    assert r2.model.penalty[("pir", "device", "fold")] == 16.0
    for _ in range(6):  # 16 -> 4 -> 2 -> 1.41 -> 1.19 -> 1.09 -> gone
        r2.observe(w, "device", "fold", 0.1)
    assert ("pir", "device", "fold") not in r2.model.penalty


def test_calibration_round_trip(tmp_path, monkeypatch):
    path = str(tmp_path / "calib.json")
    r = _router()
    r.observe(Workload("evaluate_at", num_keys=8, points=8), "device", "walkkernel", 0.02)
    r.observe_dispatch(0.003)
    r.on_degrade("evaluate_at", "device", "walk")
    r.save_calibration(path)
    state = json.load(open(path))
    assert set(state) == {"dispatch_ewma", "learned", "penalty"}
    monkeypatch.setenv("DPF_TPU_ROUTER_CALIB", path)
    back = Router(model=CostModel(anchors={}))
    assert back.calibration == path
    assert back.model.state() == r.model.state()
    assert ("device", "walkkernel") in back.model.candidates("evaluate_at")
    (tmp_path / "torn.json").write_text("{not json")
    assert Router(calibration=str(tmp_path / "torn.json")).model.learned == {}


def test_anchors_are_the_cards_own():
    """Every anchor is an op and mode of the port, and the module carries
    no figure taken on or for another device: no dispatch prior of a
    tunnel, no roofline projection, no host-thread model."""
    ops = set(router_mod._OPS)
    modes = {
        "full_domain": {"levels"}, "evaluate_at": {"walk", "walkkernel"},
        "dcf": {"walk", "walkkernel"}, "hierarchical": {"fused", "hierkernel"},
        "pir": set(pir.MODES), "keygen": {"perlevel", "megakernel"},
    }
    for (op, engine, mode), table in router_mod.ANCHORS.items():
        assert op in ops and engine in ("host", "device")
        assert (mode is None) if engine == "host" else (mode in modes[op])
        assert table and all(v > 0 for v in table.values())
    src = inspect.getsource(router_mod)
    for word in ("v5e", "tunnel", "roofline", "0.0657", "ENGINE_TABLE", "PROJECTION",
                 "host_thread"):
        assert word not in src, word
    assert router_mod.DISPATCH_SECONDS_PRIOR >= 0


def _evaluate_at_case():
    dpf = port.DistributedPointFunction.create(port.DpfParameters(8, port.Int(64)))
    keys, _ = dpf.generate_keys_batch([3, 200], [[5, 6]], seeds=np.arange(
        16, dtype=np.uint32).reshape(2, 2, 4))
    return dpf, keys


def test_front_door_auto_routing_and_learning():
    """The door costs each merged batch, runs the cheaper engine, and
    learns the measured rate of the engine it ran."""
    dpf, keys = _evaluate_at_case()
    r = _router(dispatch=1e-6)
    with telemetry.capture() as tel:
        door = serving.FrontDoor(router=r, device="cpu", width_target=2)
        door.serve([serving.Request.evaluate_at(dpf, keys, [3, 4])])
    rec = tel.decision_records(source="router")
    assert [x["data"]["choice"] for x in rec] == ["device/walk"]
    assert door.batches[0]["choice"] == "device/walk"
    assert ("evaluate_at", "device", "walk", "u64") in r.model.learned
    slow = _router(anchors={("evaluate_at", "host", None): {"u64": 1e6},
                            ("evaluate_at", "device", "walk"): {"u64": 1e6}}, dispatch=10.0)
    door = serving.FrontDoor(router=slow, device="cpu")
    out = door.serve([serving.Request.evaluate_at(dpf, keys, [3, 4])])
    assert door.batches[0]["choice"] == "host"
    assert out[0].shape == (2, 2, 2)


def test_degrade_events_penalize_the_routed_choice():
    """A fault on the routed device rung degrades inside the robust chain;
    the door feeds the degrade record back as a penalty on that choice."""
    dpf, keys = _evaluate_at_case()
    r = _router(anchors={("evaluate_at", "host", None): {"u64": 1.0},
                         ("evaluate_at", "device", "walkkernel"): {"u64": 1e9}}, dispatch=0.0)
    door = serving.FrontDoor(router=r, device="cpu", mode=None)
    plan = faultinject.FaultPlan(stage="device_output", pattern="lane", max_fires=1)
    with faultinject.inject(plan):
        out = door.serve([serving.Request.evaluate_at(dpf, keys, [3, 200])])
    assert door.batches[0]["choice"] == "device/walkkernel"
    assert r.model.penalty.get(("evaluate_at", "device", "walkkernel"), 1.0) > 1.0
    ints = out[0][..., 0].astype(np.int64)
    assert ints.shape == (2, 2)
