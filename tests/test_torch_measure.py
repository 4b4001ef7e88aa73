"""The port's resumable measurement session (``tools/measure.py``) with
fake child stages: a rerun skips the stages done before (unless
``--always``); a stage that times out has its whole process group killed,
grandchildren included; a stage whose child exits nonzero, or exits 0 with
a CPU record, is never marked done; the budget and the device flag reach
the stages as the JAX session's ``stage()`` gives them.
"""

from __future__ import annotations

import json
import sys
import textwrap
from pathlib import Path

import pytest

from distributed_point_functions_tpu_torch.tools import measure
from distributed_point_functions_tpu_torch.tools.measure import Stage

_FAKES = {
    # A card stage that completes: its last JSON line names the GPU, and
    # it echoes its arguments.
    "fake_gpu": 'print("working")\nprint(json.dumps({"platform": "gpu", "argv": sys.argv[1:]}))',
    "fake_cpu": 'print(json.dumps({"platform": "cpu"}))',
    "fake_host": 'print(json.dumps({"platform": "host", "argv": sys.argv[1:]}))',
    "fake_fail": 'print(json.dumps({"platform": "gpu"}))\nsys.exit(3)',
    "fake_silent": 'print("no record")',
    # A stage that starts a grandchild, writes both pids, then hangs.
    "fake_hang": textwrap.dedent('''
        import subprocess, time
        kid = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(60)"])
        open(sys.argv[1], "w").write(f"{os.getpid()} {kid.pid}")
        time.sleep(60)
    '''),
}


@pytest.fixture
def fakes(tmp_path, monkeypatch):
    """Fake stage modules importable by the children; a short kill grace."""
    mods = tmp_path / "mods"
    mods.mkdir()
    for name, body in _FAKES.items():
        (mods / f"{name}.py").write_text("import json, os, sys\n" + body + "\n")
    monkeypatch.setenv("PYTHONPATH", str(mods))
    monkeypatch.setattr(measure, "KILL_GRACE_SECONDS", 0.5)
    return tmp_path


def _run(state, stage_list, **kw):
    lines = []
    rc = measure.session(state_dir=state, stage_list=stage_list, say=lines.append, **kw)
    return rc, "\n".join(lines)


def _records(state):
    path = Path(state) / "records.jsonl"
    return [json.loads(l) for l in path.read_text().splitlines()] if path.exists() else []


def _alive(pid: int) -> bool:
    """Running: a /proc entry that is not a zombie."""
    try:
        stat = Path(f"/proc/{pid}/stat").read_text()
    except OSError:
        return False
    return stat.rsplit(")", 1)[1].split()[0] != "Z"


def test_a_rerun_skips_the_stages_done_before(fakes):
    state = fakes / "state"
    stages = [Stage("a", "fake_gpu"), Stage("b", "fake_gpu")]
    rc, out = _run(state, stages)
    assert rc == 0 and measure.read_done(state / "stages.state") == ["a", "b"]
    assert [r["done"] for r in _records(state)] == [True, True]
    assert (state / "a.log").read_text().startswith("working")
    rc, out = _run(state, stages)
    assert rc == 0 and out.count("skipped (resume)") == 2
    assert len(_records(state)) == 2  # no child ran
    rc, out = _run(state, stages, names=["b"], always=True)
    assert rc == 0 and [r["stage"] for r in _records(state)] == ["a", "b", "b"]


def test_a_cpu_failed_or_silent_record_is_never_done(fakes):
    state = fakes / "state"
    stages = [Stage("cpu", "fake_cpu"), Stage("fail", "fake_fail"),
              Stage("silent", "fake_silent"), Stage("ok", "fake_gpu")]
    rc, out = _run(state, stages)
    assert rc == 1  # a failure outranks a stage with no record of its platform
    assert measure.read_done(state / "stages.state") == ["ok"]
    by = {r["stage"]: r for r in _records(state)}
    assert (by["cpu"]["rc"], by["cpu"]["platform"], by["cpu"]["done"]) == (0, "cpu", False)
    assert (by["fail"]["rc"], by["fail"]["platform"], by["fail"]["done"]) == (3, "gpu", False)
    assert by["silent"]["record"] is None and not by["silent"]["done"]
    assert "names platform 'cpu', the stage needs 'gpu'" in out
    rc, _ = _run(fakes / "cpu-only", [Stage("cpu", "fake_cpu")])
    assert rc == 2


def test_a_timed_out_stage_has_its_process_group_killed(fakes):
    state = fakes / "state"
    pids = fakes / "pids"
    stages = [Stage("hang", "fake_hang", args=(str(pids),), timeout=60)]
    rc, out = _run(state, stages, timeouts={"hang": 1.5})
    assert rc == 1 and "TIMED OUT after 1.5 s; killed process group" in out
    (run,) = _records(state)
    child, grandchild = (int(p) for p in pids.read_text().split())
    assert run["timed_out"] and run["pgid"] == child
    assert {child, grandchild} <= set(run["killed"])
    assert not _alive(child) and not _alive(grandchild)
    assert measure.read_done(state / "stages.state") == []


def test_budget_device_and_environment_reach_the_stages(fakes, monkeypatch):
    state = fakes / "state"
    monkeypatch.setenv("FAKE_KNOB", "caller")
    stages = [Stage("g", "fake_gpu", args=("--x",), env={"FAKE_KNOB": "stage"}),
              Stage("h", "fake_host", args=("--y",), platform="host")]
    rc, _ = _run(state, stages, device="cpu", extra_args={"g": ["--z"]})
    assert rc == 0
    by = {r["stage"]: r["record"]["argv"] for r in _records(state)}
    assert by == {"g": ["--x", "--z", "--device", "cpu"], "h": ["--y"]}
    rc, out = _run(fakes / "spent", stages, budget=0)
    assert rc == 3 and out.count("SKIPPED (budget") == 2
    with pytest.raises(SystemExit, match="unknown stages"):
        _run(state, stages, names=["nope"])


def test_the_session_stages_and_cli(capsys, tmp_path):
    names = [s.name for s in measure.stages(tmp_path)]
    assert names == ["check", "variants", "gen-data", "exp-hier", "exp-direct", "soak"]
    assert [s.platform for s in measure.stages(tmp_path)].count("host") == 1
    assert measure.main(["--list", "--state-dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out.splitlines()
    assert [l.split()[0] for l in out] == names
    assert measure.last_json('x\n{"platform": "gpu"}\n{not json\ny') == {"platform": "gpu"}
