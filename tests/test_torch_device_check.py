"""The port's whole-path device check (``utils.integrity.run_device_check``)
and its CLI (``python -m distributed_point_functions_tpu_torch.tools.
check_device``) on the CPU, where every mode runs the kernels' plain
versions: each mode verifies at toy shapes, and an injected fault is
counted exactly, as the JAX package's tests/test_integrity.py checks its
own. The same modes on the card: tests/test_torch_cuda.py and
chip_smoke.py phase 23.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest

from distributed_point_functions_tpu_torch.utils import faultinject, integrity
from distributed_point_functions_tpu_torch.utils.errors import InvalidArgumentError
from torch_fold_case import one_torch_thread  # noqa: F401 (autouse fixture)

REPO = Path(__file__).resolve().parent.parent


def shapes_for(mode: str):
    # hierkernel reads a shape as (keys, levels); sharded needs a tree
    # deeper than its 2 x 2 mesh's 6 host levels.
    return ((3, 6),) if mode == "hierkernel" else ((4, 8),)


@pytest.mark.parametrize("mode", integrity.CHECK_MODES)
def test_every_mode_verifies_on_the_cpu(mode):
    lines = []
    failures = integrity.run_device_check(shapes=shapes_for(mode), mode=mode, device="cpu",
                                          report=lines.append)
    assert failures == 0, lines
    assert lines[0] == "selftest: fixed-key AES KAT OK on cpu"
    verdicts = [l for l in lines[1:] if not l.startswith("router anchor")]
    assert verdicts and all(l.endswith(": OK") or ": OK (" in l for l in verdicts), lines


@pytest.mark.parametrize("pipeline", [False, True])
def test_fold_and_megakernel_verify_with_and_without_the_executor(pipeline):
    for mode in ("fold", "megakernel"):
        assert integrity.run_device_check(shapes=((5, 7), (2, 9)), mode=mode, device="cpu",
                                          report=lambda s: None, selftest=False,
                                          pipeline=pipeline) == 0


def test_run_device_check_detects_injected_corruption():
    """One flipped root-seed bit in key row 1 (the JAX package's
    tests/test_integrity.py case): exactly that key mismatches, and a
    corruption event is emitted."""
    with integrity.capture_events() as events:
        with faultinject.inject(faultinject.FaultPlan(stage="seeds", bit=11, key_row=1)):
            failures = integrity.run_device_check(shapes=((4, 8),), device="cpu",
                                                  report=lambda s: None, selftest=False)
    assert failures == 1
    assert [e.kind for e in events] == ["corruption"]
    assert events[0].data["mode"] == "levels"


def test_an_unknown_mode_is_refused():
    with pytest.raises(InvalidArgumentError, match="mode must be one of"):
        integrity.run_device_check(mode="pallas", device="cpu")


def test_cli_verifies_fold_on_the_cpu():
    env = {**os.environ, "CHECK_MODE": "fold", "CHECK_SHAPES": "4x8,2x9"}
    r = subprocess.run([sys.executable, "-m",
                        "distributed_point_functions_tpu_torch.tools.check_device",
                        "--device", "cpu"], cwd=REPO, capture_output=True, text=True,
                       timeout=300, env=env)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    out = r.stdout
    assert "keys=   4 log_domain=  8 mode=fold: OK" in out
    assert "keys=   2 log_domain=  9 mode=fold: OK" in out
    assert "telemetry:" in out and out.rstrip().endswith("verified against the host oracle")


def test_cli_extras_on_the_cpu():
    """CHECK_EXTRAS=all at small depths: the DCF and EvaluateAt walks, the
    fused hierarchy advance at every level, a prepared plan replayed over
    two key batches and a 1x1-mesh PIR, each against the host engine."""
    env = {**os.environ, "CHECK_MODE": "walk", "CHECK_SHAPES": "2x7", "CHECK_EXTRAS": "all",
           "CHECK_DCF_LDS": "9", "CHECK_EVALAT_LDS": "20", "CHECK_HH_LEVELS": "9",
           "CHECK_PREP_LEVELS": "7", "CHECK_PIR_LDS": "8"}
    r = subprocess.run([sys.executable, "-m",
                        "distributed_point_functions_tpu_torch.tools.check_device",
                        "--device", "cpu"], cwd=REPO, capture_output=True, text=True,
                       timeout=300, env=env)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    for name in ("dcf-walk", "evalat-walk", "hierarchy-fused", "prepared-replay",
                 "sharded-pir-1x1"):
        assert f"extra {name}: OK" in r.stdout, r.stdout


def test_cli_exits_1_on_a_mismatch(monkeypatch):
    """A fault armed in the CLI's process (through its main()) turns the
    verdict into exit code 1."""
    from distributed_point_functions_tpu_torch.tools import check_device

    monkeypatch.setenv("CHECK_SHAPES", "4x8")
    monkeypatch.delenv("CHECK_MODE", raising=False)
    monkeypatch.delenv("CHECK_EXTRAS", raising=False)
    with faultinject.inject(faultinject.FaultPlan(stage="seeds", bit=3, key_row=0)):
        assert check_device.main(["--device", "cpu"]) == 1
