"""The port's demos (``distributed_point_functions_tpu_torch/examples/``) on
the CPU at small sizes: each ``main`` runs on ``--device cpu`` (the kernels'
plain versions, the native host engine where the demo names it) and prints
its own success line after its own check (the PIR record equal to the
database's, the heavy hitters equal to the plaintext count's, the gate
layers equal bit for bit to the plaintext gate). Without a card, each
entry point raises instead of running on the CPU.
"""

import pytest
import torch

from distributed_point_functions_tpu_torch.examples import (
    heavy_hitters_demo,
    pir_demo,
    secure_relu_demo,
)
from distributed_point_functions_tpu_torch.utils.errors import UnavailableError
from torch_fold_case import one_torch_thread  # noqa: F401 (autouse fixture)


def _last_line(capsys) -> str:
    return capsys.readouterr().out.strip().splitlines()[-1]


@pytest.mark.parametrize("serve", [False, True], ids=["in-process", "serve"])
def test_pir_demo(serve, capsys):
    argv = ["--log_domain", "12", "--device", "cpu"] + (["--serve"] if serve else [])
    assert pir_demo.main(argv) == 0
    line = _last_line(capsys)
    assert line.startswith("client: reconstructed record ") and line.endswith("— matches")


@pytest.mark.parametrize("mode", ["fused", "host"])
def test_heavy_hitters_demo(mode, monkeypatch, capsys):
    monkeypatch.setenv("HH_CLIENTS", "120")
    monkeypatch.setenv("HH_MODE", mode)
    assert heavy_hitters_demo.cli(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.strip().splitlines()[-1] == (
        "OK: servers learned only the heavy hitters and their counts")
    assert "heavy hitters found: ['0x1234', '0xbeef', '0xc0de']" in out


def test_heavy_hitters_demo_refuses_an_unknown_mode(monkeypatch, capsys):
    monkeypatch.setenv("HH_MODE", "xla")
    assert heavy_hitters_demo.cli(["--device", "cpu"]) == 2


def test_secure_relu_demo(monkeypatch, capsys):
    monkeypatch.setenv("RELU_BATCH", "6")
    assert secure_relu_demo.main(["--device", "cpu"]) == 0
    assert _last_line(capsys).startswith(
        "OK: ReLU and sigmoid layers reconstructed bit-exactly")


def test_demos_without_a_card_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(UnavailableError):
        pir_demo.main(["--log_domain", "8"])
    with pytest.raises(UnavailableError):
        heavy_hitters_demo.cli([])
    with pytest.raises(UnavailableError):
        heavy_hitters_demo.cli(["--serve"])
    with pytest.raises(UnavailableError):
        secure_relu_demo.main([])
