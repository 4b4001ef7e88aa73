"""The port's headline strategy shootout (``tools/variants.py``) on the
CPU, where every wrapper runs its kernel's plain version: each strategy's
per-key XOR folds equal the JAX package's host engine
(``core/host_eval.full_domain_evaluate_host``) on the same seeded keys;
the CLI reports each strategy and exits 1 on a mismatch; a missing card
raises instead of falling back.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from distributed_point_functions_tpu.core.dpf import DistributedPointFunction as JaxDpf
from distributed_point_functions_tpu.core.host_eval import (
    full_domain_evaluate_host as jax_full_domain_host,
)
from distributed_point_functions_tpu.core.params import DpfParameters as JaxParams
from distributed_point_functions_tpu.core.value_types import Int as JaxInt
from distributed_point_functions_tpu_torch.tools import variants
from distributed_point_functions_tpu_torch.utils.errors import UnavailableError

LOG_DOMAIN = 9
KEYS = 8
CHUNK = 4
SEED = 11


@pytest.fixture(scope="module")
def case():
    """The tool's seeded keys and the JAX host engine's folds of the same
    keys, dealt by the JAX package from the same alphas, betas and seeds."""
    dpf, keys, alphas, betas, seeds = variants.make_keys(LOG_DOMAIN, KEYS, SEED)
    jdpf = JaxDpf.create(JaxParams(LOG_DOMAIN, JaxInt(64)))
    jkeys, _ = jdpf.generate_keys_batch(alphas, betas, seeds=seeds)
    want = np.bitwise_xor.reduce(jax_full_domain_host(jdpf, jkeys), axis=1).astype(np.uint64)
    return dpf, keys, want


def test_the_port_host_oracle_equals_the_jax_host_engine(case):
    dpf, keys, want = case
    assert np.array_equal(variants.host_folds(dpf, keys, CHUNK), want)


@pytest.mark.parametrize("name", variants.STRATEGIES)
def test_each_strategy_folds_as_the_jax_host_engine(case, name):
    dpf, keys, want = case
    r = variants.run_strategy(name, dpf, keys, CHUNK, torch.device("cpu"), want)
    assert r.mismatched_keys == 0
    assert np.array_equal(r.folds, want)
    assert r.launches == {}  # the plain versions on the CPU launch no kernel
    assert r.seconds > 0 and r.evals_per_s > 0 and r.warm_evals_per_s > 0


def test_cli_reports_every_strategy_on_the_cpu(capsys):
    assert variants.main(["--log-domain", "8", "--keys", "4", "--key-chunk", "2",
                          "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    for name in variants.STRATEGIES:
        assert any(l.startswith(f"{name}: ") and "verify: OK" in l for l in lines), name
    record = json.loads(lines[-1])
    assert record["platform"] == "cpu" and record["ok"]
    assert set(record["strategies"]) == set(variants.STRATEGIES)


def test_cli_exits_1_on_a_mismatch(monkeypatch, capsys):
    real = variants.host_folds
    monkeypatch.setattr(variants, "host_folds", lambda *a: real(*a) ^ np.uint64(1))
    assert variants.main(["fold", "--log-domain", "8", "--keys", "4", "--key-chunk", "2",
                          "--device", "cpu"]) == 1
    out = capsys.readouterr().out
    assert "verify: MISMATCH 4/4 keys" in out
    assert json.loads(out.strip().splitlines()[-1])["ok"] is False


def test_a_missing_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(UnavailableError):
        variants.main(["--device", "cuda"])
