"""Sparse-histogram DPF workload on the card: hierarchical against direct
evaluation of one key over the nonzeros of a histogram.

The port of the JAX package's ``experiments/synthetic_data_benchmarks.py``,
itself a re-implementation of the reference library's experiments binary
(``experiments/synthetic_data_benchmarks.cc``):

* reads the nonzero bucket ids from a CSV (the first column);
* hierarchical (the default): picks prefix bit lengths so that no level's
  expansion exceeds ``--max_expansion_factor`` x nonzeros
  (ComputeLevelsToEvaluate, ``.cc:139-165``), composes the level plan once
  (``hierarchical.prepare_levels_fused``, reported as ``prepare_seconds``)
  and replays it each iteration on a fresh context
  (``evaluate_levels_fused``: mode ``fused``, K2 a tree level and K4 a
  hierarchy level; or ``hierkernel``, K8 a prefix window);
* direct (``--only_nonzeros``): one level, evaluated at exactly the nonzero
  indices (RunBatchedSinglePointEvaluation, ``.cc:196-208``) through
  ``evaluator.evaluate_at_batch`` (mode ``walk``, K6 a tree level and K4;
  or ``walkkernel``, one K7 launch).

The value type is Int(32), as the reference's. Reports seconds per key per
iteration on the last line, as JSON::

    python -m distributed_point_functions_tpu_torch.experiments.gen_data
    python -m distributed_point_functions_tpu_torch.experiments.synthetic_data_benchmarks \\
        --input distributed_point_functions_tpu_torch/experiments/data/32_1048576_1048576_0.1.csv \\
        --log_domain_size 32 --max_expansion_factor 4
    ... --only_nonzeros [--mode walkkernel]
    ... --engine host --device cpu       # the native AES-NI host engine

``--device`` defaults to the card; ``cpu`` runs the kernels' plain
versions. ``--engine auto`` is the host engine only when ``--device cpu``
was passed, never a fallback for a missing card or a failed kernel. A mode
that cannot express the run raises, as the JAX package's does.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time
from typing import List, Optional, Sequence

import numpy as np

VALUE_BITS = 32  # element_bitsize of the reference's experiments
MODES = {"hierarchical": ("fused", "hierkernel"), "direct": ("walk", "walkkernel")}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--input", default="", help="CSV of nonzero bucket ids")
    ap.add_argument("--log_domain_size", type=int, default=20)
    ap.add_argument("--levels_to_evaluate", default="",
                    help="comma-separated log domain sizes for hierarchy levels")
    ap.add_argument("--max_expansion_factor", type=int, default=2)
    ap.add_argument("--num_iterations", type=int, default=20)
    ap.add_argument("--only_nonzeros", action="store_true")
    ap.add_argument("--device", default=None,
                    help='the device (default: the card; "cpu": the kernels\' plain versions)')
    ap.add_argument("--engine", default="auto", choices=("auto", "device", "host"),
                    help="the device path, the native AES-NI host engine, or auto (the host "
                         "engine when --device cpu was passed)")
    ap.add_argument("--mode", default=None,
                    help="hierarchical: fused (default) or hierkernel; direct: walk (default) "
                         "or walkkernel")
    return ap.parse_args(argv)


def read_nonzeros(path: str, log_domain_size: int) -> np.ndarray:
    """The unique bucket ids of the CSV's first column: uint64 below a
    64-bit domain, U128 (core/uint128.py) at and above."""
    from ..core import uint128

    values = []
    with open(path) as f:
        for line_number, line in enumerate(f):
            field = line.split(",")[0].strip()
            if not field:
                raise ValueError(f"Line {line_number} is empty")
            values.append(int(field))
    if log_domain_size < 64:
        arr = np.unique(np.array(values, dtype=np.uint64))
    else:
        arr = np.unique(uint128.u128_array(values))
    print(f"# read {arr.shape[0]} nonzeros from {len(values)} lines", file=sys.stderr)
    return arr


def compute_prefixes(nonzeros: np.ndarray, log_domain_size: int) -> list:
    """prefixes[bits] = the unique bit-prefixes of the nonzeros, bits = 0 ..
    log_domain_size (ComputePrefixes, ``.cc:84-105``), each sorted.

    The nonzeros are sorted once; a right shift keeps that order, so each
    level's unique prefixes are its shifted values less their repeats, found
    next to each other: one linear pass a level, where ``np.unique`` would
    sort again (minutes at 2^20 U128 values over 128 levels)."""
    from ..core import uint128

    wide = nonzeros.dtype == uint128.U128
    ascending = (uint128.u128_gt(nonzeros[1:], nonzeros[:-1]) if wide
                 else nonzeros[1:] > nonzeros[:-1])
    if not ascending.all():  # read_nonzeros' output is already sorted and unique
        nonzeros = np.unique(nonzeros)

    def dedupe(a):
        if a.shape[0] < 2:
            return a
        if wide:
            new = (a["hi"][1:] != a["hi"][:-1]) | (a["lo"][1:] != a["lo"][:-1])
        else:
            new = a[1:] != a[:-1]
        return a[np.concatenate(([True], new))]

    prefixes = [np.array([], dtype=nonzeros.dtype)]
    for bits in range(1, log_domain_size + 1):
        shift = log_domain_size - bits
        if wide:
            prefixes.append(dedupe(uint128.u128_rshift(nonzeros, shift)))
        else:
            prefixes.append(dedupe(nonzeros >> np.uint64(shift)))
    return prefixes


def compute_levels_to_evaluate(prefixes, log_domain_size: int,
                               max_expansion_factor: int) -> List[int]:
    """ComputeLevelsToEvaluate (``.cc:139-165``)."""
    num_nonzeros = len(prefixes[-1])
    assert num_nonzeros > 0
    step = math.log2(num_nonzeros) + math.log2(max_expansion_factor)
    levels = [min(log_domain_size, int(step)) - 1]
    while levels[-1] < log_domain_size:
        nonzeros_at_last = len(prefixes[levels[-1] + 1])
        levels.append(min(log_domain_size,
                          int(levels[-1] + step - math.log2(nonzeros_at_last))))
    return levels


def draw_alpha(log_domain_size: int) -> int:
    """The JAX CLI's alpha: ``default_rng(0)`` below 2^min(lds, 63)."""
    rng = np.random.default_rng(0)
    return int(rng.integers(0, 1 << min(log_domain_size, 63)))


def create_dpf(log_domain_size: int, levels: Optional[Sequence[int]] = None):
    """The experiment's DPF: one Int(32) level at `log_domain_size` (direct),
    or one a log-domain of `levels` (hierarchical)."""
    from ..core.dpf import DistributedPointFunction
    from ..core.params import DpfParameters
    from ..core.value_types import Int

    if levels is None:
        return DistributedPointFunction.create(DpfParameters(log_domain_size, Int(VALUE_BITS)))
    return DistributedPointFunction.create_incremental(
        [DpfParameters(lds, Int(VALUE_BITS)) for lds in levels])


def generate_keys(dpf, alpha: int):
    """Both parties' keys of beta = 1 at every level of `dpf`."""
    n = dpf.validator.num_hierarchy_levels
    if n == 1:
        return dpf.generate_keys(alpha, 1)
    return dpf.generate_keys_incremental(alpha, [1] * n)


def hierarchical_plan(prefixes, levels: Sequence[int]) -> list:
    """``evaluate_levels_fused``'s plan: level 0 on a fresh context, level i
    under the nonzeros' prefixes at ``levels[i - 1]`` bits."""
    return [(0, np.array([], dtype=np.uint64))] + [
        (i, prefixes[levels[i - 1]]) for i in range(1, len(levels))]


def resolve_engine(engine: str, device) -> str:
    """``--engine auto`` is the host engine only where the caller named the
    CPU; everything else runs on the device path."""
    if engine not in ("auto", "device", "host"):
        raise ValueError(f"engine must be auto, device or host, got {engine!r}")
    if engine != "auto":
        return engine
    return "host" if device is not None and str(device) == "cpu" else "device"


@dataclasses.dataclass
class Run:
    """One run's outputs and times.

    `outputs`: the values of the last iteration as uint32 arrays, one per
    hierarchy level ([K, n_level]) for hierarchical, one [K, P] for direct.
    `seconds`: the wall of all iterations; `prepare_seconds`: the level
    plan's composition (hierarchical on the device, once); `host_seconds`:
    the host part measured apart from the card (direct on the device: the
    walk points' tables, ``prepare_walk_points``, once)."""

    outputs: List[np.ndarray]
    seconds: float
    iterations: int
    prepare_seconds: Optional[float] = None
    host_seconds: Optional[float] = None

    @property
    def per_iteration(self) -> float:
        return self.seconds / self.iterations


def _sync(dev) -> None:
    if dev.type == "cuda":
        import torch

        torch.cuda.synchronize(dev)


def run_hierarchical(dpf, keys, plan, *, engine: str = "device", mode: str = "fused",
                     device=None, num_iterations: int = 1, log=None) -> Run:
    """Evaluates `keys` (one party) over `plan` (``hierarchical_plan``)
    `num_iterations` times, each on a fresh context. On the device the plan
    is prepared once (timed as ``prepare_seconds``) and replayed with the
    outputs kept on the device until the last iteration ends; the host
    engine runs ``evaluate_until_batch(engine="host")`` a level."""
    from ..ops import hierarchical
    from ..utils.devices import resolve_device

    if num_iterations < 1:
        raise ValueError("num_iterations must be >= 1")
    say = log or (lambda msg: None)
    levels = [p.log_domain_size for p in dpf.validator.parameters]
    if engine == "host":
        t0 = time.perf_counter()
        for _ in range(num_iterations):
            ctx = hierarchical.BatchedContext.create(dpf, keys)
            outs = [np.asarray(hierarchical.evaluate_until_batch(ctx, h, p, engine="host"),
                               dtype=np.uint32) for h, p in plan]
        seconds = time.perf_counter() - t0
        for h, o in enumerate(outs):
            say(f"# outputs at level {h} (log_domain {levels[h]}): {o.shape[1]}")
        return Run(outs, seconds, num_iterations)
    if engine != "device":
        raise ValueError(f"engine must be 'device' or 'host', got {engine!r}")
    dev = resolve_device(device)
    t0 = time.perf_counter()
    prepared = hierarchical.prepare_levels_fused(
        hierarchical.BatchedContext.create(dpf, keys), plan, mode=mode, device=dev)
    _sync(dev)
    prepare_seconds = time.perf_counter() - t0
    say(f"# plan prepared in {prepare_seconds:.2f} s (once, amortized across iterations)")
    t0 = time.perf_counter()
    for _ in range(num_iterations):
        ctx = hierarchical.BatchedContext.create(dpf, keys)
        outs = hierarchical.evaluate_levels_fused(ctx, prepared, device_output=True, mode=mode,
                                                  device=dev)
        _sync(dev)
    seconds = time.perf_counter() - t0
    pulled = [o[:, :, 0] for o in hierarchical.pull(outs)]
    for h, o in enumerate(pulled):
        say(f"# outputs at level {h} (log_domain {levels[h]}): {o.shape[1]}")
    return Run(pulled, seconds, num_iterations, prepare_seconds=prepare_seconds)


def run_direct(dpf, keys, points: np.ndarray, *, engine: str = "device", mode: str = "walk",
               device=None, num_iterations: int = 1, log=None) -> Run:
    """Evaluates `keys` (one party) at `points` (uint64 or U128, the
    nonzeros) `num_iterations` times: ``evaluate_at_batch`` on the device,
    ``host_eval.evaluate_at_host`` on the host engine. On the device the
    walk points' host tables are also built once apart from the loop and
    timed as ``host_seconds`` (each iteration builds its own, as a caller's
    would)."""
    from ..core import host_eval
    from ..ops import evaluator
    from ..utils.devices import resolve_device

    if num_iterations < 1:
        raise ValueError("num_iterations must be >= 1")
    say = log or (lambda msg: None)
    if engine == "host":
        t0 = time.perf_counter()
        for _ in range(num_iterations):
            out = host_eval.evaluate_at_host(dpf, keys, points)
        seconds = time.perf_counter() - t0
        say(f"# outputs: {out.shape}")
        return Run([out.astype(np.uint32)], seconds, num_iterations)
    if engine != "device":
        raise ValueError(f"engine must be 'device' or 'host', got {engine!r}")
    dev = resolve_device(device)
    t0 = time.perf_counter()
    evaluator.prepare_walk_points(dpf, points, mode=mode, device=dev)
    _sync(dev)
    host_seconds = time.perf_counter() - t0
    say(f"# the walk points' host tables: {host_seconds:.2f} s")
    t0 = time.perf_counter()
    for _ in range(num_iterations):
        out = evaluator.evaluate_at_batch(dpf, keys, points, mode=mode, device=dev)
    seconds = time.perf_counter() - t0
    say(f"# outputs: {out.shape}")
    return Run([np.ascontiguousarray(out[:, :, 0])], seconds, num_iterations,
               host_seconds=host_seconds)


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch

    from ..ops import aes_cuda
    from ..utils.devices import resolve_device

    def say(msg):
        print(msg, file=sys.stderr, flush=True)

    engine = resolve_engine(args.engine, args.device)
    kind = "direct" if args.only_nonzeros else "hierarchical"
    mode = args.mode or MODES[kind][0]
    if mode not in MODES[kind]:
        raise SystemExit(f"--mode for {kind} runs: one of {', '.join(MODES[kind])}, got {mode!r}")
    dev = torch.device("cpu") if engine == "host" else resolve_device(args.device)
    say(f"# engine: {engine}" + ("" if engine == "host" else f", mode {mode}, device {dev}"))

    lds = args.log_domain_size
    t0 = time.perf_counter()
    nonzeros = (read_nonzeros(args.input, lds) if args.input
                else np.arange(4, dtype=np.uint64))
    prefixes = compute_prefixes(nonzeros, lds)
    num_nonzeros = len(prefixes[-1])
    say(f"# nonzeros: {num_nonzeros}; input and prefixes in {time.perf_counter() - t0:.2f} s")
    if args.levels_to_evaluate:
        levels = [int(x) for x in args.levels_to_evaluate.split(",")]
    elif not args.only_nonzeros and num_nonzeros:
        levels = compute_levels_to_evaluate(prefixes, lds, args.max_expansion_factor)
    else:
        levels = [lds]
    say(f"# levels to evaluate: {levels}")

    alpha = draw_alpha(lds)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    aes_cuda.reset_launch_counts()
    if args.only_nonzeros:
        dpf = create_dpf(lds)
        key, _ = generate_keys(dpf, alpha)
        run = run_direct(dpf, [key], nonzeros, engine=engine, mode=mode, device=dev,
                         num_iterations=args.num_iterations, log=say)
    else:
        dpf = create_dpf(lds, levels)
        key, _ = generate_keys(dpf, alpha)
        run = run_hierarchical(dpf, [key], hierarchical_plan(prefixes, levels), engine=engine,
                               mode=mode, device=dev, num_iterations=args.num_iterations,
                               log=say)
    launches = {k.name: k.launches for k in aes_cuda.KERNELS if k.launches}
    record = {
        "bench": "experiments",
        "mode": kind,
        "input": os.path.basename(args.input) if args.input else "none",
        "log_domain_size": lds,
        "num_nonzeros": num_nonzeros,
        "levels": levels,
        "value": run.per_iteration,
        "unit": "s/key/iteration",
        "engine": engine,
        "device": str(dev),
        "platform": "gpu" if dev.type == "cuda" else "cpu",
    }
    if engine == "device":
        record["kernel_mode"] = mode
    if run.prepare_seconds is not None:
        record["prepare_seconds"] = run.prepare_seconds
    if run.host_seconds is not None:
        record["host_seconds"] = run.host_seconds
    if dev.type == "cuda":
        record["device_name"] = torch.cuda.get_device_name(dev)
        record["peak_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
        record["launches"] = launches
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
