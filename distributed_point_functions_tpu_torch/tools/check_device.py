"""Device-correctness checker: one execution path on the card vs the host
oracle.

Runs ``utils.integrity.run_device_check`` in one mode at one or more
(keys, log-domain) shapes, then the optional extras, prints one verdict
line a shape, the telemetry summary of the run, and exits 1 on any
mismatch. Run it on a new card, or after a change to a kernel:

    python -m distributed_point_functions_tpu_torch.tools.check_device
    CHECK_MODE=megakernel python -m distributed_point_functions_tpu_torch.tools.check_device
    CHECK_MODE=fold python -m distributed_point_functions_tpu_torch.tools.check_device --device cpu

Environment (the JAX package's ``tools/check_device.py`` names):

- ``CHECK_MODE``: the path, one of ``integrity.CHECK_MODES`` (default
  "levels"), or "all" for each of them in turn; "hierkernel" reads a shape
  as (keys, levels);
- ``CHECK_SHAPES``: comma-separated KEYSxLOGDOMAIN shapes (default
  "64x20");
- ``CHECK_PIPELINE``: 1 forces the pipelined chunk executor, 0 the serial
  path, unset the default (ops/pipeline.py); qualify a card with both;
- ``CHECK_EXTRAS``: a comma-separated subset of dcf, evalat, hierarchy,
  prepared, sharded, or "all": the DCF walk, the EvaluateAt walk, the fused
  hierarchy advance checked at every level against the host engine, one
  prepared plan replayed across two key batches, a 1x1-mesh PIR.

``--device`` names the device (default: the card; "cpu" runs the kernels'
plain versions). Before the verdict it prints one JSON record: the platform
("gpu" or "cpu"), the modes, the failures and the launches.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def _shapes(spec: str):
    try:
        return [tuple(int(v) for v in s.split("x")) for s in spec.split(",")]
    except ValueError:
        raise SystemExit(f"CHECK_SHAPES must be KEYSxLOGDOMAIN[,...], got {spec!r}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help='the device to check (default: the card; "cpu": the plain versions)')
    args = ap.parse_args(argv)

    import torch

    from .. import native
    from ..ops import aes_cuda
    from ..utils import envflags, integrity, telemetry
    from ..utils.devices import resolve_device
    from ..utils.errors import DataCorruptionError, InternalError, InvalidArgumentError

    dev = resolve_device(args.device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    st = native.status()
    print(f"device: {dev} ({name}); torch {torch.__version__}; host engine: "
          f"{st['path'] or 'numpy (' + str(st['reason']) + ')'}, {native.cpu_model()}")
    mode = envflags.env_str("CHECK_MODE", "levels") or "levels"
    shapes = _shapes(envflags.env_str("CHECK_SHAPES", "64x20") or "64x20")
    try:
        pipeline = envflags.env_opt_bool("CHECK_PIPELINE")
    except InvalidArgumentError as e:
        raise SystemExit(str(e))
    modes = integrity.CHECK_MODES if mode == "all" else (mode,)
    rng = np.random.default_rng(7)
    failures = 0
    with telemetry.capture() as tel:
        for m in modes:
            try:
                failures += integrity.run_device_check(
                    shapes=shapes, mode=m, device=dev, pipeline=pipeline)
            except (DataCorruptionError, InternalError) as e:
                print(f"SELF-TEST FAILED: {e}")
                failures += 1
        failures += _run_extras(dev, rng)
    # This process's kernel launches, for a caller that counts them.
    launches = {k.name: k.launches for k in aes_cuda.KERNELS if k.launches}
    print("launches: " + json.dumps(launches))
    print(telemetry.summary(tel.snapshot()))
    print(json.dumps({"tool": "check_device", "platform": "gpu" if dev.type == "cuda" else "cpu",
                      "device": str(dev), "device_name": name, "modes": list(modes),
                      "shapes": [list(s) for s in shapes], "failures": failures,
                      "launches": launches}))
    if failures:
        print(f"DEVICE OUTPUT IS WRONG on {dev}: do not trust its performance numbers.")
        return 1
    print("all shapes verified against the host oracle")
    return 0


def _hh_plan(levels: int, num_finals: int, rng):
    """A heavy-hitters plan: every one-level advance under the surviving
    prefixes of `num_finals` random leaves."""
    from ..ops import hierarchical

    return hierarchical.bitwise_hierarchy_plan(
        levels, hierarchical.draw_random_finals(levels, num_finals, rng))


def _fused_matches_host(dpf, key, outs, plan) -> bool:
    """The fused advance's outputs against the host engine, level by level,
    on a fresh context."""
    from ..ops import evaluator, hierarchical

    host = hierarchical.BatchedContext.create(dpf, [key])
    for i, (h, p) in enumerate(plan):
        ref = hierarchical.evaluate_until_batch(host, h, p, engine="host")
        got = evaluator.values_to_numpy(np.asarray(outs[i])[0], 64)
        if not np.array_equal(got.astype(np.uint64), np.asarray(ref)[0].astype(np.uint64)):
            return False
    return True


def _run_extras(dev, rng) -> int:
    """The checks ``CHECK_EXTRAS`` selects; returns the failed ones."""
    from ..core.dpf import DistributedPointFunction
    from ..core.host_eval import evaluate_at_host
    from ..core.params import DpfParameters
    from ..core.value_types import Int, XorWrapper
    from ..ops import evaluator, hierarchical
    from ..utils.envflags import env_int, env_str

    extras = env_str("CHECK_EXTRAS", "") or ""
    if not extras:
        return 0
    known = ("dcf", "evalat", "hierarchy", "prepared", "sharded")
    want = set(known) if extras == "all" else {x.strip() for x in extras.split(",")}
    unknown = want - set(known)
    if unknown:
        raise SystemExit(f"CHECK_EXTRAS: unknown {sorted(unknown)}; known {known} or 'all'")
    failures = 0

    def verdict(name, ok, detail=""):
        nonlocal failures
        print(f"extra {name}: {'OK' if ok else 'MISMATCH'} {detail}")
        failures += 0 if ok else 1

    if "dcf" in want:
        # The DCF walk (K6 a level, K4 a depth) against the host engine.
        from ..dcf import batch as dcf_batch
        from ..dcf.dcf import DistributedComparisonFunction
        from ..ops import supervisor

        lds = env_int("CHECK_DCF_LDS", 16)
        dcf = DistributedComparisonFunction.create(lds, Int(64))
        ka, _ = dcf.generate_keys(int(rng.integers(0, 1 << lds)), 4242)
        xs = [int(x) for x in rng.integers(0, 1 << lds, size=512)]
        got = np.asarray(dcf_batch.batch_evaluate(dcf, [ka], xs, device=dev))
        host, covered = supervisor._dcf_host_limbs(dcf, [ka], xs, 64, cap=32)
        verdict("dcf-walk", np.array_equal(got[:, :covered], host),
                f"(lds={lds}, 512 pts, {covered} host-checked)")

    if "evalat" in want:
        # The EvaluateAt walk (K6 a level, K4) against the host oracle.
        lds = env_int("CHECK_EVALAT_LDS", 32)
        dpf = DistributedPointFunction.create(DpfParameters(lds, Int(64)))
        alpha = int(rng.integers(0, 1 << lds))
        k0, _ = dpf.generate_keys(alpha, 777)
        pts = [alpha] + [int(x) for x in rng.integers(0, 1 << lds, size=511)]
        got = evaluator.values_to_numpy(
            np.asarray(evaluator.evaluate_at_batch(dpf, [k0], pts, device=dev)), 64)
        host = evaluate_at_host(dpf, [k0], np.asarray(pts, dtype=np.uint64))
        verdict("evalat-walk", np.array_equal(got, host.astype(np.uint64)),
                f"(lds={lds}, 512 pts, all host-checked)")

    if "hierarchy" in want:
        # The fused advance (K2 a tree level, K4 a hierarchy level) against
        # the host engine at every level.
        levels = env_int("CHECK_HH_LEVELS", 24)
        dpf = DistributedPointFunction.create_incremental(
            [DpfParameters(i + 1, Int(64)) for i in range(levels)])
        kh, _ = dpf.generate_keys_incremental(int(rng.integers(0, 1 << levels)), [23] * levels)
        plan = _hh_plan(levels, 500, rng)
        outs = hierarchical.evaluate_levels_fused(
            hierarchical.BatchedContext.create(dpf, [kh]), plan,
            group=env_int("CHECK_HH_GROUP", 8), device=dev)
        verdict("hierarchy-fused", _fused_matches_host(dpf, kh, outs, plan),
                f"({levels} levels, 500 nonzeros)")

    if "prepared" in want:
        # One prepared plan (the key-independent tables, built once)
        # replayed across two key batches: the heavy-hitters aggregation.
        levels = env_int("CHECK_PREP_LEVELS", 16)
        dpf = DistributedPointFunction.create_incremental(
            [DpfParameters(i + 1, Int(64)) for i in range(levels)])
        plan = _hh_plan(levels, 200, rng)
        keys = [dpf.generate_keys_incremental(int(rng.integers(0, 1 << levels)), [b] * levels)[0]
                for b in (31, 17)]
        prepared = hierarchical.prepare_levels_fused(
            hierarchical.BatchedContext.create(dpf, [keys[0]]), plan,
            env_int("CHECK_PREP_GROUP", 8), device=dev)
        ok = all(
            _fused_matches_host(dpf, key, hierarchical.evaluate_levels_fused(
                hierarchical.BatchedContext.create(dpf, [key]), prepared, device=dev), plan)
            for key in keys)
        verdict("prepared-replay", ok,
                f"({levels} levels, 200 nonzeros, 2 key batches, one plan)")

    if "sharded" in want:
        # The sharded PIR's walk-to-subtree path on a 1x1 mesh of the device.
        from ..parallel import sharded

        lds = env_int("CHECK_PIR_LDS", 16)
        dpf = DistributedPointFunction.create(DpfParameters(lds, XorWrapper(128)))
        db = rng.integers(0, 2**32, size=(1 << lds, 4), dtype=np.uint64).astype(np.uint32)
        alphas = [int(x) for x in rng.integers(0, 1 << lds, size=8)]
        pairs = [dpf.generate_keys(a, (1 << 128) - 1) for a in alphas]
        mesh = sharded.make_mesh(1, 1, devices=[dev])
        ans = [sharded.pir_query_batch(dpf, [p[s] for p in pairs], db, mesh) for s in (0, 1)]
        verdict("sharded-pir-1x1", np.array_equal(np.asarray(ans[0]) ^ np.asarray(ans[1]),
                                                  db[alphas]),
                f"(2^{lds} x 128-bit, 8 queries)")

    return failures


if __name__ == "__main__":
    sys.exit(main())
