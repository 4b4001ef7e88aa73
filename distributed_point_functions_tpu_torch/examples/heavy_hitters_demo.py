"""Two-server private heavy hitters over the wire format.

N clients each hold a private value; two non-colluding servers learn
which values are held by >= `threshold` clients, and nothing else about a
client (BM_HeavyHitters of the reference's benchmarks; the Poplar /
heavy-hitters literature).

Protocol (semi-honest, additive shares mod 2^64):

1. Every client builds an incremental DPF key pair for the point function
   f(x) = 1 at its value, one hierarchy level per `bits_per_level` bits,
   and sends one serialized key to each server (the byte-compatible wire
   format: servers parse, never see a value).
2. Level by level, each server evaluates all client keys under the
   surviving candidate prefixes (``ops/hierarchical.BatchedContext``) and
   sums the shares a prefix over the clients, through the job supervisor's
   robust wrapper (``ops/supervisor.evaluate_levels_fused_robust``: the
   deadlines, the host-oracle spot checks and the degradation chain).
3. The servers exchange their aggregate shares (two uint64 vectors, the
   only communication), reconstruct the counts, and keep the prefixes
   with count >= threshold for the next level.

    python -m distributed_point_functions_tpu_torch.examples.heavy_hitters_demo \\
        [--device cpu] [--serve]

``HH_MODE`` selects the servers' execution:

* ``fused`` (default): the fused advance on ``--device`` through the robust
  wrapper (K2 a tree level, K4 a hierarchy level on the card);
* ``hierkernel``: the hierarchical megakernel through the same wrapper
  (K8 a prefix window; an advance K8 cannot express runs fused's rung);
* ``host``: the native host engine, no supervisor (the baseline arm).

``--serve`` runs the streaming deployment instead: two in-process RPC
servers on loopback (party 1 the follower, party 0 the aggregation leader
driving the window advance against it, each stream advancing on
``--device``), clients uploading key batches through the ``hh_ingest``
wire op into rolling window generations (journaled before the
acknowledgement), windows closing at ``HH_WINDOW`` keys, and the final
``hh_snapshot`` compared a window with the plaintext counts.

Knobs: ``HH_CLIENTS`` (default 120), ``HH_THRESHOLD`` (8), ``HH_WINDOW``
(48), ``HH_MODE``. ``--device`` defaults to the card; ``cpu`` runs the
kernels' plain versions.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

BITS = 16  # value width
BITS_PER_LEVEL = 2
HH_MODES = ("fused", "hierkernel", "host")
HEAVY = (0xBEEF, 0x1234, 0xC0DE)


def _knobs():
    return (int(os.environ.get("HH_CLIENTS", 120)), int(os.environ.get("HH_THRESHOLD", 8)),
            os.environ.get("HH_MODE", "fused"))


def client_values(num_clients: int, threshold: int) -> list:
    """A few heavy hitters over `threshold` plus uniform noise, shuffled."""
    rng = np.random.default_rng(2026)
    values = []
    for h in HEAVY:
        values += [h] * (threshold + int(rng.integers(0, 5)))
    while len(values) < num_clients:
        values.append(int(rng.integers(0, 1 << BITS)))
    rng.shuffle(values)
    return values[:num_clients]


def _print_launches() -> None:
    from ..ops import aes_cuda

    print("launches: " + json.dumps({k.name: k.launches for k in aes_cuda.KERNELS
                                     if k.launches}))


def serve_main(dev) -> int:
    """The streaming tier: the protocol of `main` as a live two-server
    service, with batched client uploads over the wire, rolling crash-safe
    window generations and continuous publishes."""
    from .. import serving
    from ..core.dpf import DistributedPointFunction

    num_clients, threshold, _ = _knobs()
    window_keys = int(os.environ.get("HH_WINDOW", 48))
    cfg = serving.StreamConfig.bitwise("demo", BITS, BITS_PER_LEVEL, threshold,
                                       window_keys=window_keys)
    dpf = DistributedPointFunction.create_incremental(list(cfg.parameters))
    n_levels = len(cfg.parameters)
    values = client_values(num_clients, threshold)

    tmp = tempfile.mkdtemp(prefix="dpf-hh-serve-")
    follower = serving.DpfServer(engine="device", max_wait_ms=1.0, device=dev)
    follower.register_stream(serving.HeavyHitterStream(cfg, os.path.join(tmp, "party1"),
                                                       device=dev))
    follower.start()
    leader = serving.DpfServer(engine="device", max_wait_ms=1.0, device=dev)
    leader.register_stream(serving.HeavyHitterStream(
        cfg, os.path.join(tmp, "party0"), peer=("127.0.0.1", follower.port), device=dev))
    leader.start()
    print(f"# two-server streaming pair up: leader :{leader.port} (party 0), follower "
          f":{follower.port} (party 1); window_keys={window_keys}, streams on {dev}, "
          f"journals under {tmp}")

    # Backpressure (RESOURCE_EXHAUSTED while max_pending_windows are still
    # advancing) is retried: a process's first window advance on the card
    # can take seconds, so the policy waits up to about a minute.
    client = serving.TwoServerClient(
        [("127.0.0.1", leader.port), ("127.0.0.1", follower.port)],
        policy=serving.RetryPolicy(attempts=60, base_backoff=0.05, max_backoff=1.0, seed=0),
    )
    batch_size = 4
    batch_values = {}
    t0 = time.time()
    try:
        for start in range(0, len(values), batch_size):
            vals = values[start:start + batch_size]
            bid = f"client-{start // batch_size}"
            batch_values[bid] = vals
            keys0, keys1 = [], []
            for v in vals:
                k0, k1 = dpf.generate_keys_incremental(v, [1] * n_levels)
                keys0.append(k0)
                keys1.append(k1)
            client.hh_ingest("demo", cfg.parameters, (keys0, keys1), bid, deadline=60)
        client.hh_ingest("demo", cfg.parameters, ([], []), "", flush=True, deadline=30)
        print(f"# {len(batch_values)} client batches x {batch_size} keys ingested + flushed "
              f"in {time.time() - t0:.2f}s (journaled before every ack)")

        deadline = time.time() + 300
        snap = None
        while time.time() < deadline:
            snap = client.clients[0].hh_snapshot("demo", deadline=10)
            done = {b for w in snap["published"] for b in w["batch_ids"]}
            if len(done) == len(batch_values) and snap["pending_windows"] == 0:
                break
            time.sleep(0.2)

        ok = True
        for w in snap["published"]:
            vals = [v for b in w["batch_ids"] for v in batch_values[b]]
            cnt = collections.Counter(vals)
            want = {v: c for v, c in cnt.items() if c >= threshold}
            got = {int(p): int(c) for p, c in zip(w["prefixes"], w["counts"])}
            hot = {hex(k): v for k, v in sorted(got.items())}
            print(f"# window {w['generation']}: {len(w['batch_ids'])} batches, {w['keys']} "
                  f"keys -> {hot}")
            if got != want:
                ok = False
                print(f"MISMATCH vs batch oracle: want {want}")
        seen = sorted(b for w in snap["published"] for b in w["batch_ids"])
        if seen != sorted(batch_values):
            ok = False
            print("MISMATCH: published membership is not exactly-once")
        print(f"# stream stats: {snap['stats']}")
        if not ok:
            return 1
        _print_launches()
        print("OK: every window's published counts equal its batch oracle "
              "(no lost, no double-counted keys)")
        return 0
    finally:
        client.close()
        leader.stop()
        follower.stop()
        shutil.rmtree(tmp, ignore_errors=True)


def main(dev) -> int:
    from ..core.dpf import DistributedPointFunction
    from ..core.params import DpfParameters
    from ..core.value_types import Int
    from ..ops import evaluator, hierarchical, supervisor
    from ..protos import serialization as ser

    num_clients, threshold, hh_mode = _knobs()
    if hh_mode not in HH_MODES:
        print(f"unknown HH_MODE {hh_mode!r} ({'|'.join(HH_MODES)})")
        return 2

    # --- client values: a few heavy hitters + uniform noise --------------
    values = client_values(num_clients, threshold)
    true_counts = collections.Counter(values)
    want = sorted(v for v, c in true_counts.items() if c >= threshold)

    params = [DpfParameters(lds, Int(64))
              for lds in range(BITS_PER_LEVEL, BITS + 1, BITS_PER_LEVEL)]
    dpf = DistributedPointFunction.create_incremental(params)
    n_levels = len(params)

    # --- clients: keygen + serialize (one key per server) ----------------
    t0 = time.time()
    wire_a, wire_b = [], []
    for v in values:
        ka, kb = dpf.generate_keys_incremental(v, [1] * n_levels)
        wire_a.append(ser.serialize_dpf_key(ka, params))
        wire_b.append(ser.serialize_dpf_key(kb, params))
    key_bytes = sum(len(b) for b in wire_a)
    print(f"# {num_clients} clients: keygen + serialize {time.time() - t0:.2f}s, "
          f"{key_bytes / num_clients:.0f} B/key on the wire")

    # --- servers: parse once, then level-by-level aggregation ------------
    ctx_a = hierarchical.BatchedContext.create(dpf, [ser.parse_dpf_key(b) for b in wire_a])
    ctx_b = hierarchical.BatchedContext.create(dpf, [ser.parse_dpf_key(b) for b in wire_b])

    def server_advance(ctx, level, prefixes) -> np.ndarray:
        """One server's shares a candidate for one level, uint64[clients,
        candidates]: the robust wrapper on `dev` (fused / hierkernel) or
        the host engine (host)."""
        if hh_mode == "host":
            out = hierarchical.evaluate_until_batch(ctx, level, prefixes, engine="host")
            return out.astype(np.uint64)
        limbs = supervisor.evaluate_levels_fused_robust(
            ctx, [(level, list(prefixes))], mode=hh_mode, device=dev)[0]
        return evaluator.values_to_numpy(limbs, 64)

    print(f"# server mode: {hh_mode}" + (
        " (native host engine)" if hh_mode == "host" else f" on {dev} (robust supervisor wrapper)"))
    t0 = time.time()
    prefixes = []
    for level in range(n_levels):
        # Each server: shares for every candidate child prefix, summed over
        # the clients (the aggregate hides each contribution).
        agg_a = server_advance(ctx_a, level, prefixes).sum(axis=0, dtype=np.uint64)
        agg_b = server_advance(ctx_b, level, prefixes).sum(axis=0, dtype=np.uint64)
        # The only server-to-server exchange: two aggregate vectors.
        counts = (agg_a + agg_b).astype(np.uint64)  # mod 2^64
        survivors = np.nonzero(counts >= threshold)[0]
        # Candidate i is (prefix index << bits_per_level) + child: sorted
        # prefix, then leaf, the streaming window manager's mapping too.
        cand = hierarchical.candidate_children(
            prefixes, level * BITS_PER_LEVEL, (level + 1) * BITS_PER_LEVEL)
        prefixes = sorted(int(cand[i]) for i in survivors)
        print(f"# level {level}: {counts.shape[0]} candidates -> {len(prefixes)} survivors")
        if not prefixes:
            break
    elapsed = time.time() - t0

    got = sorted(prefixes)
    print(f"# aggregation: {elapsed:.2f}s for {n_levels} levels x {num_clients} clients")
    print(f"heavy hitters found: {[hex(v) for v in got]}")
    print(f"expected:            {[hex(v) for v in want]}")
    if got != want:
        print("MISMATCH")
        return 1
    for v in got:
        print(f"  {hex(v)}: true count {true_counts[v]}")
    _print_launches()
    print("OK: servers learned only the heavy hitters and their counts")
    return 0


def cli(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help='the device (default: the card; "cpu": the kernels\' plain versions)')
    ap.add_argument("--serve", action="store_true",
                    help="the streaming deployment: two servers on loopback, windows, publishes")
    args = ap.parse_args(argv)
    from ..utils.devices import resolve_device

    dev = resolve_device(args.device)
    return serve_main(dev) if args.serve else main(dev)


if __name__ == "__main__":
    sys.exit(cli())
