"""Two-server PIR, end to end: two non-colluding servers each hold one DPF
key; the client learns its record, neither server learns the index. The
port's full stack: keygen, the byte-compatible wire format, evaluation on
the card, the XOR inner product.

    python -m distributed_point_functions_tpu_torch.examples.pir_demo \\
        [--log_domain 16] [--device cpu] [--serve]

Roles are separated as a deployment separates them: the client touches
only alpha and the two serialized key blobs; each server parses its blob
and answers on its own against its copy of the database, laid out once at
set-up (``parallel/pir.prepare_pir_database``) and queried through
``pir_query_batch_chunked`` (mode ``fold``: K2 a tree level, then K4).

With ``--serve`` the same query runs through the network stack instead:
two ``serving.DpfServer`` instances on loopback ports (each one party's
RPC front door, answering on ``--device``), a ``serving.TwoServerClient``
with retries and deadlines, and the length-prefixed wire protocol carrying
the key blobs.

``--device`` defaults to the card; ``cpu`` runs the kernels' plain
versions. No card means an error, not a run on the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def serve_mode(dev, db, dpf, params, alpha) -> np.ndarray:
    """--serve: the two-server query through real sockets. Returns the
    reconstructed record."""
    from .. import serving

    servers = [serving.DpfServer(engine="device", max_wait_ms=2.0, device=dev).start()
               for _ in range(2)]
    try:
        for s in servers:
            s.register_db("demo", db)
        print(f"serve: two DpfServers on 127.0.0.1:{servers[0].port} / "
              f"127.0.0.1:{servers[1].port}, answering on {dev}")
        keys = dpf.generate_keys(alpha, (1 << 128) - 1)
        with serving.TwoServerClient([("127.0.0.1", s.port) for s in servers]) as client:
            client.wait_ready(timeout=120)
            # Warm pass: each party's first request builds its state (the
            # layout, the plans), so the printed latency is steady serving.
            wk = dpf.generate_keys(0, 1)
            client.pir(params, ([wk[0]], [wk[1]]), "demo", deadline=300)
            t0 = time.perf_counter()
            a0, a1 = client.pir(params, ([keys[0]], [keys[1]]), "demo", deadline=60)
            dt = time.perf_counter() - t0
        record = np.asarray(a0)[0] ^ np.asarray(a1)[0]
        print(f"serve: both answers over the wire in {dt:.3f}s "
              "(two RPCs, retries/deadline armed)")
        return record
    finally:
        for s in servers:
            s.stop()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--log_domain", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help='the device (default: the card; "cpu": the kernels\' plain versions)')
    ap.add_argument("--serve", action="store_true",
                    help="run the query through the two-server RPC stack on loopback")
    args = ap.parse_args(argv)

    from .. import DistributedPointFunction, DpfParameters, XorWrapper
    from ..ops import aes_cuda
    from ..parallel import pir
    from ..protos import serialization
    from ..utils.devices import resolve_device

    dev = resolve_device(args.device)
    domain = 1 << args.log_domain
    params = DpfParameters(args.log_domain, XorWrapper(128))
    rng = np.random.default_rng(0)

    # ----- set-up: both servers hold the same database ---------------------
    db = rng.integers(0, 2**32, size=(domain, 4), dtype=np.uint32)
    dpf = DistributedPointFunction.create(params)
    print(f"db: 2^{args.log_domain} x 128-bit records, device {dev}")

    if args.serve:
        alpha = int(rng.integers(0, domain))
        record = serve_mode(dev, db, dpf, [params], alpha)
    else:
        prepared = [pir.prepare_pir_database(dpf, db, device=dev) for _ in range(2)]

        # ----- client: wants record `alpha`, produces two key blobs -------
        alpha = int(rng.integers(0, domain))
        k0, k1 = dpf.generate_keys(alpha, (1 << 128) - 1)
        blobs = [serialization.serialize_dpf_key(k, [params]) for k in (k0, k1)]
        print(f"client: query for index {alpha}; key blobs {len(blobs[0])} B each")

        # ----- servers: parse the blob, answer independently ---------------
        # One throwaway query a party first, so that the printed latencies
        # are steady serving rather than first-call set-up.
        for s, warm_key in enumerate(dpf.generate_keys(0, 1)):
            pir.pir_query_batch_chunked(dpf, [warm_key], prepared[s])
        answers = []
        for s, blob in enumerate(blobs):
            key = serialization.parse_dpf_key(blob)
            t0 = time.perf_counter()
            answers.append(pir.pir_query_batch_chunked(dpf, [key], prepared[s])[0])
            print(f"server {s}: answered in {time.perf_counter() - t0:.3f}s")

        # ----- client: XOR the two answers = the record --------------------
        record = answers[0] ^ answers[1]
    assert np.array_equal(record, db[alpha]), "reconstruction failed!"
    print("launches: " + json.dumps({k.name: k.launches for k in aes_cuda.KERNELS
                                     if k.launches}))
    print(f"client: reconstructed record {alpha} = {[hex(int(x)) for x in record]} — matches")
    return 0


if __name__ == "__main__":
    sys.exit(main())
