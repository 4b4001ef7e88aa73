"""Two-server private inference: secure ReLU and sigmoid layers over the
wire format.

The secure-ML deployment of the FSS gate family (BCG+ eprint 2020/1392;
the preprocessing model of BGI eprint 2018/707): a dealer (offline) knows
nothing of the data but hands each of two non-colluding servers one gate
key an activation; at inference the servers see only masked activations
``x = x_real + r_in mod N``, uniformly random values that leak nothing,
and return additive shares whose sum less the output mask is exactly the
gate function of ``x_real``. One round, no interaction between the
servers.

Two layers, both on the vector-payload codec (one tuple-payload DCF key a
gate):

* **ReLU**: the two-piece degree-1 spline, signed fixed point;
* **sigmoid**: an 8-piece degree-1 chord spline of 1/(1+e^-x) in fixed
  point (outputs carry 2x the fractional bits).

Flow:

1. **dealer (offline)**: per activation, draw ``r_in`` / ``r_out``, run
   ``gate.gen``, serialize each party's key through the byte-compatible
   wire format (``protos/serialization.serialize_gate_key``);
2. **client**: mask the activation vector and send the same masked vector
   to both servers;
3. **servers**: parse their keys and evaluate the whole layer in one
   batched-DCF pass each on ``--device`` (``gates/framework.bundle_eval``:
   K6 a tree level and K4 a depth on the card);
4. **client**: add the two share vectors, remove the output masks and
   check them bit for bit against the exact-int plaintext gate.

    python -m distributed_point_functions_tpu_torch.examples.secure_relu_demo [--device cpu]

Knobs: ``RELU_BITS`` (default 16), ``RELU_BATCH`` (default 24).
``--device`` defaults to the card; ``cpu`` runs the kernels' plain
versions.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np


def run_layer(name, gate, x_raw, plain, rng, dev, bits: int, batch: int) -> bool:
    """One secure layer end to end: dealer keys -> wire -> two servers ->
    client reconstruction, checked bit for bit against ``plain`` (the
    exact-int plaintext outputs, raw mod N). Returns True on success."""
    from ..gates import framework
    from ..protos import serialization as ser

    n = gate.n
    params = gate.dcf.dpf.validator.parameters

    # --- dealer (offline): masks and per-activation keys --------------------
    t0 = time.time()
    r_ins = [int(r) for r in rng.integers(0, n, size=batch)]
    r_outs = [int(r) for r in rng.integers(0, n, size=batch)]
    wire_a, wire_b = [], []
    for r_in, r_out in zip(r_ins, r_outs):
        k0, k1 = gate.gen(r_in, [r_out])
        wire_a.append(ser.serialize_gate_key(k0, params))
        wire_b.append(ser.serialize_gate_key(k1, params))
    key_bytes = sum(len(b) for b in wire_a)
    print(f"# dealer[{name}]: {batch} keys ({bits}-bit fixed point) in {time.time() - t0:.2f}s, "
          f"{key_bytes / batch:.0f} B/key on the wire ({gate.num_components} component DCFs "
          f"x {gate.payload_elems} payload elements each)")

    # --- client: activations masked once, sent to both servers --------------
    masked = [(x + r) % n for x, r in zip(x_raw, r_ins)]
    # Each masked value is x_real shifted by an independent uniform r_in,
    # itself uniform on [0, N): the servers learn nothing.
    print(f"# client[{name}]: {batch} masked activations ({len(set(masked))} distinct values "
          f"in [0, {n}) — uniform, input-independent)")

    # --- servers: parse the keys, evaluate the layer in one pass each --------
    shares = []
    for server, blobs in (("A", wire_a), ("B", wire_b)):
        keys = [ser.parse_gate_key(b) for b in blobs]
        t0 = time.time()
        out = framework.bundle_eval(gate, keys, masked, engine="device", device=dev)
        print(f"# server {server}[{name}]: {batch} activations on {dev} in "
              f"{time.time() - t0:.2f}s (one batched-DCF pass: {batch * gate.num_components} "
              f"keys x {batch * gate.num_sites} sites)")
        shares.append(out)

    # --- client: reconstruct and check bit for bit ----------------------------
    ok = True
    for b in range(batch):
        y = (int(shares[0][b, 0]) + int(shares[1][b, 0]) - r_outs[b]) % n
        if y != plain[b]:
            ok = False
            print(f"MISMATCH[{name}] at {b}: got {y}, want {plain[b]}")
    return ok


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help='the device (default: the card; "cpu": the kernels\' plain versions)')
    args = ap.parse_args(argv)

    from ..gates import ReluGate, SigmoidGate
    from ..ops import aes_cuda
    from ..utils.devices import resolve_device

    dev = resolve_device(args.device)
    bits = int(os.environ.get("RELU_BITS", 16))
    batch = int(os.environ.get("RELU_BATCH", 24))
    rng = np.random.default_rng(0xAC71)

    # --- layer 1: ReLU ---------------------------------------------------------
    relu = ReluGate.create(bits)
    n = relu.n
    x_real = [int(v) for v in rng.integers(-(n // 2), n // 2, size=batch)]
    x_raw = [relu.signed_lift(v) for v in x_real]
    plain = [relu.plaintext(x) for x in x_raw]
    ok = run_layer("relu", relu, x_raw, plain, rng, dev, bits, batch)
    if ok:
        sample = ", ".join(f"{x_real[b]}->{max(0, x_real[b])}" for b in range(min(6, batch)))
        print(f"# reconstructed[relu]: {sample}, ...")

    # --- layer 2: sigmoid ------------------------------------------------------
    sig = SigmoidGate.create(bits)
    frac = 1 << 5  # frac_bits = 5, the default; outputs carry 2 * frac_bits
    lim = int(6.0 * frac)
    xs_fixed = [int(v) for v in rng.integers(-lim, lim + 1, size=batch)]
    x_raw = [v % n for v in xs_fixed]
    plain = [sig.plaintext(x) for x in x_raw]
    ok2 = run_layer("sigmoid", sig, x_raw, plain, rng, dev, bits, batch)
    if ok2:
        sample = ", ".join(f"{v / frac:+.2f}->{sig.plaintext(v % n) / frac**2:.3f}"
                           for v in xs_fixed[: min(6, batch)])
        print(f"# reconstructed[sigmoid]: {sample}, ...")

    if not (ok and ok2):
        print("MISMATCH")
        return 1
    print("launches: " + json.dumps({k.name: k.launches for k in aes_cuda.KERNELS
                                     if k.launches}))
    print("OK: ReLU and sigmoid layers reconstructed bit-exactly; servers saw only uniformly "
          "masked activations")
    return 0


if __name__ == "__main__":
    sys.exit(main())
