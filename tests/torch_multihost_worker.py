"""Worker of the port's two-process multihost test (test_torch_multihost.py).

Run as: python torch_multihost_worker.py <process_id> <num_processes> <port> <out.npy>

Each process joins the gloo process group on 127.0.0.1:<port>
(``multihost.initialize``), takes its ``local_key_slice`` of a key batch
that every process derives from the same seeds, answers it with the
sharded PIR over a local (1, 2) CPU mesh and saves its answers for the
parent. No collective computes anything: the DPF math has no cross-key
terms.
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

NUM_KEYS = 5
LOG_DOMAIN = 8


def case():
    """The DPF, party 0's keys and the database every process derives."""
    import distributed_point_functions_tpu_torch as port

    dpf = port.DistributedPointFunction.create(
        port.DpfParameters(LOG_DOMAIN, port.XorWrapper(128)))
    rng = np.random.default_rng(7)
    alphas = [int(a) for a in rng.integers(0, 1 << LOG_DOMAIN, size=NUM_KEYS)]
    seeds = rng.integers(0, 2**32, size=(NUM_KEYS, 2, 4), dtype=np.uint32)
    keys, _ = dpf.generate_keys_batch(alphas, [[(1 << 128) - 1] * NUM_KEYS], seeds=seeds)
    db = rng.integers(0, 2**32, size=(1 << LOG_DOMAIN, 4), dtype=np.uint32)
    return dpf, keys, db


def main() -> None:
    pid, n_proc, port_no, outp = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
    torch.set_num_threads(1)
    from distributed_point_functions_tpu_torch.parallel import multihost, sharded

    multihost.initialize(coordinator_address=f"127.0.0.1:{port_no}", num_processes=n_proc,
                         process_id=pid)
    dpf, keys, db = case()
    lo, hi = multihost.local_key_slice(NUM_KEYS)
    mesh = multihost.local_mesh(shape=(1, 2), devices=["cpu", "cpu"])
    np.save(outp, sharded.pir_query_batch(dpf, keys[lo:hi], db, mesh, integrity=False))
    print(json.dumps({"pid": pid, "lo": lo, "hi": hi,
                      "world": torch.distributed.get_world_size()}), flush=True)
    multihost.shutdown()


if __name__ == "__main__":
    main()
