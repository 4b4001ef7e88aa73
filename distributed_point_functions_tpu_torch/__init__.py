"""Distributed point functions on PyTorch and hand-written CUDA kernels.

The PyTorch/CUDA port of ``distributed_point_functions_tpu``, beside it in
the same repository. It imports neither JAX nor that package: the host
protocol layers it needs (``core/``) are its own copies. Slice by slice it
ports the JAX package's paths; so far full-domain evaluation folded on the
device or with its values out (every value type: Int, XorWrapper, IntModN,
tuples), its two-server PIR inner product, batched EvaluateAt, batched DCF
evaluation (tuple payloads included) and the FSS gates on it with their
wire format, the heavy-hitters hierarchical advance and batched two-party
key generation:

    from distributed_point_functions_tpu_torch import (
        DistributedComparisonFunction, DistributedPointFunction, DpfParameters,
        Int, IntModN)
    from distributed_point_functions_tpu_torch.dcf import batch as dcf_batch
    from distributed_point_functions_tpu_torch.ops import evaluator

    dpf = DistributedPointFunction.create(DpfParameters(20, Int(64)))
    keys_a, keys_b = dpf.generate_keys_batch(alphas, [betas], seeds=seeds)
    for valid, fold in evaluator.full_domain_fold_chunks(dpf, keys_a):
        ...
    shares = evaluator.evaluate_at_batch(dpf, keys_a, points, mode="walkkernel")

    modn = DistributedPointFunction.create_incremental(
        [DpfParameters(3 * (i + 1), IntModN(64, 2**64 - 59)) for i in range(8)])
    m_a, m_b = modn.generate_keys_batch(alphas, betas_by_level, seeds=seeds)
    for valid, values in evaluator.full_domain_evaluate_chunks(
            modn, m_a, hierarchy_level=7, key_chunk=8, mode="fused"):
        ...  # int32[8, 2^24, 2] residue limbs on the card

    dcf = DistributedComparisonFunction.create(24, Int(64))
    dcf_a, dcf_b = dcf.generate_keys_batch(alphas, betas, seeds=seeds)
    shares = dcf_batch.batch_evaluate(dcf, dcf_a, xs, mode="walkkernel")
    # shares of party 0 + party 1 == beta where x < alpha, else 0

    from distributed_point_functions_tpu_torch import gates, protos
    relu = gates.ReluGate.create(16)  # one Tuple(Int(32) x 4) DCF key a gate
    k0, k1 = relu.gen(r_in, [r_out])  # the dealer
    wire = protos.serialize_gate_key(k0, relu.dcf.dpf.validator.parameters)
    s0 = relu.batch_eval(protos.parse_gate_key(wire), masked_xs)  # K6 + K4
    # (s0 + s1 - r_out) mod 2^16 == max(x_real, 0), x_real signed

    from distributed_point_functions_tpu_torch.ops import hierarchical
    hh = DistributedPointFunction.create_incremental(
        [DpfParameters(i + 1, Int(64)) for i in range(128)])
    hh_a, hh_b = hh.generate_keys_batch(alphas, betas_by_level, seeds=seeds)
    ctx = hierarchical.BatchedContext.create(hh, hh_a)
    plan = hierarchical.bitwise_hierarchy_plan(128, finals)
    shares = hierarchical.evaluate_levels_fused(ctx, plan, mode="hierkernel")
    # per level: shares of beta at alpha's prefix, 0 at the other candidates

    from distributed_point_functions_tpu_torch.ops import keygen_batch
    keys_a, keys_b = keygen_batch.generate_keys_batch(
        dpf, alphas, [betas], mode="megakernel")  # one K9 launch

The bulk entry points run their key chunks through a pipelined executor
(``ops/pipeline.py``, ``pipeline=``: the host packs chunk N+1 while the card
runs chunk N), take ``integrity=`` (a sentinel probe key checked against the
host oracle, ``utils/integrity.py``), and report to the telemetry bus
(``utils/telemetry.py``). The ``*_robust`` wrappers of ``ops/supervisor.py``
walk a degradation chain with retries, chunk halving, deadlines and a
crash-safe journal: on a card its rungs are the kernel modes only (a kernel
mode, then the per-level kernels), on the CPU the plain versions and then
the numpy host engine of ``core/host_eval.py``:

    from distributed_point_functions_tpu_torch.ops import supervisor
    answers = supervisor.pir_query_batch_robust(dpf, keys_a, prepared_db,
                                                mode="megakernel")

The serving plane (``serving/``) puts those wrappers behind a continuous
batcher, a cost-model router and a socket server speaking the JAX
package's wire frames: two non-colluding servers, each one process
holding one key share. Party 0 and party 1 each run
``python -m distributed_point_functions_tpu_torch.serving.server --pir-db
cfg5:24:7 --ready-file ...`` (``--device cpu`` for the CPU); then:

    from distributed_point_functions_tpu_torch import serving
    with serving.TwoServerClient([("127.0.0.1", port_0),
                                  ("127.0.0.1", port_1)]) as client:
        a0, a1 = client.pir(dpf.validator.parameters, (keys_a, keys_b), "cfg5")
    # a0 ^ a1 == db[alpha] for each query: neither server learned alpha

Entry points run on the first CUDA device unless the caller passes
``device="cpu"``; with no card and no ``device="cpu"`` they raise. Only
the ``*_robust`` wrappers fall back, and only when asked to.
"""

from .core.dpf import DistributedPointFunction
from .core.keys import CorrectionWord, DpfKey
from .core.params import DpfParameters
from .core.value_types import Int, IntModN, TupleType, XorWrapper
from .dcf.dcf import DcfKey, DistributedComparisonFunction

__all__ = [
    "CorrectionWord",
    "DcfKey",
    "DistributedComparisonFunction",
    "DistributedPointFunction",
    "DpfKey",
    "DpfParameters",
    "Int",
    "IntModN",
    "TupleType",
    "XorWrapper",
]
