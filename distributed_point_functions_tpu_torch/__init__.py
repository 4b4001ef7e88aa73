"""Distributed point functions on PyTorch and hand-written CUDA kernels.

The PyTorch/CUDA port of ``distributed_point_functions_tpu``, beside it in
the same repository. It imports neither JAX nor that package: the host
protocol layers it needs (``core/``) are its own copies. Slice by slice it
ports the JAX package's paths; this one carries full-domain evaluation
folded on the device and its two-server PIR inner product:

    from distributed_point_functions_tpu_torch import (
        DistributedPointFunction, DpfParameters, Int)
    from distributed_point_functions_tpu_torch.ops import evaluator

    dpf = DistributedPointFunction.create(DpfParameters(20, Int(64)))
    keys_a, keys_b = dpf.generate_keys_batch(alphas, [betas], seeds=seeds)
    for valid, fold in evaluator.full_domain_fold_chunks(dpf, keys_a):
        ...

Entry points run on the first CUDA device unless the caller passes
``device="cpu"``; with no card and no ``device="cpu"`` they raise.
"""

from .core.dpf import DistributedPointFunction
from .core.keys import CorrectionWord, DpfKey
from .core.params import DpfParameters
from .core.value_types import Int, IntModN, TupleType, XorWrapper

__all__ = [
    "CorrectionWord",
    "DistributedPointFunction",
    "DpfKey",
    "DpfParameters",
    "Int",
    "IntModN",
    "TupleType",
    "XorWrapper",
]
