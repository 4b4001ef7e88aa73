"""FSS gate family: DCF-derived two-party gates over masked inputs, the
port's copy of the JAX package's ``gates/``. Every gate compiles onto the
port's batched DCF walk through the shared framework (gates/framework.py —
ONE fused batched-DCF pass per gate batch: K6 and K4 in mode "walk", one
launch of K7's DCF form in mode "walkkernel").

* :class:`MultipleIntervalContainmentGate` — m interval predicates
  (BCG+ Fig. 14), the founding gate.
* :class:`DReluGate` / :class:`ReluGate` — the secure-ML activation pair
  (comparison gate; ReLU as the fixed two-piece spline).
* :class:`SplineGate` — piecewise-polynomial evaluation, the fixed-point
  math workhorse (vector-codec payload by default: ONE tuple-payload DCF
  key per gate instead of m(d+1) scalar keys).
* :class:`SigmoidGate` / :class:`TanhGate` — wide (8-16 piece, degree-1)
  fixed-point activation splines on the vector codec.
* :class:`BitDecompositionGate` — arithmetic-to-boolean share conversion.
"""

from .bitdecomp import BitDecompositionGate  # noqa: F401
from .framework import (  # noqa: F401
    GateKey,
    GatePlan,
    MaskedGate,
    bundle_eval,
)
from .mic import MicKey, MultipleIntervalContainmentGate  # noqa: F401
from .prng import BasicRng, CounterRng, SecurePrng  # noqa: F401
from .relu import DReluGate, ReluGate  # noqa: F401
from .spline import SigmoidGate, SplineGate, TanhGate  # noqa: F401
