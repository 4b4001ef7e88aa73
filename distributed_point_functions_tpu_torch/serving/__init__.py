"""The serving plane's core: continuous batching of asynchronously
arriving small requests into the wide uniform batches the card's kernels
need, a cost-model router that picks the numpy host engine or a kernel
mode per batch, executed through the robust wrappers of ops/supervisor.py,
and the two-server RPC boundary (the JAX package's wire frames, both
ways).

    from distributed_point_functions_tpu_torch import serving

    with serving.FrontDoor() as door:          # device=None: the card
        fut = door.submit(serving.Request.evaluate_at(dpf, [key], points))
        limbs = fut.result(timeout=5)

The replica tier (the fleet proxy, autoscaling, leases and the streaming
heavy-hitters tier) is not ported yet.
"""

from . import wire  # noqa: F401
from .batcher import (  # noqa: F401
    ContinuousBatcher,
    Request,
    ServedFuture,
    WarmCache,
    plan_digest,
)
from .client import (  # noqa: F401
    DpfClient,
    PartyUnavailableError,
    RetryPolicy,
    TwoServerClient,
)
from .frontdoor import FrontDoor  # noqa: F401
from .router import (  # noqa: F401
    ANCHORS,
    DISPATCH_SECONDS_PRIOR,
    UNVERIFIED_MODES,
    CostModel,
    RouteDecision,
    Router,
    Workload,
)
from .server import DpfServer  # noqa: F401
