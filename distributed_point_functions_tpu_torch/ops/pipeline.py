"""Pipelined chunk executor: overlap pack and upload, the card, and pull.

The port's copy of the JAX package's ``ops/pipeline.py``, on CUDA streams.
A bulk entry point runs its key chunks through three stages:

  1. **launch** (main thread) — the chunk's host pack (numpy), its upload
     from pinned host memory (``PinnedRing``, ``non_blocking``), the launch
     of its kernels on the current stream and, where the caller wants the
     result on the host, the queueing of its copy back into pinned memory
     right behind those kernels (``HostPull``). None of it waits for the
     card, so up to ``depth`` chunks queue on the card while…
  2. **compute** (card) — chunk N's kernels run, and…
  3. **finalize** (one worker thread) — chunk N-1's pull completes (a wait
     on the event recorded after its copy), then the sentinel verification
     and the consumer's fold run on the host. One worker keeps chunk
     completion strictly ordered.

The same code drives the serial mode (``pipeline=False``): launch and
finalize run inline on one thread with identical per-chunk fault hooks,
so both modes run the same kernels, the same number of times, on the same
inputs, and yield the same chunks in the same order, bit for bit.

Why pinned memory. ``torch.from_numpy(a).to("cuda")`` from pageable memory
makes the host wait until the copy is done, and that copy is queued behind
every kernel already on the stream: the host could never pack chunk N+1
while chunk N runs. A copy from pinned memory with ``non_blocking=True``
returns at once; a ring of ``depth + 1`` pinned slots lets the host fill
one while the card still reads another, and a ``torch.cuda.Event`` recorded
after each slot's copy says when the slot may be filled again. A result
pulled with a plain ``.cpu()`` on the worker thread would be queued behind
the chunks launched after it; ``HostPull`` queues it right behind its own
kernels instead.

Failure semantics: when any stage raises (``DataCorruptionError`` from
the sentinel verification at stage 3, an injected ``chunk_launch`` fault),
every in-flight finalize is **drained** — awaited, not abandoned — before
the exception propagates, so a degradation rerun (ops/degrade.py) never
races a background pull, and results already yielded stay valid. The drain
wait is bounded (``DPF_TPU_DRAIN_TIMEOUT``, default 60 s); an expiry emits
a "drain-timeout" IntegrityEvent and a ``pipeline.drain_timeout`` counter.
With a deadline armed (``DPF_TPU_DEADLINE`` or a DegradationPolicy's
``deadline_seconds``, ops/supervisor.py) every launch and finalize wait is
watchdog-bounded and an expiry raises ``UnavailableError``.

Enabled per call by the ``pipeline=`` keyword of the bulk entry points, or
process-wide by ``DPF_TPU_PIPELINE`` (strict boolean). Default: on for a
CUDA device, off for ``device="cpu"`` (whose compute runs on the cores the
stages would overlap on). ``DPF_TPU_PIPELINE_DEPTH`` sizes the launch
window (default 2 chunks ahead). The JAX package's ``DPF_TPU_DONATE``
(input-buffer donation) has no counterpart: PyTorch has no donation, and
the port frees each device buffer as soon as it is consumed.
"""

from __future__ import annotations

import functools
import itertools
import threading
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from concurrent.futures import wait as _futures_wait
from typing import Callable, Iterable, Iterator, Optional, Sequence, TypeVar

import numpy as np
import torch

from ..utils import deadline as _deadline
from ..utils import envflags as _envflags
from ..utils import faultinject
from ..utils import telemetry as _tm
from ..utils.errors import InvalidArgumentError
from .aes_torch import as_words

T = TypeVar("T")
R = TypeVar("R")


def pipeline_default(device: torch.device) -> bool:
    """The executor default: DPF_TPU_PIPELINE when set, else on exactly
    for a CUDA device. On the CPU the plain versions compute on the very
    cores the stages would overlap on; tests opt in explicitly."""
    env = _envflags.env_opt_bool("DPF_TPU_PIPELINE")
    if env is not None:
        return env
    return device.type == "cuda"


def resolve(pipeline: Optional[bool], device: torch.device) -> bool:
    """Explicit keyword wins; None = the env / device default."""
    return pipeline_default(device) if pipeline is None else bool(pipeline)


def depth_default() -> int:
    """Launch-ahead window (chunks in flight beyond the one the consumer
    holds). DPF_TPU_PIPELINE_DEPTH, floor 1, default 2 (one chunk uploading
    or computing, one computed awaiting its pull)."""
    try:
        depth = _envflags.env_int("DPF_TPU_PIPELINE_DEPTH", 2)
    except InvalidArgumentError:
        depth = 2
    return max(1, depth)


def chunk_indices(num_items: int, chunk: int) -> Iterator[tuple]:
    """Yields (idx int64[chunk or fewer], num_valid) index blocks: the last
    block pads with row 0 so every chunk keeps one shape — except when the
    whole batch is smaller than `chunk`. Padded rows are trimmed by the
    caller via num_valid."""
    for start in range(0, num_items, chunk):
        idx = np.arange(start, min(start + chunk, num_items))
        valid = idx.shape[0]
        pad = chunk - valid if num_items > chunk else 0
        if pad:
            idx = np.concatenate([idx, np.zeros(pad, dtype=np.int64)])
        if _tm.enabled():
            _tm.observe("chunk.items", valid)
        yield idx, valid


# ---------------------------------------------------------------------------
# Host <-> card transfers that do not make the host wait
# ---------------------------------------------------------------------------


class PinnedRing:
    """``slots`` sets of pinned host buffers for the uploads of one call's
    chunks (``depth + 1``: one for each chunk the launch window holds, and
    one being filled).

    ``upload`` takes a chunk's host arrays, copies them into the next
    slot's pinned buffers and starts their copies to the card with
    ``non_blocking=True``; a CUDA event recorded after the copies marks
    when the slot's buffers may be refilled, and a refill waits on it. On
    the CPU the arrays become tensors sharing their memory, as before."""

    def __init__(self, device: torch.device, slots: int):
        self.device = device
        self._slots = [dict() for _ in range(max(1, slots))]
        self._events: list = [None] * len(self._slots)
        self._next = 0
        self._lock = threading.Lock()

    def upload(self, arrays: Sequence[np.ndarray]) -> list:
        """uint32 host arrays -> int32 tensors of the same bits on the
        device, in order. Their bytes tick the ``bytes.h2d`` counter (on
        the CPU, bytes handed over without a copy)."""
        if _tm.enabled():
            _tm.counter("bytes.h2d", sum(a.nbytes for a in arrays))
        if self.device.type != "cuda":
            return [torch.from_numpy(as_words(a)).to(self.device) for a in arrays]
        # Launch thunks may run on a deadline watchdog's thread.
        with self._lock:
            s = self._next
            self._next = (s + 1) % len(self._slots)
            if self._events[s] is not None:
                self._events[s].synchronize()  # the slot's last copy has read it
            bufs = self._slots[s]
            out = []
            for j, a in enumerate(arrays):
                w = as_words(a)
                buf = bufs.get(j)
                if buf is None or buf.numel() < w.size:
                    buf = bufs[j] = torch.empty(max(1, w.size), dtype=torch.int32,
                                                pin_memory=True)
                host = buf[: w.size].view(w.shape)
                host.numpy()[...] = w
                out.append(host.to(self.device, non_blocking=True))
            event = torch.cuda.Event()
            event.record()
            self._events[s] = event
        return out


class HostPull:
    """A device result's copy into pinned host memory, queued on the
    current stream right behind the kernels that produced it (so it does
    not wait for chunks launched later), with an event to wait on.
    ``result()`` waits for the copy and returns the host tensors (int32
    words) in the structure given: one tensor or a tuple of them. On the
    CPU the tensors are kept as they are."""

    __slots__ = ("_host", "_event")

    def __init__(self, out):
        self._event = None
        tensors = out if isinstance(out, tuple) else (out,)
        if tensors[0].device.type != "cuda":
            self._host = out
            return
        host = tuple(
            torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t, non_blocking=True)
            for t in tensors
        )
        self._event = torch.cuda.Event()
        self._event.record()
        self._host = host if isinstance(out, tuple) else host[0]

    def result(self):
        if self._event is not None:
            self._event.synchronize()
        return self._host


# ---------------------------------------------------------------------------
# The executor
# ---------------------------------------------------------------------------


def prefetch_thunks(
    thunks: Iterable[Callable[[], T]],
    pipeline: bool,
    depth: Optional[int] = None,
    backend: Optional[str] = None,
    op: Optional[str] = None,
) -> Iterator[T]:
    """Stage-1/2 driver. Each thunk performs ONE chunk's host pack, upload
    and kernel launches and returns the chunk's result (on the device, or a
    ``HostPull``). Pipelined, up to `depth` chunks launch ahead of the one
    the consumer holds, so chunk N+1's pack and upload overlap chunk N on
    the card and the consumer's pull of chunk N-1; serial mode launches and
    yields strictly one at a time. Results always yield in input order.

    Per chunk, before its launch, the fault-injection hooks fire:
    ``maybe_raise("chunk_launch")`` and ``chunk_delay("launch")`` (the
    artificial dispatch latency behind the CPU overlap proxy); both are
    armed-plan no-ops in production.

    `op` labels this entry point's telemetry: with the bus enabled, every
    chunk launch emits a ``pipeline.launch`` span, a
    ``pipeline.chunks_launched`` counter tick and a ``pipeline.queue_depth``
    gauge (chunks in flight). Disabled, the per-chunk cost is one boolean
    check.
    """
    if depth is None:
        depth = depth_default()
    window: deque = deque()
    idx = 0
    for thunk in thunks:
        faultinject.maybe_raise("chunk_launch", backend=backend)

        def _launch(thunk=thunk):
            # Inside the supervisor's deadline watchdog (when armed): the
            # injected hang and the real launch wait are both bounded.
            faultinject.chunk_delay("launch", backend=backend)
            faultinject.device_hang("launch", backend=backend)
            _deadline.check_abandoned()
            return thunk()

        if _tm.enabled():
            with _tm.span("pipeline.launch", op=op, chunk=idx):
                result = _deadline.deadline_call(_launch, "pipeline.launch", op=op, backend=backend)
            _tm.counter("pipeline.chunks_launched", op=op)
            _tm.gauge("pipeline.queue_depth", len(window) + 1, op=op)
        else:
            result = _deadline.deadline_call(_launch, "pipeline.launch", op=op, backend=backend)
        window.append(result)
        idx += 1
        if not pipeline or len(window) > depth:
            yield window.popleft()
    while window:
        yield window.popleft()


def _worker_init(device: Optional[torch.device]) -> None:
    """A new thread has its own current device: make it the chunks' one,
    so that whatever finalize does on the card lands there."""
    if device is not None and device.type == "cuda":
        torch.cuda.set_device(device)


def consume(
    results: Iterable[T],
    finalize: Callable[[T], R],
    pipeline: bool,
    depth: Optional[int] = None,
    backend: Optional[str] = None,
    op: Optional[str] = None,
    device: Optional[torch.device] = None,
) -> Iterator[R]:
    """Stage-3 driver. Pulls each upstream chunk through `finalize` (the
    wait for its copy to the host, the sentinel verification and the
    host-side fold) — on a single worker thread when pipelined, so the
    waits overlap the main thread's pack and launch of later chunks;
    inline when serial. One worker by construction: chunk results yield
    strictly in order either way. `device` is the chunks' device, made the
    worker's current one.

    On any failure (a finalize raising, or the upstream iterable raising),
    every in-flight finalize is drained before the exception propagates:
    the caller can rerun on a fallback rung (ops/degrade.py) without racing
    a background pull, and chunks already yielded remain valid.

    Telemetry: each finalize emits a ``pipeline.finalize`` span whose
    parent is the span active when `consume` was CALLED (captured on the
    main thread), so the span tree is the same whether finalize runs inline
    or on the worker; its duration is the measured dispatch latency (the
    wait and the pull), and the pulled host bytes tick ``bytes.d2h``."""
    if depth is None:
        depth = depth_default()
    parent = _tm.current_span_id() if _tm.enabled() else None
    seq = itertools.count()

    def _finalize(item: T) -> R:
        if not _tm.enabled():
            faultinject.chunk_delay("finalize", backend=backend)
            faultinject.device_hang("finalize", backend=backend)
            _deadline.check_abandoned()
            return finalize(item)
        with _tm.span("pipeline.finalize", parent=parent, op=op, chunk=next(seq)):
            faultinject.chunk_delay("finalize", backend=backend)
            faultinject.device_hang("finalize", backend=backend)
            _deadline.check_abandoned()
            out = finalize(item)
        _tm.counter("pipeline.chunks_finalized", op=op)
        _tm.counter("bytes.d2h", _tm.nbytes_of(out), op=op)
        return out

    if not pipeline:
        for item in results:
            # Serial finalize runs inline: the deadline watchdog (when
            # armed) hosts the blocking pull on its own thread so a hang
            # converts to UnavailableError instead of wedging the caller.
            yield _deadline.deadline_call(
                functools.partial(_finalize, item), "pipeline.finalize",
                op=op, backend=backend,
            )
        return

    pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="dpf-pipeline",
                              initializer=_worker_init, initargs=(device,))
    pending: deque = deque()
    try:
        try:
            for item in results:
                pending.append(pool.submit(_finalize, item))
                while len(pending) > depth:
                    yield _deadline.deadline_result(pending.popleft(), "pipeline.finalize",
                                                    op=op, backend=backend)
            while pending:
                yield _deadline.deadline_result(pending.popleft(), "pipeline.finalize",
                                                op=op, backend=backend)
        except BaseException:
            drain(pending, backend=backend, op=op)
            raise
    finally:
        # Normal exhaustion leaves nothing pending; after drain() the
        # worker is idle — never block teardown on a wait here.
        pool.shutdown(wait=False)


def drain_timeout_default() -> float:
    """Bound on the drain-on-error wait (seconds): DPF_TPU_DRAIN_TIMEOUT,
    default 60."""
    try:
        return _envflags.env_float("DPF_TPU_DRAIN_TIMEOUT", 60.0)
    except InvalidArgumentError:
        return 60.0


def drain(pending, backend: Optional[str] = None, op: Optional[str] = None) -> None:
    """Cancels what has not started and awaits what has: after drain, no
    background thread touches the chunks' buffers. Bounded wait — a wedged
    pull must not hang the error path forever (the exception being
    propagated is the primary signal). A timeout emits a "drain-timeout"
    IntegrityEvent and a ``pipeline.drain_timeout`` counter: a background
    thread MAY still touch the buffers behind the degradation rerun."""
    for f in pending:
        f.cancel()
    if not pending:
        return
    timeout = drain_timeout_default()
    _done, not_done = _futures_wait(list(pending), timeout=timeout)
    if not_done:
        from ..utils import integrity as _integrity

        _integrity.emit_event(
            "drain-timeout",
            f"pipeline drain: {len(not_done)} in-flight finalize(s) still "
            f"running after {timeout:g}s — a wedged pull may still touch "
            "the chunks' buffers behind the degradation rerun "
            "(DataLossError-kind; raise DPF_TPU_DRAIN_TIMEOUT or arm "
            "DPF_TPU_DEADLINE to convert hangs earlier)",
            backend or "",
            op=op,
            error="DataLossError",
            pending=len(not_done),
            timeout_seconds=timeout,
        )
        _tm.counter("pipeline.drain_timeout", op=op)


def map_chunks(
    thunks: Iterable[Callable[[], T]],
    finalize: Callable[[T], R],
    pipeline: bool,
    depth: Optional[int] = None,
    backend: Optional[str] = None,
    op: Optional[str] = None,
    device: Optional[torch.device] = None,
) -> Iterator[R]:
    """prefetch_thunks + consume composed: the full three-stage executor
    for entry points that own both the launch and the pull. `op` labels
    both stages' telemetry."""
    return consume(
        prefetch_thunks(thunks, pipeline, depth, backend, op=op),
        finalize, pipeline, depth, backend, op=op, device=device,
    )
