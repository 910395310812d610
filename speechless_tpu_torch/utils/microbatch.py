"""Generic micro-batching service loop: the port's own copy of
`speechless_tpu/utils/microbatch.py`, kept so that a change to the JAX package never
reaches the port.

One batcher thread owns all downstream dispatch: callers enqueue items and block on a
per-item event; the thread collects items that arrive within ``max_wait_ms`` (up to
``max_batch``) and serves each batch with ONE call to the subclass's ``_serve`` (the
port's `serving_http.DynamicBatcher`). The shutdown/error/deadline semantics:

* ``_serve`` failures fan out to every waiter in the batch (a launch error or OOM must
  never leave a submitter blocked);
* ``stop()`` drains the queue and fails abandoned items with `BatcherStopped` — callers
  blocked in ``submit`` wake with an error instead of waiting forever, and submits after
  stop fail fast;
* a lone item still forms a batch of one, so an idle service adds no latency beyond
  ``max_wait_ms`` of its own arrival.
"""
import queue
import threading
import time
from typing import Any, List, Optional

_LATENCY_WINDOW = 512  # rolling window for the p50/p95 metrics


class BatcherStopped(RuntimeError):
    """The batcher was stopped before (or while) this item could be served."""


class BatcherSaturated(RuntimeError):
    """The bounded queue is full: the service is saturated and sheds this item
    instead of queueing it into an unbounded latency tail. ``retry_after_s`` is a
    drain-time estimate (queue depth x recent per-item service time)."""

    def __init__(self, message: str, retry_after_s: float):
        super().__init__(message)
        self.retry_after_s = retry_after_s


class PendingItem:
    __slots__ = ("payload", "done", "result", "error", "enqueued_at",
                 "dispatched_at", "served_at")

    def __init__(self, payload: Any):
        self.payload = payload
        self.done = threading.Event()
        self.result: Any = None
        self.error: Optional[BaseException] = None
        self.enqueued_at = time.time()
        self.dispatched_at: Optional[float] = None  # batch left the queue
        self.served_at: Optional[float] = None      # _serve returned

    def timing(self) -> dict:
        """Per-request latency decomposition (seconds): time spent waiting in the
        queue (including the batching window) vs being served on the device."""
        served = self.served_at or time.time()
        dispatched = self.dispatched_at or served
        return {"queue_wait_s": dispatched - self.enqueued_at,
                "service_s": served - dispatched,
                "total_s": served - self.enqueued_at}

    @property
    def ready(self) -> bool:
        """Whether `wait` would return (or raise) immediately — the non-blocking
        poll pipelined callers use to decide between collecting now and
        accumulating more work for the next submission."""
        return self.done.is_set()

    def wait(self) -> Any:
        """Block until served; raises the serving error, returns the result.
        (`MicroBatcher.submit` == `submit_nowait(payload).wait()` — the split lets
        callers overlap their own work with the batch, e.g. pipelined beam
        partials.)"""
        self.done.wait()
        if self.error is not None:
            raise self.error
        return self.result


class MicroBatcher:
    """Base class: subclasses implement ``_serve(batch)``, setting ``item.result`` for
    every `PendingItem` in the batch (exceptions fan out to all unresolved waiters)."""

    item_noun = "items"  # metrics key for the item counter ("requests", "windows", ...)

    def __init__(self, max_batch: int = 16, max_wait_ms: float = 10.0,
                 name: str = "micro-batcher", max_queue: Optional[int] = None):
        """``max_queue``: bound the backlog — a `submit` that finds the queue full
        raises `BatcherSaturated` immediately (explicit backpressure; the HTTP layer
        maps it to 503 + Retry-After) instead of joining an unbounded latency tail.
        ``None`` (default) keeps the queue unbounded."""
        self.max_batch = max_batch
        self.max_wait_ms = max_wait_ms
        self.max_queue = max_queue
        self._queue: "queue.Queue[Optional[PendingItem]]" = queue.Queue(
            maxsize=max_queue or 0)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True, name=name)
        self._lock = threading.Lock()
        self.items = 0
        self.batches = 0
        self.errors = 0
        self.shed = 0  # items refused with BatcherSaturated
        self._latencies: List[float] = []
        self._queue_waits: List[float] = []
        self._service_times: List[float] = []

    def start(self) -> None:
        self._thread.start()

    @property
    def started(self) -> bool:
        return self._thread.ident is not None

    def stop(self) -> None:
        self._stop.set()
        try:
            self._queue.put_nowait(None)  # wake the loop
        except queue.Full:
            pass  # bounded queue at capacity: the loop wakes on its 0.25 s poll
        if self._thread.ident is not None:  # join() on a never-started thread raises
            self._thread.join(timeout=30)
        self._fail_pending()  # anything the loop never took must not block its waiter

    def submit(self, payload: Any) -> Any:
        """Enqueue one item and block until its batch is served."""
        return self.submit_item(payload).result

    def submit_item(self, payload: Any) -> PendingItem:
        """Like `submit` but returns the served `PendingItem` (callers can read the
        per-request `timing()` decomposition). Raises the item's error if serving
        failed, `BatcherSaturated` if the bounded queue is full."""
        item = self._enqueue(payload)
        item.wait()
        return item

    def submit_nowait(self, payload: Any) -> PendingItem:
        """Enqueue one item and return WITHOUT waiting — call `.wait()` on the
        returned `PendingItem` for the result. Raises `BatcherSaturated` if the
        bounded queue is full. Lets callers overlap work with the batch (pipelined
        beam partials submit an advance here and collect it on the NEXT feed).
        Subclasses may re-signature this (payload packing); the blocking paths go
        through `_enqueue` directly."""
        return self._enqueue(payload)

    def _enqueue(self, payload: Any) -> PendingItem:
        if self._stop.is_set():
            raise BatcherStopped("batcher is stopped")
        item = PendingItem(payload)
        try:
            self._queue.put_nowait(item)
        except queue.Full:
            with self._lock:
                self.shed += 1
                service = (self._service_times[-32:]
                           if self._service_times else [self.max_wait_ms / 1000.0])
            # Drain estimate: backlog batches x recent per-batch service time.
            per_batch = sum(service) / len(service)
            retry = max(0.1, (self.max_queue or 0) / self.max_batch * per_batch)
            raise BatcherSaturated(
                "queue full ({} {} pending); retry in ~{:.1f}s".format(
                    self.max_queue, self.item_noun, retry), retry)
        if self._stop.is_set():
            # stop() may have drained the queue before this put landed; drain again so
            # this item cannot wait on a loop that already exited.
            self._fail_pending()
        return item

    def metrics(self) -> dict:
        def percentiles(values, prefix, out):
            values = sorted(values)
            if values:
                out[prefix + "_p50_s"] = values[len(values) // 2]
                out[prefix + "_p95_s"] = values[min(len(values) - 1,
                                                    int(len(values) * 0.95))]

        with self._lock:
            out = {
                self.item_noun: self.items,
                "batches": self.batches,
                "errors": self.errors,
                "shed": self.shed,
                "mean_batch_size": self.items / self.batches if self.batches else 0.0,
                "queue_depth": self._queue.qsize(),
                "max_queue": self.max_queue,
            }
            percentiles(self._latencies, "latency", out)
            # Timeline decomposition: latency = queue wait (backlog + batching
            # window) + device service time. Under saturation the queue term is
            # what explodes; the bounded queue caps it.
            percentiles(self._queue_waits, "queue_wait", out)
            percentiles(self._service_times, "service", out)
            return out

    def _serve(self, batch: List[PendingItem]) -> None:
        raise NotImplementedError

    def _fail_pending(self) -> None:
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                return
            if item is None:
                continue
            item.error = BatcherStopped("batcher stopped before serving this item")
            item.done.set()

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                first = self._queue.get(timeout=0.25)
            except queue.Empty:
                continue
            if first is None:
                continue
            batch = [first]
            deadline = time.time() + self.max_wait_ms / 1000.0
            while len(batch) < self.max_batch:
                remaining = deadline - time.time()
                if remaining <= 0:
                    break
                try:
                    item = self._queue.get(timeout=remaining)
                except queue.Empty:
                    break
                if item is None:
                    break
                batch.append(item)
            dispatched = time.time()
            for item in batch:
                item.dispatched_at = dispatched
            try:
                self._serve(batch)
            except BaseException as error:  # surface compile/OOM to every waiter
                for item in batch:
                    if item.error is None:
                        item.error = error
            finally:
                now = time.time()
                failed = sum(1 for item in batch if item.error is not None)
                with self._lock:
                    self.items += len(batch)
                    self.batches += 1
                    self.errors += failed
                    self._latencies.extend(now - item.enqueued_at for item in batch)
                    self._queue_waits.extend(dispatched - item.enqueued_at
                                             for item in batch)
                    self._service_times.append(now - dispatched)
                    del self._latencies[:-_LATENCY_WINDOW]
                    del self._queue_waits[:-_LATENCY_WINDOW]
                    del self._service_times[:-_LATENCY_WINDOW]
                for item in batch:
                    item.served_at = now
                    item.done.set()
        self._fail_pending()
