"""Job store + device-owning job runner (the port of
``s2sr_tpu/server/jobs.py``).

- :class:`JobStore`: the status dicts clients poll, lock-guarded;
- :class:`JobRunner`: FIFO worker threads that own the device (one by
  default: ``MAX_CONCURRENT_ENHANCE=1`` + a pending queue). The first
  engine is built on a worker, so CUDA is initialised there and never on
  the event loop. ``active_count``/``queued_count`` expose capacity so
  the enhance endpoint can report "queued due to concurrency limits".

Unlike the JAX copy, :meth:`JobRunner.join` waits on the runner's
condition instead of polling.
"""

from __future__ import annotations

import threading
import traceback
from datetime import datetime
from collections import deque
from typing import Any, Callable, Dict, Optional

from ..utils import setup_logging

logger = setup_logging("s2sr_tpu_torch.jobs")


class JobStore:
    def __init__(self) -> None:
        self._jobs: Dict[str, dict] = {}
        self._lock = threading.Lock()

    def create(self, job_id: str, **fields: Any) -> dict:
        with self._lock:
            self._jobs[job_id] = {
                "created_at": datetime.now().isoformat(),
                **fields,
            }
            return dict(self._jobs[job_id])

    def update(self, job_id: str, **fields: Any) -> bool:
        """Apply to a KNOWN job; returns whether it applied (unknown ids
        no-op — the durable subclass keys its journaling off this, so a
        runner-internal pseudo-id can never be resurrected as a phantom
        job after restart)."""
        with self._lock:
            if job_id in self._jobs:
                self._jobs[job_id].update(fields)
                return True
            return False

    def update_if(self, job_id: str, expected_status: str,
                  **fields: Any) -> bool:
        """Compare-and-set: apply only while the job is still in
        ``expected_status`` (so a handler's post-submit status bump can
        never stomp the worker's progress updates)."""
        with self._lock:
            job = self._jobs.get(job_id)
            if job is None or job.get("status") != expected_status:
                return False
            job.update(fields)
            return True

    def get(self, job_id: str) -> Optional[dict]:
        with self._lock:
            job = self._jobs.get(job_id)
            return dict(job) if job is not None else None

    def all(self) -> Dict[str, dict]:
        with self._lock:
            return {k: dict(v) for k, v in self._jobs.items()}

    def count_by_status(self) -> Dict[str, int]:
        """{status: count} in one lock-held pass (no per-job copies) —
        shared by /api/runtime and /metrics."""
        with self._lock:
            out: Dict[str, int] = {}
            for job in self._jobs.values():
                s = str(job.get("status", "unknown"))
                out[s] = out.get(s, 0) + 1
            return out

    def with_prefix(self, prefix: str) -> Dict[str, dict]:
        with self._lock:
            return {k: dict(v) for k, v in self._jobs.items()
                    if k.startswith(prefix)}

    def __contains__(self, job_id: str) -> bool:
        with self._lock:
            return job_id in self._jobs


class _Item:
    __slots__ = ("job_id", "fn", "key", "payload", "many_fn", "drop_fn")

    def __init__(self, job_id, fn, key=None, payload=None, many_fn=None,
                 drop_fn=None):
        self.job_id = job_id
        self.fn = fn
        self.key = key
        self.payload = payload
        self.many_fn = many_fn
        # called instead of the store update when the item is drained
        # un-run at shutdown (run_sync uses it to unblock its waiter)
        self.drop_fn = drop_fn


class JobRunner:
    """Single-worker FIFO executor owning the device.

    Queued jobs submitted with the same ``coalesce_key`` that sit
    *consecutively* at the head of the queue are drained together and run
    as ONE device batch via their ``many_fn`` (N same-model uploads cost
    one batched pass instead of N sequential ones).
    """

    MAX_COALESCE = 4

    def __init__(self, store: JobStore, max_concurrent: int = 1) -> None:
        self.store = store
        self.max_concurrent = max(1, max_concurrent)
        self._deque: "deque[_Item]" = deque()
        self._unfinished = 0
        self._active: set[str] = set()
        self._stopping = False
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._workers = [
            threading.Thread(target=self._worker, daemon=True,
                             name=f"s2sr-job-worker-{i}")
            for i in range(self.max_concurrent)
        ]
        for w in self._workers:
            w.start()

    def _take_batch(self) -> list:
        """Pop the head item plus consecutive same-key coalescable items."""
        items = [self._deque.popleft()]
        head = items[0]
        if head.key is not None and head.many_fn is not None:
            while (len(items) < self.MAX_COALESCE and self._deque
                   and self._deque[0].key == head.key):
                items.append(self._deque.popleft())
        return items

    def _worker(self) -> None:
        while True:
            with self._cond:
                while not self._deque and not self._stopping:
                    self._cond.wait()
                if self._stopping and not self._deque:
                    return
                items = self._take_batch()
                for it in items:
                    self._active.add(it.job_id)
            try:
                if len(items) > 1:
                    logger.info("coalescing %d jobs: %s", len(items),
                                [it.job_id for it in items])
                    items[0].many_fn([(it.job_id, it.payload)
                                      for it in items])
                else:
                    items[0].fn()
            except Exception as exc:  # job fns set their own status
                logger.error("job(s) %s crashed: %s\n%s",
                             [it.job_id for it in items], exc,
                             traceback.format_exc())
                for it in items:
                    self.store.update(it.job_id, status="failed",
                                      message=str(exc))
            finally:
                with self._cond:
                    for it in items:
                        self._active.discard(it.job_id)
                    self._unfinished -= len(items)
                    self._cond.notify_all()

    @property
    def active_count(self) -> int:
        with self._lock:
            return len(self._active)

    @property
    def queued_count(self) -> int:
        with self._lock:
            return len(self._deque)

    def has_capacity(self) -> bool:
        with self._lock:
            return len(self._active) + len(self._deque) < self.max_concurrent

    def submit(self, job_id: str, fn: Callable[[], None],
               coalesce_key: Optional[tuple] = None,
               payload: Any = None,
               many_fn: Optional[Callable[[list], None]] = None,
               drop_fn: Optional[Callable[[], None]] = None) -> bool:
        """Enqueue; returns True when a worker can start the job
        immediately (capacity observed atomically with the enqueue — the
        handler uses this for its processing/queued response instead of
        a racy pre-submit ``has_capacity`` check)."""
        with self._cond:
            if self._stopping:
                raise RuntimeError("job runner is shutting down")
            starts_now = (len(self._active) + len(self._deque)
                          < self.max_concurrent)
            self._deque.append(_Item(job_id, fn, coalesce_key, payload,
                                     many_fn, drop_fn))
            self._unfinished += 1
            self._cond.notify()
            return starts_now

    def run_sync(self, fn: Callable[[], Any], timeout: float = 300.0,
                 label: str = "inline") -> Any:
        """Run ``fn`` on the device-owning worker and wait for the
        result — for request-path device work (the decode SR retry) that
        must not race a running job on the device. Raises TimeoutError
        if the runner stays busy past ``timeout`` (callers degrade
        gracefully); the work still runs when its turn comes, its result
        is simply discarded."""
        done = threading.Event()
        box: Dict[str, Any] = {}

        def wrapper() -> None:
            try:
                box["result"] = fn()
            except BaseException as exc:  # noqa: BLE001 — re-raised below
                box["error"] = exc
            finally:
                done.set()

        def dropped() -> None:
            # shutdown drained us before a worker picked the item up:
            # unblock the waiter immediately instead of letting it sit
            # in done.wait() for the full timeout (which would stall
            # process exit by up to that long)
            box["error"] = RuntimeError(
                f"server shut down before inline {label} work ran")
            done.set()

        self.submit(f"_sync_{label}_{id(done)}", wrapper, drop_fn=dropped)
        if not done.wait(timeout):
            raise TimeoutError(
                f"device runner busy: {label} timed out after {timeout}s")
        if "error" in box:
            raise box["error"]
        return box["result"]

    def stop(self, message: str = "Server shut down before job ran",
             timeout: float = 5.0) -> None:
        """Graceful shutdown: refuse new submissions, mark still-queued
        jobs failed (durable — clients polling after restart see it),
        and give running jobs ``timeout`` seconds to finish. A job that
        outlives the timeout is left to the durable journal's
        failed-on-restart replay (:mod:`.persistence`), matching a hard
        crash."""
        with self._cond:
            if self._stopping:
                return
            self._stopping = True
            drained = list(self._deque)
            self._deque.clear()
            self._unfinished -= len(drained)
            self._cond.notify_all()
        for it in drained:
            if it.drop_fn is not None:
                try:
                    it.drop_fn()
                except Exception:  # noqa: BLE001 — shutdown best-effort
                    pass
            else:
                self.store.update(it.job_id, status="failed",
                                  message=message)
        for w in self._workers:
            w.join(timeout=timeout)

    def join(self, timeout: Optional[float] = None) -> None:
        """Wait until every submitted job has finished (or been drained
        by :meth:`stop`); TimeoutError after ``timeout`` seconds."""
        with self._cond:
            if not self._cond.wait_for(lambda: self._unfinished == 0,
                                       timeout):
                raise TimeoutError("jobs did not finish in time")
