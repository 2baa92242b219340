"""Host-side pipeline: prefetch and request intake (port of
``repro/data/pipeline.py``).

:class:`Prefetcher` keeps ``depth`` items in flight on a daemon thread
(``depth=2`` is the double-buffer). :class:`ServeRequest` is one
in-flight inference request with a first-wins future, and
:class:`RequestQueue` is the concurrent intake the serving loop drains
as coalescing windows. Pure Python and numpy: nothing here touches a
device.
"""
from __future__ import annotations

import itertools
import queue
import threading
import time
from typing import Iterable, Iterator, List, Optional, Sequence

import numpy as np

__all__ = ["Prefetcher", "prefetch", "ServeRequest", "RequestQueue"]

_DONE = object()


class Prefetcher:
    """Iterator wrapper that materializes up to ``depth`` items ahead.

    Exceptions raised by the producer are re-raised at the consumer's
    ``next()`` call site; the thread is a daemon, so an abandoned
    prefetcher never blocks interpreter exit.
    """

    def __init__(self, it: Iterable, depth: int = 2):
        if depth < 1:
            raise ValueError("prefetch depth must be ≥ 1")
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._err = None
        self._closed = False
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._fill, args=(iter(it),),
                                        daemon=True)
        self._thread.start()

    def _fill(self, it: Iterator) -> None:
        try:
            for item in it:
                # bounded put that notices close(): never leaves the
                # producer blocked (and then hard-killed mid-call)
                while not self._stop.is_set():
                    try:
                        self._q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if self._stop.is_set():
                    return
        except BaseException as e:          # propagate to the consumer
            self._err = e
        finally:
            # the sentinel must not be dropped on a full queue (the
            # consumer would block forever) — same stop-aware put
            while not self._stop.is_set():
                try:
                    self._q.put(_DONE, timeout=0.1)
                    break
                except queue.Full:
                    continue

    def close(self) -> None:
        """Stop the producer and drain — call when abandoning the
        iterator early (e.g. a capped batch loop). A closed iterator is
        exhausted: further ``next()`` raises StopIteration."""
        self._closed = True
        self._stop.set()
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=10.0)

    def __iter__(self):
        return self

    def __next__(self):
        if self._closed:
            raise StopIteration
        item = self._q.get()
        if item is _DONE:
            # re-queue the sentinel: exhausted iterators must keep
            # raising StopIteration instead of blocking a later next()
            try:
                self._q.put_nowait(_DONE)
            except queue.Full:
                pass
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item


def prefetch(it: Iterable, depth: int = 2) -> Iterator:
    """Double-buffered (by default) background iteration over ``it``."""
    return Prefetcher(it, depth=depth)


class ServeRequest:
    """One in-flight inference request: node ids in, a future out.

    Requesters block in :meth:`result`; the serving loop fulfils via
    :meth:`set_result` / :meth:`set_error`. ``t_submit`` lets the
    latency benchmark split queueing delay from compute.
    """

    __slots__ = ("rid", "ids", "t_submit", "_event", "_result", "_error",
                 "_lock")

    def __init__(self, rid: int, ids: np.ndarray):
        self.rid = rid
        self.ids = ids
        self.t_submit = time.perf_counter()
        self._event = threading.Event()
        self._result = None
        self._error: Optional[BaseException] = None
        self._lock = threading.Lock()

    def set_result(self, value) -> bool:
        """Resolve the future — first caller wins (the serving loop and
        a closing queue may race to settle the same request; the loser
        is a no-op, never an overwrite). Returns whether this call won."""
        with self._lock:
            if self._event.is_set():
                return False
            self._result = value
            self._event.set()
            return True

    def set_error(self, err: BaseException) -> bool:
        with self._lock:
            if self._event.is_set():
                return False
            self._error = err
            self._event.set()
            return True

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None):
        if not self._event.wait(timeout):
            raise TimeoutError(f"request {self.rid} not served within "
                               f"{timeout}s")
        if self._error is not None:
            raise self._error
        return self._result


class RequestQueue:
    """Concurrent request intake, iterable as coalescing windows.

    Requester threads :meth:`submit` node-id lists and block on the
    returned :class:`ServeRequest`. Iteration yields *lists* of
    requests: each ``next()`` blocks for the first request, then keeps
    draining until ``max_nodes`` total node ids are queued or
    ``max_wait`` seconds pass — the batching window. The iterator is
    exactly the shape :class:`Prefetcher` wraps, so window assembly
    overlaps the device step the same way sampling overlaps training
    (``prefetch(request_queue)`` in ``GNNServer.run``).
    """

    def __init__(self, max_nodes: Optional[int] = None,
                 max_wait: float = 0.002):
        self.max_nodes = max_nodes
        self.max_wait = float(max_wait)
        self._q: "queue.Queue" = queue.Queue()
        self._rid = itertools.count()
        self._closed = threading.Event()

    def submit(self, node_ids: Sequence[int]) -> ServeRequest:
        if self._closed.is_set():
            raise RuntimeError("request queue is closed")
        ids = np.asarray(node_ids, np.int64).reshape(-1)
        req = ServeRequest(next(self._rid), ids)
        self._q.put(req)
        return req

    def close(self, cancel_pending: bool = False) -> None:
        """No more submissions; pending requests still drain, then the
        serving loop's iteration ends.

        With ``cancel_pending=True`` queued-but-unserved requests are
        resolved immediately with a "queue closed" error instead of
        drained — their blocked ``result()`` callers wake up right away
        (set_result/set_error are first-wins, so a request the loop
        already served is untouched).
        """
        self._closed.set()
        self._q.put(_DONE)
        if cancel_pending:
            self._drain_error()

    def _drain_error(self) -> None:
        """Error out every queued request and leave one ``_DONE`` behind
        so iteration keeps terminating. Without this, a request that
        raced into the queue behind the shutdown sentinel would never be
        resolved and its ``result()`` caller would hang forever."""
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is _DONE:
                continue
            item.set_error(RuntimeError(
                f"request {item.rid} dropped: queue closed"))
        self._q.put(_DONE)

    def __iter__(self):
        return self

    def __next__(self) -> List[ServeRequest]:
        # block for the window's first request (or shutdown)
        first = self._q.get()
        if first is _DONE:
            # iteration is over: anything still queued (submissions that
            # raced in behind the sentinel) will never be served — fail
            # their futures instead of leaving requesters blocked
            self._drain_error()     # re-queues _DONE for later next()
            raise StopIteration
        window = [first]
        n = len(first.ids)
        deadline = time.perf_counter() + self.max_wait
        while self.max_nodes is None or n < self.max_nodes:
            wait = deadline - time.perf_counter()
            if wait <= 0:
                break
            try:
                req = self._q.get(timeout=wait)
            except queue.Empty:
                break
            if req is _DONE:
                self._q.put(_DONE)  # flush this window, end on the next
                break
            window.append(req)
            n += len(req.ids)
        return window
