"""Host-side input prefetching: a copy of ``tfrec_tpu.utils.prefetch``; a
test holds the two equal.

A background thread converts upcoming host batches to device tensors while
the current step runs, so the host-to-device copy of batch i+1 overlaps
step i (the trainer's transform is that copy). Queue depth 2 = double
buffering.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Iterator, TypeVar

T = TypeVar("T")
U = TypeVar("U")

_SENTINEL = object()


def prefetch(
    iterable: Iterable[T],
    transform: Callable[[T], U],
    depth: int = 2,
) -> Iterator[U]:
    """Yield transform(x) for x in iterable, computing ``depth`` items ahead
    on a worker thread. Worker exceptions re-raise at the consumption point."""
    q: "queue.Queue" = queue.Queue(maxsize=max(depth, 1))
    err: list[BaseException] = []
    stop = threading.Event()

    def _put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in iterable:
                if not _put(transform(item)):
                    return
        except BaseException as e:  # noqa: BLE001 — re-raised on the main thread
            err.append(e)
        finally:
            _put(_SENTINEL)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _SENTINEL:
                break
            yield item
        t.join()
        if err:
            raise err[0]
    finally:
        # Consumer stopped early (steps cap / exception): release the worker.
        stop.set()
