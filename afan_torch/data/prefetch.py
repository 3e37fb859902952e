"""Background-thread batch prefetcher — the port's copy of
``afan/data/prefetch.py``.

The reference leans on torch DataLoader worker processes (num_workers=8,
`Detection/train_aug_final.py:28-30`); on a host with few cores the win
here is overlap, not parallelism: while the card runs step N, the thread
prepares batch N+1 (reading and decoding the files, the augmentation,
the copies; the decoder releases the GIL). Wrap any of this package's
loaders:

    for batch in Prefetcher(loader, depth=2): ...

Each pass records, per batch, the seconds the consumer waited for it
(``wait_seconds``): the time the data kept the card idle. A consumer that
stops early stops the thread too.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Iterable, Iterator, List


class Prefetcher:
    _SENTINEL = object()

    def __init__(self, iterable: Iterable, depth: int = 2):
        self._iterable = iterable
        self._depth = depth
        self.wait_seconds: List[float] = []

    def __len__(self):
        return len(self._iterable)

    def __iter__(self) -> Iterator:
        q: queue.Queue = queue.Queue(maxsize=self._depth)
        stop = threading.Event()
        err = []

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def worker():
            try:
                it = iter(self._iterable)
                while not stop.is_set():
                    try:
                        item = next(it)
                    except StopIteration:
                        break
                    if not put(item):
                        break
            except BaseException as e:  # surface loader errors in consumer
                err.append(e)
            finally:
                put(self._SENTINEL)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                t0 = time.perf_counter()
                item = q.get()
                if item is self._SENTINEL:
                    break
                self.wait_seconds.append(time.perf_counter() - t0)
                yield item
        finally:
            stop.set()
            t.join()
        if err:
            raise err[0]
