"""Background-thread batch prefetcher — a copy of ``afan/data/prefetch.py``.

The reference leans on torch DataLoader worker processes (num_workers=8,
`Detection/train_aug_final.py:28-30`); on a host with few cores the win
here is overlap, not parallelism: while the card runs step N, the thread
prepares batch N+1 (indexing, copies, any host-side augmentation). Wrap
any of this package's loaders:

    for batch in Prefetcher(loader, depth=2): ...
"""
from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator


class Prefetcher:
    _SENTINEL = object()

    def __init__(self, iterable: Iterable, depth: int = 2):
        self._iterable = iterable
        self._depth = depth

    def __len__(self):
        return len(self._iterable)

    def __iter__(self) -> Iterator:
        q: queue.Queue = queue.Queue(maxsize=self._depth)
        err = []

        def worker():
            try:
                for item in self._iterable:
                    q.put(item)
            except BaseException as e:  # surface loader errors in consumer
                err.append(e)
            finally:
                q.put(self._SENTINEL)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is self._SENTINEL:
                break
            yield item
        t.join()
        if err:
            raise err[0]
