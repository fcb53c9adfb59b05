"""Threaded prefetching data loader (the port's own copy of
``naf_tpu/data/loader.py``; reference config/dataloader/train.yaml
num_workers: 8).

PIL decode + numpy transforms run in a thread pool (PIL releases the GIL for
decode/resize); batches are assembled and queued ahead of consumption so the
card does not wait on the host. Deterministic per-epoch shuffling mirrors the
reference's seeded generators (utils/training.py:110-115).
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator, Optional

import numpy as np

__all__ = ["DataLoader"]


def _default_collate(items):
    out = {}
    for key in items[0]:
        vals = [it[key] for it in items]
        if isinstance(vals[0], np.ndarray):
            out[key] = np.stack(vals)
        else:
            out[key] = np.asarray(vals)
    return out


class DataLoader:
    def __init__(
        self,
        dataset,
        batch_size: int = 1,
        shuffle: bool = False,
        num_workers: int = 4,
        drop_last: bool = False,
        seed: Optional[int] = 0,
        prefetch: int = 2,
        collate_fn=None,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(num_workers, 1)
        self.drop_last = drop_last
        self.seed = seed
        self.prefetch = prefetch
        self.collate = collate_fn or _default_collate
        self._epoch = 0

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _indices(self):
        n = len(self.dataset)
        if self.shuffle:
            rng = np.random.RandomState(
                None if self.seed is None else self.seed + self._epoch
            )
            return rng.permutation(n)
        return np.arange(n)

    def __iter__(self) -> Iterator[dict]:
        idx = self._indices()
        self._epoch += 1
        n_batches = len(self)
        batches = [
            idx[i * self.batch_size : (i + 1) * self.batch_size]
            for i in range(n_batches)
        ]

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def produce():
            with ThreadPoolExecutor(self.num_workers) as pool:
                for batch_idx in batches:
                    if stop.is_set():
                        return
                    items = list(pool.map(self.dataset.__getitem__, batch_idx))
                    q.put(self.collate(items))
            q.put(None)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                yield item
        finally:
            stop.set()
