"""Device-resident dataset cache for small image corpora (counterpart of
``naf_tpu/data/device_cache.py``).

For a corpus whose transformed images fit in device memory (the denoising
runs' fixed-size crops), decode and transform every image once, upload the
stack once, and gather each step's batch by index on the device: per step the
host sends an index vector and no pixels. The epoch order is the JAX
package's, from ``np.random.RandomState(seed)``, so both packages yield the
same indices.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from naf_torch.utils.spans import to_device

__all__ = ["device_cached_stack", "device_cached_batches", "index_batches"]


def device_cached_stack(dataset, device="cuda") -> torch.Tensor:
    """The whole transformed dataset as one (N, H, W, C) float32 tensor on
    ``device``, uploaded once."""
    imgs = np.stack([np.asarray(dataset[i]["image"], np.float32) for i in range(len(dataset))])
    return to_device(imgs, device)


def index_batches(n: int, batch_size: int, shuffle: bool = True, seed: int = 0,
                  drop_last: bool = True, rng=None) -> Iterator[np.ndarray]:
    """Endless batches of indices into n items: epoch permutations (in order
    without ``shuffle``), or draws with replacement where ``batch_size``
    exceeds n. ``rng`` (a ``np.random.RandomState``) is shared with the
    caller's other draws; by default one is seeded with ``seed``."""
    rng = np.random.RandomState(seed) if rng is None else rng
    order = np.arange(n)
    while True:
        if batch_size > n:
            yield rng.randint(0, n, size=batch_size)
            continue
        if shuffle:
            rng.shuffle(order)
        end = n - batch_size + 1 if drop_last else n
        for i in range(0, end, batch_size):
            yield order[i : i + batch_size]


def device_cached_batches(dataset, batch_size: int, shuffle: bool = True, seed: int = 0,
                          drop_last: bool = True, device="cuda") -> Iterator[torch.Tensor]:
    """Endless iterator of (B, H, W, C) float32 batches on ``device``, each
    an ``index_select`` of the stack uploaded once (``dataset[i]["image"]``
    must have one shape for every i)."""
    stack = device_cached_stack(dataset, device)
    for idx in index_batches(len(dataset), batch_size, shuffle, seed, drop_last):
        yield stack.index_select(0, to_device(idx, stack.device))
