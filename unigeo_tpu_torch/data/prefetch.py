"""Clip prefetch on host threads, port of ``unigeo_tpu/data/prefetch.py``.

A thread pool decodes and resizes the next clips while the consumer works
on the current one, and yields them in index order:

    for data in PrefetchLoader(dataset, num_workers=8, prefetch=4): ...

Threads, not processes: the native reader, PIL and numpy release the GIL
while they decode, and nothing is pickled.  A worker's exception is raised
in the caller when its clip's turn comes.
"""

from __future__ import annotations

import queue
from concurrent.futures import ThreadPoolExecutor
from typing import Iterator


class PrefetchLoader:
    def __init__(
        self,
        dataset,
        num_workers: int = 4,
        prefetch: int = 4,
        device_put: bool = False,
        indices=None,
        device="cuda",
    ):
        """device_put: copy each clip's ``images`` and ``intrinsics`` to
        ``device`` as torch tensors, in the worker (the counterpart of the JAX
        package's ``jax.device_put``)."""
        self.dataset = dataset
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.device_put = device_put
        self.device = device
        self.indices = list(indices) if indices is not None else list(range(len(dataset)))

    def __len__(self) -> int:
        return len(self.indices)

    def _load(self, idx: int):
        data = self.dataset[idx]
        if self.device_put:
            import torch

            for key in ("images", "intrinsics"):
                if key in data:
                    data[key] = torch.as_tensor(data[key]).to(self.device)
        return data

    def __iter__(self) -> Iterator:
        executor = ThreadPoolExecutor(max_workers=self.num_workers)
        try:
            pending = queue.Queue()
            it = iter(self.indices)
            for _ in range(self.prefetch):  # prime the pipeline
                try:
                    pending.put(executor.submit(self._load, next(it)))
                except StopIteration:
                    break
            while not pending.empty():
                fut = pending.get()
                try:
                    pending.put(executor.submit(self._load, next(it)))
                except StopIteration:
                    pass
                yield fut.result()
        finally:
            executor.shutdown(wait=False, cancel_futures=True)
