"""Input pipeline: shuffled batching with background workers.

Counterpart of ``unimp_tpu/data/loader.py`` (which replaces the
reference's torch DataLoader with 4 worker processes), for one process: a
thread pool decodes and encodes samples ahead of the consumer, with at
most ``num_workers + prefetch`` batches in flight, and batches are
collated to bucketed shapes. ``num_workers=0`` builds batches inline.
Per-process shards and epochs come with training and multi-GPU
(ROADMAP.md §1, items 3 and 7).
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import numpy as np

from unimp_tpu_torch.data.collate import collate_batch


class DataLoader:
    def __init__(
        self,
        dataset,
        batch_size: int,
        pad_id: int,
        *,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = True,
        num_workers: int = 4,
        pad_to_multiple: int = 64,
        max_text_len: Optional[int] = None,
        fixed_media: Optional[int] = None,
        prefetch: int = 2,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.pad_id = pad_id
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.num_workers = max(0, num_workers)
        self.pad_to_multiple = pad_to_multiple
        self.max_text_len = max_text_len
        self.fixed_media = fixed_media
        self.prefetch = prefetch

    def _indices(self) -> np.ndarray:
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed)
            idx = rng.permutation(n)
        return idx

    def __len__(self) -> int:
        n = len(self._indices())
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _batches(self):
        idx = self._indices()
        nb = len(self)
        for b in range(nb):
            yield idx[b * self.batch_size : (b + 1) * self.batch_size]

    def _make_batch(self, batch_idx) -> dict:
        samples = [self.dataset[int(i)] for i in batch_idx]
        batch = collate_batch(
            samples,
            self.pad_id,
            pad_to_multiple=self.pad_to_multiple,
            max_text_len=self.max_text_len,
            fixed_media=self.fixed_media,
        )
        batch["tasks"] = [s.get("task") for s in samples]
        return batch

    def __iter__(self) -> Iterator[dict]:
        if self.num_workers == 0:
            for bi in self._batches():
                yield self._make_batch(bi)
            return

        # Background producer: a small thread pool builds batches in order.
        from concurrent.futures import ThreadPoolExecutor

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def producer():
            # Bounded submission window: at most num_workers + prefetch
            # batches in flight — a full epoch is never enqueued up front
            # (the multi-task Amazon epoch is ~23k batches; one future
            # each would pin hundreds of MB of built batches).
            from collections import deque

            window = self.num_workers + self.prefetch
            with ThreadPoolExecutor(self.num_workers) as pool:
                inflight: "deque" = deque()
                gen = self._batches()
                try:
                    for _ in range(window):
                        inflight.append(pool.submit(self._make_batch, next(gen)))
                except StopIteration:
                    gen = None
                while inflight:
                    f = inflight.popleft()
                    if stop.is_set():
                        f.cancel()
                        continue
                    try:
                        q.put(f.result())
                    except Exception as e:  # propagate to consumer
                        q.put(e)
                        return
                    if gen is not None and not stop.is_set():
                        try:
                            inflight.append(
                                pool.submit(self._make_batch, next(gen))
                            )
                        except StopIteration:
                            gen = None
            q.put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
