"""Sharded web-corpus streaming (LAION/MMC4 pipeline family).

The port's own copy of ``unimp_tpu/data/webdata.py`` (pure Python and
numpy: the same shard and sample orders for the same seed and epoch).

Capability parity with the reference's webdataset pipelines
(UniMP's pipeline/train/data.py:186-665: detshuffle2,
ResampledShards2, per-worker splitting, log_and_continue) without the
webdataset dependency: shards are plain jsonl files
(tools/misc_converters.shard_jsonl) streamed with

  * deterministic epoch-seeded shard + sample shuffling (detshuffle)
  * optional with-replacement shard resampling (ResampledShards)
  * per-host sharding
  * exception-tolerant record handling (log_and_continue)
"""

from __future__ import annotations

import glob
import json
from typing import Callable, Iterator, List

import numpy as np


def log_and_continue(exn: Exception) -> bool:
    print(f"[webdata] caught {type(exn).__name__}: {exn}; continuing")
    return True


class ShardedJsonlDataset:
    def __init__(
        self,
        shard_pattern: str,
        *,
        seed: int = 0,
        shuffle_buffer: int = 1000,
        resampled: bool = False,
        process_index: int = 0,
        process_count: int = 1,
        handler: Callable[[Exception], bool] = log_and_continue,
    ):
        self.shards: List[str] = sorted(glob.glob(shard_pattern))
        if not self.shards:
            raise FileNotFoundError(f"no shards match {shard_pattern!r}")
        self.seed = seed
        self.shuffle_buffer = shuffle_buffer
        self.resampled = resampled
        self.process_index = process_index
        self.process_count = process_count
        self.handler = handler
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _epoch_shards(self, rng) -> List[str]:
        if self.resampled:
            # with-replacement resampling (ResampledShards2 semantics)
            idx = rng.integers(0, len(self.shards), size=len(self.shards))
            shards = [self.shards[i] for i in idx]
        else:
            shards = list(self.shards)
            rng.shuffle(shards)
        return shards[self.process_index :: self.process_count]

    def __iter__(self) -> Iterator[dict]:
        rng = np.random.default_rng(self.seed + self.epoch)
        buf: List[dict] = []
        for shard in self._epoch_shards(rng):
            try:
                with open(shard) as f:
                    for line in f:
                        line = line.strip()
                        if not line:
                            continue
                        try:
                            rec = json.loads(line)
                        except Exception as e:  # corrupt record
                            if not self.handler(e):
                                raise
                            continue
                        buf.append(rec)
                        if len(buf) >= self.shuffle_buffer:
                            j = int(rng.integers(len(buf)))
                            buf[j], buf[-1] = buf[-1], buf[j]
                            yield buf.pop()
            except OSError as e:  # unreadable shard
                if not self.handler(e):
                    raise
        rng.shuffle(buf)
        yield from buf
