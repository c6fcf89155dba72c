"""Traffic generation from the seed, and the measured window's rule.

``prompts`` and ``train_batch`` follow ``chip_smoke.py``'s generators of
the same names: random text below ``<image>``, ``n_media`` ``<image>``
tokens each followed by its item token, right padding with the pad id,
and for training an ``<answer> item <|endofchunk|>`` tail. Two changes
keep every seed's work the same: the lengths of a batch are a fixed set
(evenly spaced from ``min_len`` to ``t``) in an order drawn from the
seed, and the images' item ids are drawn from the seed.
"""

from __future__ import annotations

import time
from typing import Callable

import numpy as np


def batch_lengths(rng: np.random.Generator, b: int, min_len: int, t: int) -> np.ndarray:
    """``b`` prompt lengths evenly spread over [min_len, t], shuffled."""
    lengths = np.rint(np.linspace(min_len, t, b)).astype(np.int64)
    return rng.permutation(lengths)


def prompts(rng, b, t, n_media, n_items, min_len, ids):
    """Right-padded prompts: (input_ids [b, t], seq_len [b], image_ids
    [b, n_media]); ``ids`` holds the token ids ("media", "item_base",
    "pad")."""
    seq_len = batch_lengths(rng, b, min_len, t)
    tokens = rng.integers(1, ids["media"], size=(b, t))
    image_ids = rng.integers(0, n_items, size=(b, n_media))
    for r in range(b):
        for i in range(n_media):
            p = 4 + i * ((seq_len[r] - 12) // n_media)
            tokens[r, p] = ids["media"]
            tokens[r, p + 1] = ids["item_base"] + image_ids[r, i]
        tokens[r, seq_len[r]:] = ids["pad"]
    return tokens, seq_len, image_ids


def train_batch(rng, b, t, n_media, n_items, min_len, ids):
    """Rec training rows: ``prompts`` whose stray ``<answer>`` and
    ``<|endofchunk|>`` ids are replaced, ending in "<answer> item
    <|endofchunk|>"; (input_ids, seq_len, image_ids, weights)."""
    tokens, seq_len, image_ids = prompts(rng, b, t, n_media, n_items, min_len, ids)
    tokens[(tokens == ids["answer"]) | (tokens == ids["endofchunk"])] = 1
    targets = rng.integers(0, n_items, size=b)
    for r in range(b):
        n = seq_len[r]
        tokens[r, n - 3:n] = (ids["answer"], ids["item_base"] + targets[r], ids["endofchunk"])
    return tokens, seq_len, image_ids, np.ones(b, np.float32)


def run_window(step: Callable[[int], None], seconds: float,
               clock: Callable[[], float] = time.perf_counter, ends: list = None):
    """Run ``step(i)`` (one whole batch or update, ending synchronised) for
    i = 0, 1, ... until the first one that ends at or after ``seconds``;
    returns (steps run, seconds taken). A rate is the steps' work over
    those seconds. ``ends``, when given, receives each step's end, in
    seconds from the window's start."""
    start = clock()
    n = 0
    while True:
        step(n)
        n += 1
        elapsed = clock() - start
        if ends is not None:
            ends.append(elapsed)
        if elapsed >= seconds:
            return n, elapsed
