"""Dataset combinators: round-robin, chain, shuffle pools, batching.

The port's copy of ``object_keypoints_tpu/data/combinators.py`` (plain
Python and numpy; the port never imports the JAX package). Parity with
perception/datasets/utils.py:5-88 (RoundRobin / Chain / SamplingPool) plus
the torch ChainDataset + BufferedShuffleDataset combo the reference's
training script actually uses (scripts/train.py:132-139), and a simple
batcher to replace the torch DataLoader collate.
"""

from __future__ import annotations

import random
from typing import Iterable, Iterator, List, Sequence

import numpy as np


class RoundRobin:
    """Cycle member datasets forever, restarting each as it exhausts
    (datasets/utils.py:5-25)."""

    def __init__(self, datasets: Sequence[Iterable]):
        self.datasets = list(datasets)

    def __iter__(self) -> Iterator:
        iterators = [iter(d) for d in self.datasets]
        i = 0
        while True:
            idx = i % len(iterators)
            try:
                yield next(iterators[idx])
            except StopIteration:
                iterators[idx] = iter(self.datasets[idx])
                yield next(iterators[idx])
            i += 1


class Chain:
    """Sequential concatenation, optionally shuffled order and infinite
    (datasets/utils.py:27-50)."""

    def __init__(self, datasets: Sequence[Iterable], shuffle: bool = False,
                 infinite: bool = False, seed: int | None = None):
        self.datasets = list(datasets)
        self.shuffle = shuffle
        self.infinite = infinite
        self.rng = random.Random(seed)

    def __len__(self):
        return sum(len(d) for d in self.datasets)

    def __iter__(self) -> Iterator:
        while True:
            order = list(range(len(self.datasets)))
            if self.shuffle:
                self.rng.shuffle(order)
            for i in order:
                yield from self.datasets[i]
            if not self.infinite:
                return


class SamplingPool:
    """Reservoir-style shuffle pool of n examples (datasets/utils.py:52-88
    and torch BufferedShuffleDataset semantics): keep a pool, emit a random
    element as each new one arrives, drain at the end."""

    def __init__(self, dataset: Iterable, pool_size: int, seed: int | None = None):
        self.dataset = dataset
        self.pool_size = pool_size
        self.rng = random.Random(seed)

    def __iter__(self) -> Iterator:
        pool: List = []
        for item in self.dataset:
            if len(pool) < self.pool_size:
                pool.append(item)
            else:
                idx = self.rng.randrange(self.pool_size)
                out, pool[idx] = pool[idx], item
                yield out
        self.rng.shuffle(pool)
        yield from pool


BufferedShuffle = SamplingPool  # torch.utils.data.BufferedShuffleDataset analog


def batched(dataset: Iterable[dict], batch_size: int, drop_last: bool = True
            ) -> Iterator[dict]:
    """Stack dict examples into batches (torch DataLoader collate analog)."""
    buf: List[dict] = []
    for example in dataset:
        buf.append(example)
        if len(buf) == batch_size:
            yield {k: np.stack([e[k] for e in buf]) for k in buf[0]}
            buf = []
    if buf and not drop_last:
        yield {k: np.stack([e[k] for e in buf]) for k in buf[0]}
