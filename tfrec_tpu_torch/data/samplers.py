"""Mini-batch generators of the port: a copy of ``tfrec_tpu.data.samplers``'
``CTRBatcher``.

The port imports nothing of the JAX package, so it keeps its own copy; a
test holds the two equal batch for batch. The interaction samplers
(pairwise, pointwise, sequences) come with ROADMAP Queue 1 items 8-9.
"""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np


class CTRBatcher:
    """Shuffled fixed-shape batches over in-memory CTR arrays
    (dense [N,D], cat [N,F], label [N])."""

    def __init__(
        self,
        dense: np.ndarray,
        cat: np.ndarray,
        label: np.ndarray,
        batch_size: int,
        seed: int = 0,
    ):
        if not len(dense) == len(cat) == len(label):
            raise ValueError(f"dense, cat and label differ in length: {len(dense)}, "
                             f"{len(cat)}, {len(label)}")
        self.dense, self.cat, self.label = dense, cat, label
        self.batch_size = batch_size
        self.seed = seed

    def num_batches(self) -> int:
        return len(self.label) // self.batch_size

    def epoch(self, epoch: int) -> Iterator[Dict[str, np.ndarray]]:
        rng = np.random.default_rng((self.seed, epoch))
        perm = rng.permutation(len(self.label))
        for start in range(0, len(perm) - self.batch_size + 1, self.batch_size):
            idx = perm[start : start + self.batch_size]
            yield {
                "dense": self.dense[idx],
                "cat": self.cat[idx],
                "label": self.label[idx],
            }
