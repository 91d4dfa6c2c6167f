"""Master seed stream and per-replica kernel seeds.

``MasterRng`` is the JAX package's (numpy PCG64, one u64 per experiment), so
the same ``seed_gen`` gives the same u64 seeds in both packages. Where the JAX
package turns each u64 into a threefry key, the port needs only the 32-bit
seed that the square-torus kernel is keyed by (``replica_seeds_i32``); all
further randomness is the counter hash of ``ops/lanerng.py``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = ["MasterRng", "replica_seeds_i32"]


class MasterRng:
    """Master seed generator: ``seed_gen=None`` seeds from OS entropy, a
    fixed ``seed_gen`` gives the same seed sequence on every run, and
    successive ``make_seeds`` calls advance the stream."""

    def __init__(self, seed_gen: Optional[int] = None):
        self.reset(seed_gen)

    def reset(self, seed_gen: Optional[int]) -> None:
        self.seed_gen = seed_gen
        self._gen = np.random.Generator(np.random.PCG64(seed_gen))

    def make_seeds(self, num_experiments: int) -> np.ndarray:
        """One u64 per experiment. Returns uint64[n]."""
        n = int(num_experiments)
        if n < 0:
            raise ValueError("num_experiments must be non-negative")
        # one draw per experiment so seed i is independent of the batch size
        return self._gen.integers(0, 2**64, size=n, dtype=np.uint64)

    def next_seed(self) -> int:
        return int(self.make_seeds(1)[0])

    def clone(self) -> "MasterRng":
        other = MasterRng(self.seed_gen)
        other._gen.bit_generator.state = self._gen.bit_generator.state
        return other


def replica_seeds_i32(seeds_u64) -> np.ndarray:
    """uint64[n] experiment seeds -> int32[n] kernel seeds.

    ``hi ^ 0x9E3779B9 ^ (lo << 1)`` on the two 32-bit halves: the numpy form
    of the JAX package's ``_pallas_seeds(keys_from_seeds(seeds))``, bit for
    bit, with no threefry involved."""
    seeds = np.asarray(seeds_u64, dtype=np.uint64)
    hi = (seeds >> np.uint64(32)).astype(np.uint32)
    lo = (seeds & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return (hi ^ np.uint32(0x9E3779B9) ^ (lo << np.uint32(1))).view(np.int32)
