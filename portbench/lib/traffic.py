"""The general traffic generator.  A mix (``mixes/<traffic>.json``, with the
cell's own parameters, ``cells/<workload>.json``, over it) is data; two of
its keys name code that is found by name, as metric readers are:

* ``arrivals``: ``arrivals/<name>.py``, whose ``make(p, rng, *, widest,
  seconds)`` gives the run's ``Stream`` (each request's size and, where
  the traffic has a schedule, its due time);
* ``loop``: ``loops/<name>.py``, whose ``drive(system, stream, pool,
  seconds, p, profiler)`` offers the stream to the system for the window
  and returns a ``lib/drive.Window``.

A new arrival shape or way of offering load is a new file there; a new mix
of known shapes is a data file alone.  Parameters every mix has:

* ``images_min`` / ``images_max``: images a request, each size equally
  often; ``images_max`` may be ``"widest_bucket"``;
* ``pool_images``: distinct images (drawn from the seed) that requests
  take in turn, a run of consecutive pool images each.

Every seed gets the same multiset of request sizes (and, where the
arrivals say so, of gaps), in another order: the seed changes which
images and in what order, not how much work a run holds.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class Stream:
    sizes: np.ndarray             # images of each request of one block
    cum: np.ndarray               # images before each request of a block
    pool: int                     # images in the pool
    due_s: Optional[np.ndarray]   # each request's due time, if scheduled

    @classmethod
    def of(cls, sizes: np.ndarray, p: dict,
           due_s: Optional[np.ndarray] = None) -> "Stream":
        return cls(sizes=sizes, cum=np.concatenate([[0], np.cumsum(
            sizes[:-1])]), pool=int(p["pool_images"]), due_s=due_s)

    def __len__(self) -> int:
        return len(self.sizes)

    def request(self, k: int) -> np.ndarray:
        """Pool indices of request ``k``'s images (past the block, the
        stream cycles through it)."""
        b = len(self.sizes)
        n = int(self.sizes[k % b])
        pos = (k // b) * int(self.cum[-1] + self.sizes[-1]) + int(
            self.cum[k % b])
        return (pos + np.arange(n)) % self.pool


def params(mix: dict, cell: dict) -> dict:
    """The mix's parameters with the cell's over them."""
    return {**mix, **{k: v for k, v in cell.items() if k != "limits"}}


def request_sizes(p: dict, rng: np.random.Generator, count: int,
                  widest: int) -> np.ndarray:
    """``count`` request sizes, each of ``images_min``..``images_max``
    equally often, in the seed's order."""
    lo = int(p["images_min"])
    hi = widest if p["images_max"] == "widest_bucket" else \
        int(p["images_max"])
    if hi > widest or lo < 1:
        raise ValueError(f"requests of {lo}..{hi} images do not fit "
                         f"buckets up to {widest}")
    return rng.permutation(np.resize(np.arange(lo, hi + 1), count))


def make(arrivals, p: dict, seed: int, *, widest: int,
         seconds: float) -> Stream:
    """The stream of ``arrivals`` (the module ``p["arrivals"]`` names)
    from the seed."""
    return arrivals.make(p, np.random.default_rng(seed), widest=widest,
                         seconds=seconds)
