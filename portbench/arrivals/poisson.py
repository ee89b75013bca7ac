"""Poisson arrivals at ``rate_rps`` requests a second: the window's N
requests get exponential gaps taken at the quantiles ``(i + 0.5) / N``, in
the seed's order, so that every seed offers the same set of gaps."""
import numpy as np

from portbench.lib.traffic import Stream, request_sizes


def make(p, rng, *, widest, seconds):
    rate = float(p["rate_rps"])
    count = max(1, round(rate * seconds))
    u = (np.arange(count) + 0.5) / count
    gaps = rng.permutation(-np.log1p(-u) / rate)
    due = np.concatenate([[0.0], np.cumsum(gaps[:-1])])
    return Stream.of(request_sizes(p, rng, count, widest), p, due)
