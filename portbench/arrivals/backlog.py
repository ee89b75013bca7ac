"""A closed loop's requests: a block of ``block_requests``, with no due
times; the loop offers the next as its backlog runs low, cycling through
the block."""
from portbench.lib.traffic import Stream, request_sizes


def make(p, rng, *, widest, seconds):
    return Stream.of(request_sizes(p, rng, int(p["block_requests"]),
                                   widest), p)
