"""The engine's host microseconds a batch in ``_complete`` after the
readback (``ServingMetrics.host_s / batches``) when the window closed."""
from portbench.lib.readers import per_batch


def read(art):
    return per_batch(art, "host_s", 1e6)
