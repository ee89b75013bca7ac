"""Real images a formed batch (``ServingMetrics.images / batches``) when
the window closed: how full the bucketed FIFO batches are."""
from portbench.lib.readers import per_batch


def read(art):
    return per_batch(art, "images")
