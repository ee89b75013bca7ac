"""95th percentile of the latency of every request due inside the window,
from its due time to its outcome; one that never answered counts to the
end of the drain."""
import numpy as np


def read(art):
    if not len(art.latencies_ms):
        return None
    return float(np.percentile(art.latencies_ms, 95))
