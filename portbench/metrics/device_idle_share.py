"""1 - (union of kernel, copy and set intervals) / the traced span, in
percent, from the profiler's device trace."""
from portbench.lib.readers import idle_pct


def read(art):
    return idle_pct(art)
