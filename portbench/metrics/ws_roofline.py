"""The weight-stationary fold kernel's share of its roofline: bound time
of the layers the traced batches run weight-stationary over the device
time of the kernels matching ``PATTERN``, in percent."""
from portbench.lib.readers import roofline_pct

PATTERN = r"(?<![A-Za-z0-9_])ws_kernel<"
DATAFLOW = "weight_stationary"


def read(art):
    return roofline_pct(art, DATAFLOW, PATTERN)
