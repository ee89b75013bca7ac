"""The paper's primary contribution, as the JAX package's ``repro.core``
exports it: the 7-D convolution loop-nest decomposition (Filter Folds /
Image Blocks / Image Folds), the Spatial/Temporal-Map directive algebra,
the analytical performance model (eqs 1-15), the message-driven fold
simulator, the streaming-graph IR and the cached fold-schedule engine."""
from repro_torch.core.loopnest import (AttnLoopNest, ConvLoopNest,
                                       GemmLoopNest, synthetic_suite,
                                       vgg16_conv_layers)
from repro_torch.core.folds import FoldingPlan, PEArray, decompose
from repro_torch.core.mapping import (ConvBlockPlan, MappingPlan, SpatialMap,
                                      TemporalMap, plan_conv_blocks)
from repro_torch.core.perfmodel import (LayerPerf, MavecConfig, kips,
                                        layer_perf, reuse_metrics,
                                        t_ops_cycles)
from repro_torch.core.simulator import execute_conv_by_folds, simulate_cycles
from repro_torch.core.graph import Node, StreamGraph, as_graph, fuse_graph
# engine last: it builds on mapping/perfmodel/graph (kernel imports are lazy)
from repro_torch.core.engine import (CompiledNetwork, ConvSchedule,
                                     ScheduleCache, ScheduleKey,
                                     compile_network, dataflow_costs,
                                     resolve_execution, select_dataflow)

__all__ = [
    "Node", "StreamGraph", "as_graph", "fuse_graph",
    "AttnLoopNest", "ConvLoopNest", "GemmLoopNest", "synthetic_suite",
    "vgg16_conv_layers", "FoldingPlan", "PEArray", "decompose",
    "ConvBlockPlan", "MappingPlan", "SpatialMap", "TemporalMap",
    "plan_conv_blocks", "LayerPerf", "MavecConfig", "kips", "layer_perf",
    "reuse_metrics", "t_ops_cycles", "execute_conv_by_folds",
    "simulate_cycles", "CompiledNetwork", "ConvSchedule", "ScheduleCache",
    "ScheduleKey", "compile_network", "dataflow_costs", "resolve_execution",
    "select_dataflow",
]
