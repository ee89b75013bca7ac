"""Static analysis for the fold-schedule engine (``foldlint``; the JAX
package's ``analysis/``).

The paper treats the 7-D conv loop nest as safe to decompose into
spatial/temporal mappings only because the mappings obey hard invariants:
fold coverage, group divisibility, on-chip residency, single-writer
accumulators.  This package *proves* those invariants statically — before
any kernel is bound:

* ``plan_check``   — ``ConvBlockPlan`` invariants (divisibility, lane
                     alignment, clamp preservation, grid/fold coverage,
                     the int8 accumulator bound) and the CTA tile's
                     shared-memory residency.
* ``index_check``  — enumeration of each launch's fold grid x operand
                     index maps (``FoldKernelSpec``): in-bounds reads,
                     exactly-once output writes, per-group input offsets,
                     write-race detection; and the CTA tiles of the card's
                     launch (``check_launch_tile``).
* ``graph_check``  — ``StreamGraph`` linting plus an independent
                     re-derivation of ``fuse_graph``'s legality rules.
* ``launch_audit`` — ``audit_launches()``: fold-kernel calls per conv and
                     unfused-epilogue-op detection over one call.
* ``foldlint``     — the CLI tying them together over the model zoo
                     (``python -m repro_torch.analysis.foldlint``).

``core/engine.py:compile_network(verify=True)`` runs the graph, plan,
index and (on a CUDA device) CTA-tile checks inline (memoized per schedule
geometry, so the steady-state cost is a dict lookup) and raises
``FoldLintError`` on any error-severity finding.
"""
from repro_torch.analysis.graph_check import check_fusion, lint_graph
from repro_torch.analysis.index_check import (check_kernel_spec,
                                              check_launch_tile)
from repro_torch.analysis.launch_audit import AuditReport, audit_launches
from repro_torch.analysis.plan_check import check_plan
from repro_torch.analysis.report import Finding, FoldLintError, Report

__all__ = [
    "AuditReport",
    "Finding",
    "FoldLintError",
    "Report",
    "audit_launches",
    "check_fusion",
    "check_kernel_spec",
    "check_launch_tile",
    "check_plan",
    "lint_graph",
]
