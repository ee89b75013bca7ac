"""Loop-nest formalization, fold geometry, block-plan solver, perf model,
streaming-graph IR and the cached fold-schedule engine."""
