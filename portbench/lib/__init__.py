"""The harness's general code: registry, generator, drivers, trace
reduction, cost model and the correctness check."""
