"""Plain PyTorch forwards of the benchmark's models, one file a family.

Each holds ``param_specs(cfg)`` (the parameters the benchmark draws from
the seed, under the port's names), ``layers(cfg, batch)`` (each conv and
dense layer's geometry, for the cost model) and ``forward(params, x, cfg,
round_tf32=False, tf32_paths=False)``.  They import nothing of the port
and nothing of JAX."""
