"""PyTorch/CUDA port of the fold-streamed convolution engine.

A package beside ``repro`` (the JAX reference), laid out the same way
(``core/``, ``kernels/``, ``models/``, ``serve/``, ``obs/``).  It imports
torch and never jax.  Every entry point runs on ``device="cuda"`` unless
the caller passes ``device="cpu"``.
"""
