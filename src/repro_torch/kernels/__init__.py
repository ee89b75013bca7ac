"""The hand-written Hopper fold-conv kernels (``csrc/``), their build, and
the conv entry points with their plain-torch versions."""
