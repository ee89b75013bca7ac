"""The hand-written Hopper fold-conv kernels (``csrc/``), their build, and
the conv entry points with their plain-torch versions.  The package
exports what the JAX package's ``repro.kernels`` does; importing it builds
no kernel (a kernel is built at its first launch).  As there, the
package's name ``conv1d_causal`` is the op (``ops.conv1d_causal``), not
the module of that name: ``from repro_torch.kernels.conv1d_causal import
...`` (or ``importlib.import_module``) reaches the module."""
from repro_torch.kernels.attention_fold import flash_attention_folded
from repro_torch.kernels.ops import conv1d_causal, conv2d

__all__ = ["conv1d_causal", "conv2d", "flash_attention_folded"]
