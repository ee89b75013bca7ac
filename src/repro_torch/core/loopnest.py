"""The 7-D convolution loop nest and its relatives.

The paper (§III) formalizes convolution as a 7-level nested iteration space
over ``(N, N_F, C, R, S, P, Q)``:

    N   batch
    N_F number of filters (output channels)
    C   input channels
    R   filter height
    S   filter width
    P   output height
    Q   output width

with the spatial output dims derived from input resolution, stride and
padding.  GEMM is the 3-D special case and attention a 5-D one; we expose all
three so that the mapping layer (``core/mapping.py``) can bind any of their
dimensions to space (PE array / device mesh) or time (streaming shifts /
scan) uniformly.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

__all__ = [
    "ConvLoopNest",
    "GemmLoopNest",
    "AttnLoopNest",
    "conv_output_dim",
]


def conv_output_dim(size: int, kernel: int, stride: int, pad: int,
                    dilation: int = 1) -> int:
    """Output extent of a convolution along one spatial dimension."""
    eff_k = dilation * (kernel - 1) + 1
    return (size + 2 * pad - eff_k) // stride + 1


@dataclasses.dataclass(frozen=True)
class ConvLoopNest:
    """The canonical 7-D convolution iteration space (Fig 1).

    Tensors:
      filter (N_F, C, R, S)  — paper's (N_F, R, S, C)
      input  (N, C, X, Y)
      output (N, N_F, P, Q)
    """
    n: int          # batch N
    nf: int         # filters N_F
    c: int          # input channels C
    r: int          # filter height R
    s: int          # filter width S
    x: int          # input height X
    y: int          # input width Y
    stride: int = 1
    pad: int = 0
    dilation: int = 1
    groups: int = 1  # channel groups G: the C and N_F axes split into G
    #                  independent fold families (depthwise = G == C)

    def __post_init__(self):
        if self.groups < 1:
            raise ValueError(f"groups must be >= 1, got {self.groups}")
        if self.c % self.groups or self.nf % self.groups:
            raise ValueError(
                f"groups={self.groups} must divide both C={self.c} and "
                f"N_F={self.nf}")

    # ---- derived dims -----------------------------------------------------
    @property
    def cg(self) -> int:
        """Input channels per group (the depth-fold extent of one group)."""
        return self.c // self.groups

    @property
    def nfg(self) -> int:
        """Filters per group."""
        return self.nf // self.groups

    @property
    def depthwise(self) -> bool:
        """The degenerate fold geometry with no depth reduction at all:
        every channel is its own group with exactly one filter."""
        return self.groups > 1 and self.groups == self.c == self.nf

    @property
    def p(self) -> int:
        """Output height P (derived, Fig 1b)."""
        return conv_output_dim(self.x, self.r, self.stride, self.pad,
                               self.dilation)

    @property
    def q(self) -> int:
        """Output width Q (derived)."""
        return conv_output_dim(self.y, self.s, self.stride, self.pad,
                               self.dilation)

    @property
    def padded_x(self) -> int:
        return self.x + 2 * self.pad

    @property
    def padded_y(self) -> int:
        return self.y + 2 * self.pad

    def dims(self) -> Dict[str, int]:
        """The seven loop extents, in canonical order (Fig 1c-i)."""
        return {
            "N_F": self.nf, "C": self.c, "R": self.r, "S": self.s,
            "N": self.n, "P": self.p, "Q": self.q,
        }

    # ---- work census -------------------------------------------------------
    @property
    def macs(self) -> int:
        """Multiply-accumulates across the full 7-D space (each filter only
        sees its own group's C/G channels)."""
        return (self.n * self.nf * self.cg * self.r * self.s
                * self.p * self.q)

    @property
    def flops(self) -> int:
        """2 ops per MAC (mul + add)."""
        return 2 * self.macs

    def tensor_sizes(self) -> Dict[str, int]:
        """Element counts for the three participating tensors."""
        return {
            "filter": self.nf * self.cg * self.r * self.s,
            "input": self.n * self.c * self.x * self.y,
            "output": self.n * self.nf * self.p * self.q,
        }

    def arithmetic_intensity(self, bytes_per_elem: int = 4) -> float:
        """FLOPs per byte touched once (upper bound with perfect reuse)."""
        total = sum(self.tensor_sizes().values()) * bytes_per_elem
        return self.flops / total

    # ---- convenience -------------------------------------------------------
    def with_batch(self, n: int) -> "ConvLoopNest":
        return dataclasses.replace(self, n=n)

    def __str__(self) -> str:  # e.g. "3x3x512x512@56x56 s1 p1"
        g = f" g{self.groups}" if self.groups > 1 else ""
        return (f"{self.r}x{self.s}x{self.c}x{self.nf}@{self.x}x{self.y}"
                f" s{self.stride} p{self.pad}{g}")


@dataclasses.dataclass(frozen=True)
class GemmLoopNest:
    """GEMM = the 3-D degenerate case of the conv nest (R=S=1).

    out[m, n] = sum_k lhs[m, k] * rhs[k, n]
    """
    m: int
    n: int
    k: int

    def dims(self) -> Dict[str, int]:
        return {"M": self.m, "N": self.n, "K": self.k}

    @property
    def flops(self) -> int:
        return 2 * self.m * self.n * self.k

    @classmethod
    def from_conv(cls, cv: ConvLoopNest) -> "GemmLoopNest":
        """The im2col/GEMM lowering the paper argues against (§II): the 7-D
        space collapses to (M = N*P*Q, N = N_F, K = C*R*S)."""
        return cls(m=cv.n * cv.p * cv.q, n=cv.nf, k=cv.c * cv.r * cv.s)


@dataclasses.dataclass(frozen=True)
class AttnLoopNest:
    """Attention as a 5-D nest: (B, H, Tq, Tkv, D) — two chained GEMMs.

    Used by the mapping layer to derive shardings for the LM architectures;
    the paper's streaming/stationary split applies with Q stationary and
    K/V streamed (the flash-style schedule).
    """
    b: int       # batch
    h: int       # query heads
    tq: int      # query positions
    tkv: int     # key/value positions
    d: int       # head dim
    kv_h: int = 0  # kv heads (GQA); 0 => == h

    @property
    def kv_heads(self) -> int:
        return self.kv_h or self.h

    def dims(self) -> Dict[str, int]:
        return {"B": self.b, "H": self.h, "Tq": self.tq,
                "Tkv": self.tkv, "D": self.d}

    @property
    def flops(self) -> int:
        # QK^T + PV, 2 ops/MAC each
        return 2 * 2 * self.b * self.h * self.tq * self.tkv * self.d


# The paper's Table 2 workloads ------------------------------------------------

def synthetic_suite() -> Tuple[ConvLoopNest, ...]:
    """Table 2(A): synthetic 3x3 suite, 56x56 input, stride=pad=1."""
    return tuple(
        ConvLoopNest(n=1, nf=f, c=d, r=3, s=3, x=56, y=56, stride=1, pad=1)
        for d, f in ((64, 64), (128, 128), (256, 256), (512, 512))
    )


def vgg16_conv_layers() -> Tuple[Tuple[str, ConvLoopNest], ...]:
    """Table 2(B): the 13 conv layers of VGG-16 at batch 1, stride=pad=1."""
    spec = (
        ("conv1_1", 224, 3, 64), ("conv1_2", 224, 64, 64),
        ("conv2_1", 112, 64, 128), ("conv2_2", 112, 128, 128),
        ("conv3_1", 56, 128, 256), ("conv3_2", 56, 256, 256),
        ("conv3_3", 56, 256, 256),
        ("conv4_1", 28, 256, 512), ("conv4_2", 28, 512, 512),
        ("conv4_3", 28, 512, 512),
        ("conv5_1", 14, 512, 512), ("conv5_2", 14, 512, 512),
        ("conv5_3", 14, 512, 512),
    )
    return tuple(
        (name, ConvLoopNest(n=1, nf=nf, c=c, r=3, s=3, x=i, y=i,
                            stride=1, pad=1))
        for name, i, c, nf in spec
    )
