"""Architecture + shape configuration schema, copied whole from the JAX
package's ``configs/base.py`` (pure Python; importing it from there would
run the JAX package's ``__init__``).

One ``ArchConfig`` per assigned architecture (``registry.py``), plus the
four assigned input shapes.  ``reduced()`` derives the smoke-test variant of
the same family (small widths/layers/experts) used by the CPU tests.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

__all__ = ["ArchConfig", "ShapeSpec", "SHAPES"]


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                 # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k":    ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k":  ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k":   ShapeSpec("long_500k", 524_288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str               # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0         # 0 -> d_model // n_heads

    # attention details
    block: str = "attn"       # attn | mamba2 | rwkv6
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    sliding_window: int = 0   # 0 = full attention
    global_every: int = 0     # gemma3: every Nth layer is global (others local)
    window_cache: bool = False  # decode: ring buffers (W slots) for local
                                # layers instead of full-length caches
    rms_plus_one: bool = False
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    embed_scale: bool = False  # multiply embeddings by sqrt(d_model)

    # MoE
    n_experts: int = 0
    top_k: int = 0
    shared_experts: int = 0
    moe_capacity_factor: float = 1.25   # >= n_experts/top_k => lossless
    moe_group_size: int = 512
    moe_dispatch_dtype: str = "fp32"    # fp32 (GShard-faithful) | bf16
    moe_ep_constraint: bool = False     # force EP all-to-all via constraint

    # SSM (mamba2)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_groups: int = 1

    # hybrid (zamba2): one shared attention block applied after every N
    # mamba layers (weights shared across applications)
    shared_attn_every: int = 0

    # encoder-decoder (seamless): n_layers = decoder layers
    enc_layers: int = 0

    # modality frontend stub: precomputed embeddings prepended / encoded
    frontend: str = "none"    # none | vlm | audio
    frontend_len: int = 0

    # parameter padding for even TP sharding (the fold-padding analogue:
    # idle "PEs" = masked padded heads / vocab rows; exact semantics kept
    # by output masking).  reduced() sets multiples to 1 (no padding).
    head_pad_multiple: int = 16
    vocab_pad_multiple: int = 2048

    # ------------------------------------------------------------------
    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_heads(self) -> int:
        m = self.head_pad_multiple
        return (self.n_heads + m - 1) // m * m

    @property
    def cache_kv_heads(self) -> int:
        """KV-head count stored in decode caches: expanded (duplicated) to
        a TP-shardable multiple when kv_heads < head_pad_multiple.  2x the
        raw cache size, but sharded model-ways instead of replicated —
        an 8x per-device win at TP=16 with kv=8 (EXPERIMENTS §Perf)."""
        m = self.head_pad_multiple
        exp = (self.kv_heads + m - 1) // m * m
        return min(exp, self.padded_heads)

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_multiple
        return (self.vocab + m - 1) // m * m

    @property
    def is_encdec(self) -> bool:
        return self.enc_layers > 0

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def subquadratic(self) -> bool:
        """Eligible for long_500k (SSM / linear-attn / hybrid / mostly-local
        attention).  Pure full-attention archs skip it (DESIGN.md §6)."""
        return (self.block in ("mamba2", "rwkv6")
                or self.shared_attn_every > 0
                or (self.sliding_window > 0 and self.global_every > 0))

    def runs_shape(self, shape: ShapeSpec) -> bool:
        if shape.name == "long_500k":
            return self.subquadratic
        return True

    def param_count(self) -> int:
        """Analytic parameter count (drives MODEL_FLOPS = 6*N*D)."""
        d, hd = self.d_model, self.head_dim_
        attn = d * self.n_heads * hd + 2 * d * self.kv_heads * hd \
            + self.n_heads * hd * d
        mlp_dense = 3 * d * self.d_ff
        if self.block == "mamba2":
            d_in = self.ssm_expand * d
            heads = d_in // self.ssm_head_dim
            per = (2 * d * d_in + 2 * d * self.ssm_groups * self.ssm_state
                   + d * heads + d_in * d
                   + self.ssm_conv * (d_in + 2 * self.ssm_groups * self.ssm_state)
                   + 3 * heads + d_in) + mlp_dense * (0 if self.name.startswith("zamba") else 1)
            blocks = self.n_layers * per
            if self.shared_attn_every:
                blocks += attn + mlp_dense  # one shared block
            emb = self.vocab * d * (1 if self.tie_embeddings else 2)
            return blocks + emb
        if self.block == "rwkv6":
            per = 4 * d * d + d * self.d_ff * 2 + d * d  # time-mix + channel-mix
            emb = self.vocab * d * (1 if self.tie_embeddings else 2)
            return self.n_layers * per + emb
        if self.is_moe:
            per = attn + self.n_experts * 3 * d * self.d_ff \
                + self.shared_experts * 3 * d * self.d_ff + d * self.n_experts
        else:
            per = attn + mlp_dense
        layers = self.n_layers + self.enc_layers
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        return layers * per + emb

    def active_param_count(self) -> int:
        """Active params per token (MoE: routed top_k + shared only)."""
        if not self.is_moe:
            return self.param_count()
        d = self.d_model
        inactive = (self.n_experts - self.top_k) * 3 * d * self.d_ff
        return self.param_count() - self.n_layers * inactive

    # ------------------------------------------------------------------
    def reduced(self) -> "ArchConfig":
        """Smoke-test variant: same family/topology knobs, tiny sizes."""
        layers = 4
        if self.shared_attn_every:
            layers = 2 * min(self.shared_attn_every, 2)
        if self.global_every:
            layers = 2 * self.global_every if self.global_every <= 3 else 6
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=layers,
            d_model=64,
            n_heads=4,
            kv_heads=max(1, min(self.kv_heads, 2)),
            head_dim=16,
            d_ff=128,
            vocab=512,
            n_experts=8 if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            shared_experts=min(self.shared_experts, 1),
            ssm_state=16 if self.ssm_state else 0,
            ssm_head_dim=32 if self.block == "mamba2" else self.ssm_head_dim,
            sliding_window=8 if self.sliding_window else 0,
            global_every=min(self.global_every, 3) if self.global_every else 0,
            shared_attn_every=min(self.shared_attn_every, 2)
            if self.shared_attn_every else 0,
            enc_layers=2 if self.enc_layers else 0,
            frontend_len=8 if self.frontend_len else 0,
            head_pad_multiple=1,
            vocab_pad_multiple=1,
        )
