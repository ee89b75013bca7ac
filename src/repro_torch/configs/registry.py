"""The 10 assigned architectures (exact public configs) + the paper's VGG-16.

Sources as assigned: [arXiv/hf tags in comments].  Each is selectable via
``--arch <id>`` in the launchers; ``reduced()`` variants back the CPU smoke
tests.
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.configs.base import SHAPES, ArchConfig, ShapeSpec

__all__ = ["ARCHS", "get_config", "arch_names", "SHAPES"]


ARCHS: Dict[str, ArchConfig] = {
    # [ssm] Finch — data-dependent decay [arXiv:2404.05892]
    "rwkv6-1.6b": ArchConfig(
        name="rwkv6-1.6b", family="ssm", block="rwkv6",
        n_layers=24, d_model=2048, n_heads=32, kv_heads=32, head_dim=64,
        d_ff=7168, vocab=65536),
    # [vlm] InternViT + InternLM2 backbone [arXiv:2404.16821]
    "internvl2-26b": ArchConfig(
        name="internvl2-26b", family="vlm",
        n_layers=48, d_model=6144, n_heads=48, kv_heads=8, d_ff=16384,
        vocab=92553, rope_theta=1e6, frontend="vlm", frontend_len=256),
    # [hybrid] Mamba2 + shared attn blocks [arXiv:2411.15242]
    "zamba2-1.2b": ArchConfig(
        name="zamba2-1.2b", family="hybrid", block="mamba2",
        n_layers=38, d_model=2048, n_heads=32, kv_heads=32, head_dim=64,
        d_ff=8192, vocab=32000, ssm_state=64, shared_attn_every=6),
    # [audio] enc-dec, multimodal [arXiv:2308.11596]
    "seamless-m4t-medium": ArchConfig(
        name="seamless-m4t-medium", family="audio",
        n_layers=12, enc_layers=12, d_model=1024, n_heads=16, kv_heads=16,
        d_ff=4096, vocab=256206, frontend="audio"),
    # [dense] GQA 128k vocab [arXiv:2407.21783]
    "llama3-8b": ArchConfig(
        name="llama3-8b", family="dense",
        n_layers=32, d_model=4096, n_heads=32, kv_heads=8, d_ff=14336,
        vocab=128256, rope_theta=500_000.0),
    # [dense] qk_norm, GQA [hf:Qwen/Qwen3-8B]
    "qwen3-4b": ArchConfig(
        name="qwen3-4b", family="dense",
        n_layers=36, d_model=2560, n_heads=32, kv_heads=8, head_dim=128,
        d_ff=9728, vocab=151936, qk_norm=True, rope_theta=1e6),
    # [dense] GQA, QKV bias [hf:Qwen/Qwen2.5-0.5B family]
    "qwen2.5-14b": ArchConfig(
        name="qwen2.5-14b", family="dense",
        n_layers=48, d_model=5120, n_heads=40, kv_heads=8, head_dim=128,
        d_ff=13824, vocab=152064, qkv_bias=True, rope_theta=1e6),
    # [dense] 5:1 local:global, 128k ctx [hf:google/gemma-3 family]
    "gemma3-12b": ArchConfig(
        name="gemma3-12b", family="dense",
        n_layers=48, d_model=3840, n_heads=16, kv_heads=8, head_dim=256,
        d_ff=15360, vocab=262144, sliding_window=1024, global_every=6,
        qk_norm=True, rms_plus_one=True, embed_scale=True,
        tie_embeddings=True, rope_theta=1e6),
    # [moe] 32 experts top-8 [hf:ibm-granite/granite-3.0-1b-a400m-base]
    "granite-moe-1b-a400m": ArchConfig(
        name="granite-moe-1b-a400m", family="moe",
        n_layers=24, d_model=1024, n_heads=16, kv_heads=8, head_dim=64,
        d_ff=512, vocab=49155, n_experts=32, top_k=8, tie_embeddings=True),
    # [moe] 4 shared + 60 routed top-4 [hf:Qwen/Qwen1.5-MoE-A2.7B]
    "qwen2-moe-a2.7b": ArchConfig(
        name="qwen2-moe-a2.7b", family="moe",
        n_layers=24, d_model=2048, n_heads=16, kv_heads=16, head_dim=128,
        d_ff=1408, vocab=151936, n_experts=60, top_k=4, shared_experts=4,
        qkv_bias=True),
}


def get_config(name: str, reduced: bool = False) -> ArchConfig:
    base = name[:-len("-smoke")] if name.endswith("-smoke") else name
    cfg = ARCHS[base]
    return cfg.reduced() if (reduced or name.endswith("-smoke")) else cfg


def arch_names() -> List[str]:
    return list(ARCHS)


def cells(single_pod_only: bool = False):
    """The assigned (arch x shape) grid — 40 cells, minus documented skips."""
    for name, cfg in ARCHS.items():
        for sname, shape in SHAPES.items():
            yield name, sname, cfg.runs_shape(shape)
