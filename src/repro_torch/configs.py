"""Architecture configs of the ported families (the port's own copy).

The fields, ``padded_vocab``, ``resolved_head_dim``, ``d_inner``,
``ssm_heads`` and ``reduced()`` mirror ``repro.configs.base.ArchConfig``
for the two families ported: the dense decoder-only transformer with a
gated MLP, no biases and an untied LM head, and the attention-free Mamba2
(``ssm``); fields other configs vary arrive with them.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # "dense" | "ssm"
    num_layers: int
    d_model: int
    num_heads: int                   # 0 for attention-free (mamba2)
    num_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None   # default d_model // num_heads
    activation: str = "silu"         # gated (SwiGLU) MLP
    rope_theta: float = 10_000.0
    # --- SSM (mamba2) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv_width: int = 4
    dtype: str = "bfloat16"
    norm_eps: float = 1e-5

    @property
    def padded_vocab(self) -> int:
        """Embedding/head rows padded to a multiple of 128; the logits
        tail is masked in ``transformer.logits_head``."""
        return (self.vocab + 127) // 128 * 128

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim is not None:
            return self.head_dim
        return self.d_model // max(self.num_heads, 1)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def kv_width(self) -> int:
        return self.num_kv_heads * self.resolved_head_dim

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ArchConfig":
        """Tiny same-family variant for CPU tests (same rule as the JAX
        package, so a reduced config names the same shapes in both)."""
        kw = dict(
            name=self.name + "-smoke",
            num_layers=min(self.num_layers, 2),
            d_model=128,
            num_heads=min(self.num_heads, 4),
            num_kv_heads=min(self.num_kv_heads, 2),
            head_dim=32 if self.num_heads else None,
            d_ff=256,
            vocab=512)
        if self.ssm_state:
            kw.update(ssm_state=16, ssm_head_dim=32)
        return self.replace(**kw)


_REGISTRY: Dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_arch(name: str) -> ArchConfig:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown arch {name!r}; ported: "
                       f"{sorted(_REGISTRY)}") from None


# The paper's own evaluation model (Tables 2-3).
register(ArchConfig(
    name="llama2-7b", family="dense",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=32,
    d_ff=11008, vocab=32000))

# llama-architecture, MHA (kv=32), SwiGLU [arXiv:2401.02954].
register(ArchConfig(
    name="deepseek-7b", family="dense",
    num_layers=30, d_model=4096, num_heads=32, num_kv_heads=32,
    d_ff=11008, vocab=102400))

# Attention-free SSD (state-space duality) [arXiv:2405.21060].
register(ArchConfig(
    name="mamba2-780m", family="ssm",
    num_layers=48, d_model=1536, num_heads=0, num_kv_heads=0,
    d_ff=0, vocab=50280,
    ssm_state=128, ssm_expand=2, ssm_head_dim=64))
