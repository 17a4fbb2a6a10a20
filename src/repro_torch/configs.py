"""Architecture configs of the ported families (the port's own copy).

The fields, ``padded_vocab``, ``resolved_head_dim``, ``d_inner``,
``ssm_heads``, ``dec_layers``, ``is_encdec`` and ``reduced()`` mirror
``repro.configs.base.ArchConfig`` for every family of the reference: the
dense decoder-only transformer (llama-style, or with biased linears and
layernorm, an ungated GELU MLP, GeGLU, tied embeddings), the
attention-free Mamba2 (``ssm``), the token-choice top-k mixture of
experts (``moe``, with the kimi-style leading dense layers and shared
experts), the Zamba2-style hybrid (``hybrid``: Mamba2 blocks plus one
shared attention block every ``attn_period`` layers), the
Llama-3.2-Vision-style ``vlm`` (a tanh-gated cross-attention block every
``cross_attn_period`` layers) and the encoder-decoder ``audio`` family.
The training fields mirror the reference's too: ``optimizer`` ("adamw";
"adafactor" for ``kimi-k2-1t-a32b``), ``remat`` (activation checkpointing
per block, on by default; ``reduced()`` turns it off, as the reference
does) and ``remat_policy`` ("full", or "dots": keep the matmul outputs
and recompute only the cheap elementwise ops).  The sharding field
``expert_sharding`` ("1d": experts over "model"; "2d" for
``kimi-k2-1t-a32b``: also the expert FFN dim over "data") is read by
``distributed.sharding``'s rules; ``seq_parallel`` turns on Megatron-SP
(``distributed.tp.sp_on``).  :class:`ShapeSpec` names a workload shape;
:data:`SHAPES` holds the reference's four, and :func:`cells` says which
of them an arch runs (the reference's dry-run cells).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | ssm | moe | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int                   # 0 for attention-free (mamba2)
    num_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None   # default d_model // num_heads
    activation: str = "silu"         # silu | geglu | gelu
    gated_mlp: bool = True
    use_bias: bool = False           # biased linears and layernorm
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False     # no lm_head; √d embedding scale
    # --- MoE ---
    num_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0                # per-expert FFN dim (d_ff: dense)
    n_shared_experts: int = 0
    first_k_dense: int = 0           # leading dense layers (kimi-style)
    capacity_factor: float = 1.25
    expert_sharding: str = "1d"      # "1d" = EP only; "2d" = EP x data
    moe_shard_map: bool = False      # a token split over DP routes per
                                     # shard (moe_ffn_shard_map), not with
                                     # the global capacity of moe_ffn
    # --- SSM (mamba2) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv_width: int = 4
    # --- hybrid (zamba2) ---
    attn_period: int = 0             # one shared attention block every N
    # --- VLM ---
    cross_attn_period: int = 0       # a cross-attention block every N
    num_image_tokens: int = 0
    # --- encoder-decoder (audio) ---
    enc_layers: int = 0              # decoder layers = num_layers - this
    num_audio_frames: int = 0        # encoder memory (cross-KV) length
    dtype: str = "bfloat16"
    norm_eps: float = 1e-5
    # --- training ---
    optimizer: str = "adamw"         # adamw | adafactor (the 1T MoE)
    remat: bool = True               # activation checkpointing per block
    remat_policy: str = "full"       # full | dots (save matmul outputs)
    seq_parallel: bool = False       # Megatron-SP: residual stream sharded
                                     # along S over "model" (dense family)

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
    def dec_layers(self) -> int:
        return self.num_layers - self.enc_layers

    @property
    def is_encdec(self) -> bool:
        return self.enc_layers > 0

    @property
    def sub_quadratic(self) -> bool:
        """True if the arch decodes long contexts with O(1) state."""
        return self.family in ("ssm", "hybrid")

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
            num_layers=min(self.num_layers, 4 if self.attn_period or
                           self.cross_attn_period else 2),
            d_model=128,
            num_heads=min(self.num_heads, 4),
            num_kv_heads=min(self.num_kv_heads, 2),
            head_dim=32 if self.num_heads else None,
            d_ff=256,
            vocab=512,
            remat=False)
        if self.num_experts:
            kw.update(num_experts=8, top_k=2, moe_d_ff=64,
                      n_shared_experts=min(self.n_shared_experts, 1),
                      first_k_dense=min(self.first_k_dense, 1))
        if self.ssm_state:
            kw.update(ssm_state=16, ssm_head_dim=32)
        if self.attn_period:
            kw.update(attn_period=2)
        if self.cross_attn_period:
            kw.update(cross_attn_period=2, num_image_tokens=16)
        if self.enc_layers:
            kw.update(num_layers=4, enc_layers=2, num_audio_frames=32)
        return self.replace(**kw)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One workload shape: ``global_batch`` sequences of ``seq_len``
    tokens, for ``kind`` train | prefill | decode."""
    name: str
    seq_len: int
    global_batch: int
    kind: str

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


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


def all_archs() -> Dict[str, ArchConfig]:
    return dict(_REGISTRY)


def cells(arch: ArchConfig) -> Tuple[str, ...]:
    """The :data:`SHAPES` names that apply to ``arch``: ``long_500k``
    only for the sub-quadratic families."""
    names = ["train_4k", "prefill_32k", "decode_32k"]
    if arch.sub_quadratic:
        names.append("long_500k")
    return tuple(names)


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

# 64 experts top-8, per-expert d_ff 1024, MHA [arXiv:2409.02060].
register(ArchConfig(
    name="olmoe-1b-7b", family="moe",
    num_layers=16, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=1024, vocab=50304,
    num_experts=64, top_k=8, moe_d_ff=1024))

# Mamba2 backbone plus one SHARED attention+MLP block invoked every
# attn_period layers (38 = 6 x (5 mamba + shared attention) + 2 mamba;
# the released model's per-invocation LoRA deltas are omitted, as in the
# reference) [arXiv:2411.15242].
register(ArchConfig(
    name="zamba2-1.2b", family="hybrid",
    num_layers=38, d_model=2048, num_heads=32, num_kv_heads=32,
    d_ff=8192, vocab=32000,
    ssm_state=64, ssm_expand=2, ssm_head_dim=64,
    attn_period=6))

# 384 experts top-8, one shared expert, first layer dense (the
# reference's paper-table config).  Only its reduced variant runs: the
# full model does not fit one card.
register(ArchConfig(
    name="kimi-k2-1t-a32b", family="moe",
    num_layers=61, d_model=7168, num_heads=64, num_kv_heads=8,
    d_ff=18432, vocab=163840,
    num_experts=384, top_k=8, moe_d_ff=2048,
    n_shared_experts=1, first_k_dense=1, expert_sharding="2d",
    optimizer="adafactor"))

# GQA kv=4, RoPE, biased linears and layernorm, ungated GELU MLP
# [arXiv:2402.19173].
register(ArchConfig(
    name="starcoder2-7b", family="dense",
    num_layers=32, d_model=4608, num_heads=36, num_kv_heads=4,
    d_ff=18432, vocab=49152,
    activation="gelu", gated_mlp=False, use_bias=True))

# GeGLU, head_dim 256, MQA (kv=1), tied embeddings [arXiv:2403.08295].
register(ArchConfig(
    name="gemma-2b", family="dense",
    num_layers=18, d_model=2048, num_heads=8, num_kv_heads=1,
    head_dim=256, d_ff=16384, vocab=256000,
    activation="geglu", gated_mlp=True, tie_embeddings=True))

# GQA kv=8, SwiGLU, tied embeddings [hf:ibm-granite/granite-3.0-2b-base].
register(ArchConfig(
    name="granite-3-2b", family="dense",
    num_layers=40, d_model=2048, num_heads=32, num_kv_heads=8,
    d_ff=8192, vocab=49155,
    activation="silu", gated_mlp=True, tie_embeddings=True))

# Dense LM with a tanh-gated cross-attention block every 5th layer
# (8 x (4 self + 1 cross)); the vision frontend is a stub: prefill takes
# precomputed image embeddings [B, 1601, d_model]
# [hf:meta-llama/Llama-3.2-11B-Vision].
register(ArchConfig(
    name="llama-3.2-vision-11b", family="vlm",
    num_layers=40, d_model=4096, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab=128256,
    cross_attn_period=5, num_image_tokens=1601,
    activation="silu", gated_mlp=True))

# Encoder-decoder backbone, 12 + 12 layers; the audio frontend is a
# stub: prefill takes precomputed frame embeddings [B, 4096, d_model]
# [arXiv:2308.11596].
register(ArchConfig(
    name="seamless-m4t-medium", family="audio",
    num_layers=24, d_model=1024, num_heads=16, num_kv_heads=16,
    d_ff=4096, vocab=256206,
    enc_layers=12, num_audio_frames=4096,
    activation="gelu", gated_mlp=False, use_bias=True))
