"""Decomposed (activation) execution of the dense transformer — the
paper's technique wired into the model (paper Figs. 1, 5, 6).

Counterpart of ``repro.models.decomposed``.  All decomposition flows
through ONE :class:`~repro_torch.engine.DecomposeEngine`, whose
``EngineConfig`` carries the policy, the attention mode and the backend;
this module only decides WHERE in the block the engine is invoked.  For
every layer the policy selects, the block input is (a)
outlier-extracted channel-wise (§4), (b) decomposed by the
engine's batched Lanczos (§2.3), and (c) consumed by the layer's GEMMs in
decomposition-preserved form (§3.2):

* Q/K/V projections: Eq. 6 (``lowrank_matmul``), or Eq. 7 when the policy
  also decomposes the weights (Table 3 mode; factors made OFFLINE by
  :func:`decompose_layer_weights`).
* Attention: ``attn_mode="dense"`` reconstructs Q/K/V per head, applies
  RoPE and runs chunked dense attention; ``attn_mode="preserved"``
  contracts QKᵀ and P·V through the factors (no RoPE inside decomposed
  layers — a position-independent Vᵀ cannot carry it).
* MLP: up (and gate, when the MLP is gated) as preserved matmuls,
  reconstructed at the nonlinearity, dense down-projection.  Biases go
  through the engine's projection as one extra rank (exact).

The residual stream stays dense at block boundaries.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ..core.lowrank import LowRank
from ..core.policy import DecompositionPolicy, LayerPolicy
from ..distributed import tp as TP
from ..engine import DecomposeEngine, EngineConfig
from . import layers as L
from . import transformer as T

Params = Dict[str, Any]


def decompose_activation(x: torch.Tensor, lp: LayerPolicy, threshold: float,
                         engine: DecomposeEngine) -> LowRank:
    """x [B, S, H] → LowRank with a dense outlier channel track (the
    pipeline lives in :meth:`DecomposeEngine.decompose_activation`)."""
    return engine.decompose_activation(x, lp=lp, threshold=threshold)


# ---------------------------------------------------------------------------
# Offline weight decomposition (Table 3 mode)
# ---------------------------------------------------------------------------

WEIGHT_KEYS = ("wq", "wk", "wv")        # attention in-projections
MLP_KEYS = ("up", "gate")


def decompose_layer_weights(params: Params, cfg,
                            policy: DecompositionPolicy) -> Dict[int, Params]:
    """Offline: per decomposed layer whose policy asks for it, factor the
    in-projection weights → {layer: {"attn": {wq/wk/wv: LowRank},
    "mlp": {up/gate: LowRank}}}."""
    engine = DecomposeEngine(EngineConfig(policy=policy))
    out: Dict[int, Params] = {}
    for i in policy.decomposed_layers():
        lp = policy.layer(i)
        if not lp.decompose_weights:
            continue
        layer = L.layer_params(params["layers"], i)
        fac: Params = {"attn": {}, "mlp": {}}
        for kname in WEIGHT_KEYS:
            fac["attn"][kname] = engine.decompose_weight(
                layer["attn"][kname]["w"], lp.weight_rank)
        for kname in MLP_KEYS:
            if kname in layer["mlp"]:
                fac["mlp"][kname] = engine.decompose_weight(
                    layer["mlp"][kname]["w"], lp.weight_rank)
        out[i] = fac
    return out


# ---------------------------------------------------------------------------
# Decomposed dense-transformer block and forward
# ---------------------------------------------------------------------------

def decomposed_block(p: Params, x: torch.Tensor, positions: torch.Tensor,
                     cfg, lp: LayerPolicy, threshold: float,
                     engine: DecomposeEngine,
                     wfac: Optional[Params] = None) -> torch.Tensor:
    """One block executed in decomposed form per ``lp``; every
    decomposition and preserved product goes through ``engine``."""
    nh, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim

    # ---- attention path -------------------------------------------------
    h1 = T.norm(p["attn_norm"], x, cfg)
    lr = engine.decompose_activation(h1, lp=lp, threshold=threshold)
    wf = (wfac or {}).get("attn", {})
    q_lr = engine.project(lr, p["attn"]["wq"], wf.get("wq"))
    k_lr = engine.project(lr, p["attn"]["wk"], wf.get("wk"))
    v_lr = engine.project(lr, p["attn"]["wv"], wf.get("wv"))

    if engine.attn_mode == "preserved":
        sc = engine.qk_scores(q_lr, k_lr, nh, hd ** -0.5, kvh)
        mask = positions[..., None] >= positions[..., None, :]
        sc = sc.float().masked_fill(~mask[:, None], -1e30)
        pr = torch.softmax(sc, dim=-1)
        attn_out = engine.pv(pr, v_lr, nh, kvh).to(x.dtype)
    else:
        q = L.split_heads(q_lr.reconstruct(), nh)
        k = L.split_heads(k_lr.reconstruct(), kvh)
        v = L.split_heads(v_lr.reconstruct(), kvh)
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)
        attn_out = L.attend(q, k, v, positions, out_dtype=x.dtype)
    x = x + L.dense(p["attn"]["wo"], attn_out)

    # ---- MLP path --------------------------------------------------------
    h2 = T.norm(p["mlp_norm"], x, cfg)
    lr2 = engine.decompose_activation(h2, lp=lp, threshold=threshold)
    wfm = (wfac or {}).get("mlp", {})
    up = engine.project(lr2, p["mlp"]["up"], wfm.get("up")).reconstruct()
    act = L._ACT[cfg.activation]
    if "gate" in p["mlp"]:
        gate = engine.project(lr2, p["mlp"]["gate"],
                              wfm.get("gate")).reconstruct()
        hidden = act(gate) * up
    else:
        hidden = act(up)
    return x + L.dense(p["mlp"]["down"], hidden.to(x.dtype))


def forward(params: Params, cfg, tokens: torch.Tensor,
            engine: DecomposeEngine,
            wfactors: Optional[Dict[int, Params]] = None) -> torch.Tensor:
    """tokens [B, S] → logits [B, S, V]; layers the engine's policy
    selects run :func:`decomposed_block`, the rest the dense block."""
    if cfg.seq_parallel and TP.current() is not None:
        raise NotImplementedError(
            f"seq_parallel in the decomposed forward of {cfg.name}: the "
            f"port's decomposed blocks do not run Megatron-SP (ROADMAP.md "
            f"A1's remaining item)")
    b, s = tokens.shape
    x = T.embed(params, cfg, tokens)
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    for i in range(cfg.num_layers):
        layer = L.layer_params(params["layers"], i)
        pol = engine.layer_policy(i)
        if pol.decompose:
            x = decomposed_block(layer, x, positions, cfg, pol,
                                 engine.threshold(i), engine,
                                 (wfactors or {}).get(i))
        else:
            x = T.block(layer, x, positions, cfg)
    return T.logits_head(params, x, cfg)


def logit_kl(params: Params, cfg, tokens: torch.Tensor,
             engine: DecomposeEngine,
             wfactors: Optional[Dict[int, Params]] = None) -> torch.Tensor:
    """KL(dense ‖ decomposed) over the vocab, averaged over positions —
    the stand-in for the paper's accuracy metrics (DESIGN.md §7)."""
    base = torch.log_softmax(T.forward(params, cfg, tokens).float(), dim=-1)
    dec = torch.log_softmax(
        forward(params, cfg, tokens, engine, wfactors).float(), dim=-1)
    return (base.exp() * (base - dec)).sum(-1).mean()
