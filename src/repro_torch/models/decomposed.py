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

Under tensor parallelism (``distributed.tp.use``; the parameters are the
rank's ``params_sharding`` blocks, ``runtime.steps.
make_decomposed_forward_step(mesh=)``) a decomposed block is a Megatron
block.  Its input is whole on every "model" rank and bitwise the same
there (the residual comes out of all-reduces and all-gathers), so every
rank decomposes the same activation and picks the same outlier channels.
Q/K/V, up and gate are projected onto the rank's column blocks of W (in
Table 3 mode, the whole weight's factors with Vᵀ_w's columns cut to the
block: W[:, cols] = U_w Σ_w Vᵀ_w[:, cols]); attention runs the rank's
heads (``tp.layout``: the dense mode on reconstructed Q/K/V as
``layers.qkv`` lays them out, the preserved mode on the factors' Vᵀ
columns, ``tp.q_heads`` / ``tp.vt_heads``), and ``wo`` and ``down`` are
row-parallel (``layers.row_dense``).  Under Megatron-SP the residual is
gathered whole before a decomposed block and split after it
(``tp.sp_whole`` / ``tp.sp_split``); the dense layers run it inside.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ..core.lowrank import LowRank
from ..core.policy import DecompositionPolicy, LayerPolicy
from ..core.preserved import fold_outliers
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

def _project(engine: DecomposeEngine, lr: LowRank, wp: Params,
             wfac: Optional[LowRank], width: int) -> LowRank:
    """``engine.project`` onto the rank's column block ``wp`` of a weight
    ``width`` columns wide (a whole-weight factor's Vᵀ cut to the
    block)."""
    if wfac is not None:
        wfac = LowRank(wfac.u, wfac.core, TP.vt_local(wfac.vt, width))
    return engine.project(lr, wp, wfac)


def _vt_cols(lr: LowRank, fn) -> LowRank:
    """``lr`` (outlier track folded in) with its Vᵀ columns ``fn``'s."""
    lr = fold_outliers(lr)
    return LowRank(lr.u, lr.core, fn(lr.vt))


def _attention(q_lr: LowRank, k_lr: LowRank, v_lr: LowRank,
               positions: torch.Tensor, cfg, engine: DecomposeEngine,
               dtype) -> torch.Tensor:
    """The rank's heads' attention output [B, S, nh_l·hd] of the factored
    Q/K/V of its column blocks (``tp.layout``; every head on one
    device)."""
    lay = TP.layout(cfg)
    hd = cfg.resolved_head_dim
    kvw = cfg.num_kv_heads * hd
    if engine.attn_mode == "preserved":
        if lay.split:
            q_lr = _vt_cols(q_lr, lambda vt: TP.q_heads(vt, lay))
        if not lay.aligned:
            k_lr, v_lr = (_vt_cols(f, lambda vt, w=w: TP.vt_heads(
                vt, lay, kvw, hd, w)) for f, w in ((k_lr, "k_vt"),
                                                   (v_lr, "v_vt")))
        kvh = lay.kvh_l if lay.kv_index is None else lay.nh_l
        sc = engine.qk_scores(q_lr, k_lr, lay.nh_l, hd ** -0.5, kvh)
        mask = positions[..., None] >= positions[..., None, :]
        sc = sc.float().masked_fill(~mask[:, None], -1e30)
        pr = torch.softmax(sc, dim=-1)
        return engine.pv(pr, v_lr, lay.nh_l, kvh).to(dtype)
    q = L.split_heads(TP.q_heads(q_lr.reconstruct(), lay), lay.nh_l)
    k, v = (TP.full_kv(f.reconstruct(), lay, w)
            for f, w in ((k_lr, "k_cols"), (v_lr, "v_cols")))
    k, v = L.split_heads(k, k.shape[-1] // hd), L.split_heads(
        v, v.shape[-1] // hd)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    return L.attend(q, TP.my_heads(k, lay), TP.my_heads(v, lay), positions,
                    out_dtype=dtype)


def decomposed_block(p: Params, x: torch.Tensor, positions: torch.Tensor,
                     cfg, lp: LayerPolicy, threshold: float,
                     engine: DecomposeEngine,
                     wfac: Optional[Params] = None,
                     local: bool = False) -> torch.Tensor:
    """One block executed in decomposed form per ``lp``; every
    decomposition and preserved product goes through ``engine``
    (``local``: ``x`` is this rank's rows of a batch split over DP,
    decomposed alone).  Under tensor parallelism ``x`` is whole on every
    "model" rank and ``p`` the rank's blocks (module docstring)."""
    hd = cfg.resolved_head_dim
    nh, kvh = cfg.num_heads, cfg.num_kv_heads

    # ---- attention path -------------------------------------------------
    h1 = T.norm(p["attn_norm"], x, cfg)
    lr = engine.decompose_activation(h1, lp=lp, threshold=threshold,
                                     local=local)
    wf = (wfac or {}).get("attn", {})
    q_lr, k_lr, v_lr = (_project(engine, lr, p["attn"][k], wf.get(k), w)
                        for k, w in (("wq", nh * hd), ("wk", kvh * hd),
                                     ("wv", kvh * hd)))
    x = x + L.o_proj(p["attn"], _attention(q_lr, k_lr, v_lr, positions,
                                           cfg, engine, x.dtype), cfg)

    # ---- MLP path --------------------------------------------------------
    h2 = T.norm(p["mlp_norm"], x, cfg)
    lr2 = engine.decompose_activation(h2, lp=lp, threshold=threshold,
                                      local=local)
    wfm = (wfac or {}).get("mlp", {})
    up = _project(engine, lr2, p["mlp"]["up"], wfm.get("up"),
                  cfg.d_ff).reconstruct()
    act = L._ACT[cfg.activation]
    if "gate" in p["mlp"]:
        gate = _project(engine, lr2, p["mlp"]["gate"], wfm.get("gate"),
                        cfg.d_ff).reconstruct()
        hidden = act(gate) * up
    else:
        hidden = act(up)
    return x + L.row_dense(p["mlp"]["down"], hidden.to(x.dtype),
                           TP.width_sharded(cfg.d_ff))


def forward(params: Params, cfg, tokens: torch.Tensor,
            engine: DecomposeEngine,
            wfactors: Optional[Dict[int, Params]] = None,
            local: bool = False) -> torch.Tensor:
    """tokens [B, S] → logits [B, S, V]; layers the engine's policy
    selects run :func:`decomposed_block`, the rest the dense block.
    ``wfactors`` are the whole weights' factors
    (:func:`decompose_layer_weights`), ``local`` as in
    :func:`decomposed_block`; under Megatron-SP (``tp.sp_on``) the dense
    blocks run it and each decomposed block gets the residual whole."""
    b, s = tokens.shape
    sp = TP.sp_on(cfg, s)
    x = T.embed(params, cfg, tokens, sp)
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    for i in range(cfg.num_layers):
        layer = L.layer_params(params["layers"], i)
        pol = engine.layer_policy(i)
        if pol.decompose:
            x = TP.sp_split(decomposed_block(
                layer, TP.sp_whole(x, sp), positions, cfg, pol,
                engine.threshold(i), engine, (wfactors or {}).get(i),
                local), sp)
        else:
            x = T.block(layer, x, positions, cfg, sp)
    return T.logits_head(params, x, cfg, sp=sp)


def logit_kl(params: Params, cfg, tokens: torch.Tensor,
             engine: DecomposeEngine,
             wfactors: Optional[Dict[int, Params]] = None,
             local: bool = False) -> torch.Tensor:
    """KL(dense ‖ decomposed) over the vocab, averaged over positions —
    the stand-in for the paper's accuracy metrics (DESIGN.md §7)."""
    base = torch.log_softmax(T.forward(params, cfg, tokens).float(), dim=-1)
    dec = torch.log_softmax(
        forward(params, cfg, tokens, engine, wfactors, local).float(),
        dim=-1)
    return (base.exp() * (base - dec)).sum(-1).mean()
