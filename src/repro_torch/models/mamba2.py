"""Mamba2 SSD (state-space duality): chunked dual form + O(1) decode state.

Counterpart of ``repro.models.mamba2``: the same parameter tree (layers
stacked on a leading L axis), the same float32 SSD arithmetic and the
same decode state.  The chunked algorithm:

* intra-chunk term — the attention-like masked product
  M[t, s] = (C_t·B_s)·exp(l_t − l_s)·dt_s for s ≤ t within a chunk,
  through the kernel set's ``ssd_chunk_intra`` (the CUDA kernel on the
  card, its plain version on the host or under ``backend="reference"``);
  C·Bᵀ, which is head-independent, is one ``torch.matmul`` outside it;
* inter-chunk term — per-chunk final states combined by a sequential
  scan over chunks (a Python loop), then broadcast back through C_t.

The chunk is ``CHUNK`` tokens, or the whole sequence when ``CHUNK`` does
not divide it (the reference's rule), so a bucketed prompt of 304 tokens
is one chunk of 304.

Decode carries (conv [B, w−1, ch] in ``cfg.dtype``, ssm [B, nh, hd, ds]
float32) per layer, O(1) in sequence length; ``decode_step`` updates the
state tree IN PLACE, one layer slice at a time.

Under tensor parallelism (``distributed.tp.use(mesh)``; parameters are
the rank's ``params_sharding`` blocks) each rank runs the heads its
``out_proj`` row block touches (``tp.ssm``; its block of heads when M
divides them): the in_proj projection gathered whole once per layer
and narrowed to the rank's rows' z, its heads' x and dt and the whole
B and C, the conv on the rank's channels, the SSD kernel at the rank's
heads, their output narrowed to the rank's rows (``tp.ssm_y``), the
gated RMSNorm's sum of squares over the whole d_inner (``tp.sum_all``
of each rank's rows) and ``out_proj`` row-parallel.  The ``ssm`` state
holds the rank's heads (a head split keeps the rule's whole leaf and
the rank reads and writes its heads, ``tp.ssm_state``); the ``conv``
state the rule's channel block, gathered whole by a decode step and
written back as the block.  Where M does not divide d_inner the rule
replicates ``out_proj`` (``tp.SSMLayout.rep``): every rank runs every
head alike, in_proj gathered whole where its columns are sharded, the
plain gated norm, ``out_proj`` with no all-reduce, the whole ``ssm``
state.  Without a "model" axis every
``tp`` helper is the identity and the body is the single-device
computation.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..distributed import seq as SEQ
from ..distributed import tp as TP
from ..kernels.ops import KernelSet, make_kernels
from ..platform import torch_dtype
from . import layers as L
from . import transformer as T

Params = L.Params

CHUNK = 64


# ---------------------------------------------------------------------------
# Init: the distributions of repro.models.mamba2 (ssd_init, init)
# ---------------------------------------------------------------------------

def init_blocks(cfg, n: int, normal, device) -> Params:
    """``n`` Mamba2 blocks stacked on a leading axis: N(0, 1/in) for the
    projections, N(0, 0.01) for the conv taps, zero conv bias,
    A = −exp(0), D = 1, dt_bias = 0 (float32), ones for norm scales."""
    dt = torch_dtype(cfg.dtype)
    h, di = cfg.d_model, cfg.d_inner
    ds, nh = cfg.ssm_state, cfg.ssm_heads
    conv_ch = di + 2 * ds

    def stacked(shape, std):
        return T.drawn_slices((n,), shape, std, normal, device, dt)

    def full(shape, value, dtype):
        return torch.full((n,) + shape, value, device=device, dtype=dtype)

    ssd = {
        "in_proj": {"w": stacked((h, 2 * di + 2 * ds + nh), h ** -0.5)},
        "conv_w": stacked((cfg.ssm_conv_width, conv_ch), 0.1),
        "conv_b": full((conv_ch,), 0.0, dt),
        "a_log": full((nh,), 0.0, torch.float32),
        "d": full((nh,), 1.0, torch.float32),
        "dt_bias": full((nh,), 0.0, torch.float32),
        "norm": {"scale": full((di,), 1.0, dt)},
        "out_proj": {"w": stacked((di, h), di ** -0.5)},
    }
    return {"norm": {"scale": full((h,), 1.0, dt)}, "ssd": ssd}


def init(cfg, generator: torch.Generator, device=None) -> Params:
    """Random weights on ``device`` from ``generator``: the blocks of
    :func:`init_blocks`, N(0, 1/d_model) for the embedding and the head.
    Each layer's slice is drawn in float32 and stored in ``cfg.dtype``."""
    dev = torch.device(device if device is not None else generator.device)
    dt = torch_dtype(cfg.dtype)
    h = cfg.d_model
    normal = T.normal_drawer(generator, dev, dt)
    layers = init_blocks(cfg, cfg.num_layers, normal, dev)
    return {"embed": {"w": normal((cfg.padded_vocab, h), h ** -0.5)},
            "layers": layers,
            "final_norm": {"scale": torch.ones(h, device=dev, dtype=dt)},
            "lm_head": {"w": normal((h, cfg.padded_vocab), h ** -0.5)}}


# ---------------------------------------------------------------------------
# Core SSD math
# ---------------------------------------------------------------------------

def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0), with no threshold shortcut
    (``F.softplus`` returns x itself above 20)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _conv_causal(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv: x [B, S, C], w [W, C].  The taps sum in
    float32 in the reference's order, then silu, then the cast.  Under
    batch-1 sequence sharding the rows before the rank's block are the
    previous rank's last W − 1 (``seq.halo``), zeros on rank 0."""
    width, s = w.shape[0], x.shape[1]
    if SEQ.current() is not None:
        xp = torch.cat([SEQ.halo(x[:, s - (width - 1):, :]), x], dim=1)
    else:
        xp = torch.nn.functional.pad(x, (0, 0, width - 1, 0))
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(width):            # width is 4: unrolled taps
        out = out + xp[:, i:i + s, :].float() * w[i].float()
    return L.silu(out + b.float()).to(x.dtype)


def _in_proj(p: Params, x_in: torch.Tensor, lay) -> torch.Tensor:
    """The whole in_proj projection [.., 2·di + 2·ds + nh]: under tensor
    parallelism the rank's column block all-gathered (its input through
    ``tp.copy``; where every rank runs every head, ``rep``, the gather's
    backward keeps the rank's block), or, where the rule replicates
    in_proj, the whole product, whose gradient is summed over "model"
    when each rank's heads read part of it."""
    if lay.proj_sharded:
        y = L.dense(p["in_proj"], TP.copy(x_in))
        if lay.rep:
            return TP.gather_keep(y, -1, "in_proj")
        return TP.gather(y, -1, "in_proj")
    y = L.dense(p["in_proj"], x_in)
    return y if lay.rep else TP.copy(y, "in_proj_rep")


def _split_proj(proj: torch.Tensor, cfg, lay):
    """(z, xbc, dt_raw) of a whole projection: the rank's heads' z and dt
    (every head without tensor parallelism) and every conv channel."""
    di, ds = cfg.d_inner, cfg.ssm_state
    z = TP.ssm_rows(proj[..., :di], lay)
    xbc = proj[..., di:2 * di + 2 * ds]
    dt_raw = TP.ssm_heads(proj[..., 2 * di + 2 * ds:], lay)
    return z, xbc, dt_raw


def _heads(t: torch.Tensor, lay) -> torch.Tensor:
    """The rank's heads of a replicated per-head leaf (A, D, dt bias),
    through ``tp.copy``: every model rank reads a part of the leaf, so
    its gradient is summed over "model" and every rank holds the whole
    of it (as for the conv taps and bias and the gated norm's scale)."""
    return TP.ssm_heads(TP.ssm_rep(t, lay), lay)


def _conv_params(p: Params, lay, cfg):
    """The conv taps and bias of the rank's channels (through
    ``tp.copy``, as :func:`_heads`)."""
    return tuple(TP.ssm_channels(TP.ssm_rep(p[k], lay), lay, cfg.d_inner)
                 for k in ("conv_w", "conv_b"))


def _ssd_inputs(p: Params, x_in: torch.Tensor, cfg):
    """in_proj and the causal conv of one layer: (z, raw xbc, x heads
    [B,S,nh,hd], B [B,S,ds], C [B,S,ds], dt [B,S,nh]), float32 but z and
    the raw xbc; the rank's heads under tensor parallelism (the raw xbc:
    every channel)."""
    b, s, _ = x_in.shape
    lay = TP.ssm(cfg)
    ds, hd, xw = cfg.ssm_state, cfg.ssm_head_dim, lay.xcw
    z, xbc_raw, dt_raw = _split_proj(_in_proj(p, x_in, lay), cfg, lay)
    xbc = _conv_causal(TP.ssm_channels(xbc_raw, lay, cfg.d_inner),
                       *_conv_params(p, lay, cfg))
    xh = xbc[..., :xw].reshape(b, s, lay.nh_l, hd).float()
    bm = xbc[..., xw:xw + ds].float()
    cm = xbc[..., xw + ds:].float()
    dt = softplus(dt_raw.float() + _heads(p["dt_bias"], lay))
    return z, xbc_raw, xh, bm, cm, dt


def _gated_norm(p: Params, y: torch.Tensor, cfg, lay) -> torch.Tensor:
    """The gated RMSNorm over the whole d_inner of y [.., di_l]: under
    tensor parallelism the sum of squares over the rank's channels,
    summed over "model" forward and backward (``tp.sum_all``); where
    every rank holds the whole d_inner (``rep``), the plain norm."""
    if TP.current() is None or lay.rep:
        return L.rmsnorm(p, y, cfg.norm_eps)
    y32 = y.float()
    var = TP.sum_all((y32 * y32).sum(-1, keepdim=True),
                     "gated_norm") / cfg.d_inner
    scale = TP.ssm_rows(TP.ssm_rep(p["scale"], lay), lay)
    return (y32 * torch.rsqrt(var + cfg.norm_eps)
            * scale.float()).to(y.dtype)


def _out(p: Params, y: torch.Tensor, cfg, lay, dtype) -> torch.Tensor:
    """The gated norm of the z-gated SSD output y [.., di_l] (float32)
    cast to ``dtype``, then out_proj (row-parallel under tensor
    parallelism)."""
    y = _gated_norm(p["norm"], y.to(dtype), cfg, lay)
    return L.row_dense(p["out_proj"], y, TP.width_sharded(cfg.d_inner))


def _ssd_core(p: Params, x_in: torch.Tensor, cfg, kernels: KernelSet,
              inputs, final: Optional[dict] = None) -> torch.Tensor:
    """The chunked SSD of one layer on its ``_ssd_inputs``; [B, S, H].
    Under batch-1 sequence sharding the rank runs its own chunks, and
    the state entering its first chunk is ``seq.carry``'s scan of the
    ranks' end states; ``final`` (a dict) then receives the state at the
    end of the whole sequence as ``"ssm"``."""
    z, _, xh, bm, cm, dt = inputs
    b, s, _ = x_in.shape
    lay = TP.ssm(cfg)
    nh, hd = lay.nh_l, cfg.ssm_head_dim
    da = dt * -torch.exp(_heads(p["a_log"], lay))          # [B, S, nh] < 0

    q = min(CHUNK, s)
    if s % q != 0:
        q = s
    nc = s // q

    def ch(t):  # chunked view
        return t.reshape((b, nc, q) + t.shape[2:])

    xh_c, bm_c, cm_c, dt_c, da_c = map(ch, (xh, bm, cm, dt, da))
    l = torch.cumsum(da_c, dim=2)                          # [B,nc,Q,nh]

    # ---- intra-chunk: the kernel set's ssd_chunk_intra -----------------
    cb = torch.matmul(cm_c, bm_c.transpose(-1, -2))        # [B,nc,Q,Q]
    g = b * nc
    y_intra = kernels.ssd_chunk_intra(
        cb.reshape(g, q, q), l.reshape(g, q, nh).contiguous(),
        dt_c.reshape(g, q, nh).contiguous(),
        xh_c.reshape(g, q, nh, hd).contiguous()).reshape(b, nc, q, nh, hd)

    # ---- inter-chunk: recurrence over chunk states ----------------------
    decay_to_end = torch.exp(l[:, :, -1:, :] - l)          # [B,nc,Q,nh]
    w = (dt_c * decay_to_end)[..., None] * xh_c            # [B,nc,Q,nh,hd]
    states = torch.einsum("bcsd,bcsnp->bcnpd", bm_c, w)    # [B,nc,nh,hd,ds]
    gc = torch.exp(l[:, :, -1, :])                         # [B,nc,nh]
    h = torch.zeros_like(states[:, 0])
    h_prevs = []
    for c in range(nc):
        h_prevs.append(h)
        h = gc[:, c, :, None, None] * h + states[:, c]
    h_prevs = torch.stack(h_prevs, dim=1)                  # [B,nc,nh,hd,ds]
    if SEQ.current() is not None:
        # the state carried in from the ranks before, decayed to each
        # chunk's start: exp of the exclusive cumsum of chunk decays
        ends = l[:, :, -1, :]                              # [B,nc,nh]
        h_in, h_fin = SEQ.carry(h, ends.sum(1))
        before = torch.exp(torch.cumsum(ends, dim=1) - ends)
        h_prevs = h_prevs + before[..., None, None] * h_in[:, None]
        if final is not None:
            final["ssm"] = h_fin
    y_inter = torch.einsum("bcqd,bcnpd->bcqnp", cm_c, h_prevs) \
        * torch.exp(l)[..., None]

    y = (y_intra + y_inter).reshape(b, s, nh, hd) \
        + _heads(p["d"], lay)[None, None, :, None] * xh
    y = TP.ssm_y(y.reshape(b, s, lay.xcw), lay)
    return _out(p, y * L.silu(z.float()), cfg, lay, x_in.dtype)


def ssd_apply(p: Params, x_in: torch.Tensor, cfg,
              kernels: Optional[KernelSet] = None) -> torch.Tensor:
    """Full-sequence SSD: x_in [B, S, H] → [B, S, H]; the intra-chunk term
    through ``kernels.ssd_chunk_intra`` (default: the ``"cuda"`` set,
    which dispatches on the device)."""
    kernels = kernels or make_kernels()
    return _ssd_core(p, x_in, cfg, kernels, _ssd_inputs(p, x_in, cfg))


def ssd_decode(p: Params, x_in: torch.Tensor, state: Params,
               cfg) -> Tuple[torch.Tensor, Params]:
    """One-token SSD step: x_in [B, 1, H]; state = {conv [B, W−1, ch],
    ssm [B, nh, hd, ds]} → (out [B, 1, H], new state).  Under tensor
    parallelism the state is the rank's (conv: the rule's channel block,
    gathered whole here; ssm: its heads) and so is the new state."""
    b = x_in.shape[0]
    lay = TP.ssm(cfg)
    di, ds, nh, hd = cfg.d_inner, cfg.ssm_state, lay.nh_l, cfg.ssm_head_dim
    xw = lay.xcw
    z, xbc, dt_raw = _split_proj(_in_proj(p, x_in, lay), cfg, lay)

    conv_in = torch.cat([TP.conv_whole(state["conv"], lay),
                         xbc.to(state["conv"].dtype)], dim=1)  # [B, W, ch]
    conv_w, conv_b = _conv_params(p, lay, cfg)
    xbc_c = torch.einsum("bwc,wc->bc",
                         TP.ssm_channels(conv_in, lay, di).float(),
                         conv_w.float())
    xbc_c = L.silu(xbc_c + conv_b.float())
    new_conv = TP.conv_local(conv_in[:, 1:, :], lay)

    xh = xbc_c[:, :xw].reshape(b, nh, hd)
    bm = xbc_c[:, xw:xw + ds]                               # [B, ds]
    cm = xbc_c[:, xw + ds:]

    dt = softplus(dt_raw[:, 0].float() + _heads(p["dt_bias"], lay))
    g = torch.exp(dt * -torch.exp(_heads(p["a_log"], lay)))  # [B, nh]

    h = TP.ssm_state(state["ssm"], lay).float()
    h = g[:, :, None, None] * h \
        + (dt[:, :, None] * xh)[..., None] * bm[:, None, None, :]
    y = torch.einsum("bd,bnpd->bnp", cm, h) \
        + _heads(p["d"], lay)[None, :, None] * xh
    y = TP.ssm_y(y.reshape(b, 1, xw), lay) * L.silu(z.float())
    return _out(p, y, cfg, lay, x_in.dtype), {"conv": new_conv,
                                              "ssm": h.to(torch.float32)}


# ---------------------------------------------------------------------------
# Model-level
# ---------------------------------------------------------------------------

def block(p: Params, x: torch.Tensor, cfg,
          kernels: Optional[KernelSet] = None) -> torch.Tensor:
    return x + ssd_apply(p["ssd"], L.rmsnorm(p["norm"], x, cfg.norm_eps),
                         cfg, kernels)


def forward(p: Params, cfg, tokens: torch.Tensor,
            kernels: Optional[KernelSet] = None) -> torch.Tensor:
    """tokens [B, S] → logits [B, S, V] (the padded vocab tail masked)."""
    x = T.embed(p, cfg, tokens)
    for i in range(cfg.num_layers):
        x = block(L.layer_params(p["layers"], i), x, cfg, kernels)
    return T.logits_head(p, x, cfg)


def loss_fn(p: Params, cfg, batch, kernels: Optional[KernelSet] = None
            ) -> torch.Tensor:
    """Mean next-token cross-entropy of ``batch``, each block under
    :func:`layers.ckpt`; the intra-chunk term through ``kernels`` (the
    ``"cuda"`` set: the differentiable ``SSDChunkIntra``, whose backward
    is a kernel too; ``"reference"``: the plain version under
    autograd)."""
    kernels = kernels or make_kernels()
    x = T.embed(p, cfg, batch["tokens"])
    body = L.ckpt(block, cfg)
    for lp in L.unstack(p["layers"], cfg.num_layers):
        x = body(lp, x, cfg, kernels)
    return T.loss_head(p, x, cfg, batch["labels"])


def init_state(cfg, batch: int, max_len: Optional[int] = None,
               device=None) -> Params:
    """Zero decode state of ``batch`` slots (no time axis: ``max_len`` is
    unused); conv in ``cfg.dtype``, ssm float32; under tensor
    parallelism the rank's blocks (``cache_pspec``)."""
    del max_len
    nl = cfg.num_layers
    return {
        "conv": torch.zeros((nl, batch, cfg.ssm_conv_width - 1,
                             TP.conv_width(cfg)),
                            device=device, dtype=torch_dtype(cfg.dtype)),
        "ssm": torch.zeros((nl, batch, TP.ssm_state_heads(cfg),
                            cfg.ssm_head_dim, cfg.ssm_state),
                           device=device, dtype=torch.float32),
    }


def prefill(p: Params, cfg, tokens: torch.Tensor,
            max_len: Optional[int] = None,
            kernels: Optional[KernelSet] = None
            ) -> Tuple[torch.Tensor, Params]:
    """Full forward that also assembles each layer's final (conv, ssm)
    state.  Returns (last-position logits [B, V], state).  The state
    reuses the layer's in_proj and conv outputs (the reference computes
    them again); its decay is the reference's full-sequence cumsum."""
    del max_len
    kernels = kernels or make_kernels()
    b, s = tokens.shape
    x = T.embed(p, cfg, tokens)
    state = init_state(cfg, b, device=tokens.device)
    lay = TP.ssm(cfg)
    for i in range(cfg.num_layers):
        lp = L.layer_params(p["layers"], i)
        h_in = L.rmsnorm(lp["norm"], x, cfg.norm_eps)
        inputs = _ssd_inputs(lp["ssd"], h_in, cfg)
        final = {}
        x = x + _ssd_core(lp["ssd"], h_in, cfg, kernels, inputs, final)
        put_state({k: state[k][i] for k in state},
                  final_state(lp, inputs, cfg, lay, final), lay)
    if SEQ.current() is not None:
        x = SEQ.from_last(x[:, -1:, :], "last_hidden")
    logits = T.logits_head(p, x[:, -1:, :], cfg)[:, 0]
    return logits, state


def final_state(lp: Params, inputs, cfg, lay, final: dict) -> Params:
    """A Mamba2 block's decode state after a prefill, from its
    ``_ssd_inputs``: the conv window is the last w−1 rows of the PRE-conv
    xbc (the rule's channel block), the ssm state the reference's own
    formula, the einsum ``bsd,bsn,bsnp->bnpd`` of B, dt·decay_to_end and
    x over the full-sequence cumsum of the decay, in float32.  Under
    batch-1 sequence sharding the window is the last rank's and the ssm
    state ``_ssd_core``'s scan over the ranks (``final``)."""
    _, xbc_raw, xh, bm, _, dt = inputs
    w1 = cfg.ssm_conv_width - 1
    conv = TP.conv_local(xbc_raw[:, -w1:, :], lay)
    if SEQ.current() is not None:
        return {"conv": SEQ.from_last(conv, "conv_state"),
                "ssm": final["ssm"]}
    l = torch.cumsum(dt * -torch.exp(_heads(lp["ssd"]["a_log"], lay)), dim=1)
    decay_to_end = torch.exp(l[:, -1:, :] - l)              # [B, S, nh]
    # the path jnp.einsum's optimizer takes: the elementwise pair first,
    # then one contraction over s
    w = (dt * decay_to_end)[..., None] * xh                 # [B,S,nh,hd]
    return {"conv": conv, "ssm": torch.einsum("bsd,bsnp->bnpd", bm, w)}


def put_state(dst: Params, new: Params, lay) -> None:
    """Copy a block's new (conv, ssm) state into its state slices
    ``dst`` (the rank's heads of a whole ``ssm`` leaf under a head
    split)."""
    dst["conv"].copy_(new["conv"])
    TP.ssm_state(dst["ssm"], lay).copy_(new["ssm"])


def write_state(dst: Params, new: Params, cfg, live=None) -> None:
    """:func:`ssd_decode`'s new state into the block's state slices
    ``dst`` IN PLACE, except for a slot whose ``live`` is False."""
    every = slice(None)
    L.write_rows(dst["conv"], every, new["conv"], live)
    L.write_rows(TP.ssm_state(dst["ssm"], TP.ssm(cfg)), every, new["ssm"],
                 live)


def decode_step(p: Params, cfg, token: torch.Tensor, state: Params,
                pos: torch.Tensor, live=None) -> Tuple[torch.Tensor, Params]:
    """One-token step: token [B] → (logits [B, V], state).  ``pos`` is
    unused (the SSM state is position-free); the state is updated IN
    PLACE, one layer slice at a time, except for a slot whose ``live``
    (bool [B]) is False."""
    del pos
    x = T.embed(p, cfg, token)[:, None, :]
    for i in range(cfg.num_layers):
        lp = L.layer_params(p["layers"], i)
        st = {"conv": state["conv"][i], "ssm": state["ssm"][i]}
        y, new = ssd_decode(lp["ssd"], L.rmsnorm(lp["norm"], x,
                                                 cfg.norm_eps), st, cfg)
        write_state(st, new, cfg, live)
        x = x + y
    return T.logits_head(p, x, cfg)[:, 0], state
