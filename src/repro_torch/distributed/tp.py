"""Megatron tensor parallelism over the "model" axis (SPMD, one process
per device).

The reference leaves the model axis to GSPMD: its parameters carry
``params_sharding``'s specs and XLA inserts the collectives.  The port
runs each rank's local blocks (``sharding.shard_params``) through the
same model functions, which ask :func:`current` whether they run under
tensor parallelism and, if so, issue the collectives here.  Every
placement changes no value beyond the order of float sums.

:func:`use` makes a mesh's "model" group current for the calls inside it
(process-wide, not per thread: autograd's backward and the recomputed
forward of activation checkpointing run on other threads).  The model
functions have one body: without a mesh, or on a "model" axis of 1,
:func:`current` is None, :func:`head_layout` is the whole layout, and
every helper here is the identity, so that body is the single-device
computation, op for op.

The operators are ``torch.autograd.Function``s with their own backward:

* :func:`copy` — identity forward, all-reduce backward (the input of a
  column-parallel product: each rank's gradient of a replicated
  activation is a partial sum);
* :func:`reduce` — all-reduce forward, identity backward (the output of
  a row-parallel product);
* :func:`gather` / :func:`gather_rs` — all-gather along a dim forward
  (over "model", or any group: the 2-D expert weights' F dim over
  "data"), reduce-scatter backward;
* :func:`embed` — the vocab-parallel lookup over the rank's rows [V/M, H]
  (other rows masked, then :func:`reduce`);
* :func:`vocab_lse` — logsumexp over vocab-parallel logits [.., V/M]
  (max and sum of exps all-reduced), whose backward is torch's
  ``logsumexp`` backward, so one rank reproduces ``torch.logsumexp``
  bit for bit;
* :func:`reduce_scatter_ag` — reduce-scatter along a dim forward,
  all-gather backward (Megatron-SP's row-parallel output);
* :func:`sum_all` — all-reduce forward AND backward: a statistic that
  every rank's output reads whole (the sum of squares of Mamba2's gated
  RMSNorm over d_inner, each rank holding its heads' d_inner / M), so
  the gradient of each rank's partial is the group's sum of the
  gradients (:func:`reduce`'s identity backward would drop the other
  ranks' terms).

Attention runs Megatron's layout (:class:`HeadLayout`): the rank's query
heads, its kv heads or the whole K/V gathered, the cache in the rule's
block; self-attention and the cross-attention of the vlm and audio
families alike.  Where M divides nh·hd but not nh, the rule's column
block of ``wq`` cuts a head: the rank all-gathers q (:func:`q_heads`),
runs every head its block touches (a head cut between two ranks runs
on both: its scores need the whole head) and multiplies its own
columns of their output (:func:`o_cols`) by its row block of ``wo``;
where the touched query heads read their kv heads unevenly, each gets
its own copy of its kv head (``kv_index``).  Mamba2 (:class:`SSMLayout`,
the ssm and hybrid families) runs the heads its ``out_proj`` row block
touches (its block of heads when M divides them): in_proj's column
block does not fall on head boundaries, so the rank all-gathers the
projection once per layer (:func:`gather`, whose reduce-scatter
backward sums the B/C gradient partials of the ranks' heads) and
narrows it to its heads' x and dt, its rows' z and the whole B and C;
the replicated leaves it reads in part (conv taps and bias, A, D, dt
bias, the gated norm's scale) pass :func:`copy` before the rank slices
them, so every model rank holds the same whole gradient of each.

Megatron-SP (``cfg.seq_parallel``, training, the forward and prefill;
the reference's ``_sp``, in every block it sends through
``transformer.block``): between the TP products the residual stream is
the rank's block of the sequence [B, S/M, H].  Each
column-parallel input is all-gathered along S (:func:`sp_in`, whose
backward reduce-scatters) in place of :func:`copy`; each row-parallel
output is reduce-scattered along S (:func:`sp_out`, whose backward
all-gathers) in place of :func:`reduce`'s all-reduce; the vocab-parallel
embedding reduce-scatters too.  The replicated parameters that act on
the rank's rows (norm scales and biases, the row-parallel biases) pass
:func:`sp_rep`, so each rank's partial gradient is summed over "model".
:func:`sp_on` says whether a full-sequence call runs it (as the
sequence's length S, 0 when off), and is passed down explicitly (a
checkpointed block recomputes with the same value).  A length M does
not divide runs over uneven blocks: ceil(S/M) rows a rank, the last
blocks padded with zero rows, trimmed at every gather.  Around a block
that the reference leaves unconstrained, and around a product whose
weight the rule replicates (a Q/O, K/V, MLP or vocab dim M does not
divide), the residual is gathered whole (:func:`sp_whole`, whose
backward keeps the rank's rows of the replicated gradient) and split
again after it (:func:`sp_split`).

Each collective goes through ``sharding``'s counted helpers.
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional, Tuple

import torch

from . import sharding as sh


class TP(NamedTuple):
    """The "model" axis a model function runs under."""
    mesh: object
    group: object
    size: int
    rank: int


_CURRENT: list = [None]


def current() -> Optional[TP]:
    """The tensor-parallel state of the calls in flight (None: no mesh)."""
    return _CURRENT[0]


@contextlib.contextmanager
def use(mesh, one_rank: bool = False):
    """Run the body under ``mesh``'s "model" axis: tensor-parallel when
    the axis is larger than 1 (or, with ``one_rank``, of any size: a
    one-rank group whose collectives are copies); with no mesh or an
    axis of 1, with no tensor-parallel state (:func:`current` None)."""
    prev = _CURRENT[0]
    on = mesh is not None and (sh.model_size(mesh) > 1 or one_rank)
    _CURRENT[0] = TP(mesh, sh.model_group(mesh), sh.model_size(mesh),
                     sh.model_rank(mesh)) if on else None
    try:
        yield _CURRENT[0]
    finally:
        _CURRENT[0] = prev


def _all_reduce(x: torch.Tensor, group, what: str) -> torch.Tensor:
    out = x.contiguous().clone()
    sh.all_reduce(out, group, what)
    return out


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, what):
        ctx.group, ctx.what = group, what
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group, ctx.what + "_grad"), None, None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, what):
        return _all_reduce(x, group, what)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherRS(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, what, dim):
        ctx.group, ctx.what, ctx.dim = group, what, dim
        return sh.gather_dim(x, group, what, dim)

    @staticmethod
    def backward(ctx, g):
        return (sh.reduce_scatter(g, ctx.group, ctx.what + "_grad",
                                  ctx.dim), None, None, None)


class _ReduceScatterAG(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, what, dim):
        ctx.group, ctx.what, ctx.dim = group, what, dim
        return sh.reduce_scatter(x, group, what, dim)

    @staticmethod
    def backward(ctx, g):
        return (sh.gather_dim(g, ctx.group, ctx.what + "_grad", ctx.dim),
                None, None, None)


class _SumAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, what):
        ctx.group, ctx.what = group, what
        return _all_reduce(x, group, what)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group, ctx.what + "_grad"), None, None


def sum_all(x: torch.Tensor, what: str) -> torch.Tensor:
    """The "model" group's sum of ``x``, all-reduced in the backward too
    (every rank's output depends on every rank's ``x``)."""
    tp = current()
    return x if tp is None else _SumAll.apply(x, tp.group, what)


def group_sum(x: torch.Tensor, group, what: str) -> torch.Tensor:
    """:func:`sum_all` over any ``group`` (the DP group's statistics of a
    token split, ``distributed.tokens``)."""
    return _SumAll.apply(x, group, what)


def copy(x: torch.Tensor, what: str = "tp_in") -> torch.Tensor:
    tp = current()
    if tp is None or not torch.is_grad_enabled():
        return x
    return _Copy.apply(x, tp.group, what)


def reduce(x: torch.Tensor, what: str = "tp_out") -> torch.Tensor:
    tp = current()
    return x if tp is None else _Reduce.apply(x, tp.group, what)


def gather(x: torch.Tensor, dim: int = -1, what: str = "tp_gather"
           ) -> torch.Tensor:
    """The "model" group's ``x`` concatenated along ``dim``; the backward
    reduce-scatters (each rank reads other parts of the whole)."""
    tp = current()
    if tp is None:
        return x
    return gather_rs(x, tp.group, dim, what)


def gather_rs(x: torch.Tensor, group, dim: int, what: str) -> torch.Tensor:
    """``group``'s ``x`` concatenated along ``dim``; the backward
    reduce-scatters the gradient, so it has ``x``'s shape."""
    return _GatherRS.apply(x, group, what, dim % x.dim())


def reduce_scatter_ag(x: torch.Tensor, group, dim: int, what: str
                      ) -> torch.Tensor:
    """``group``'s sum of ``x``, this rank's block of it along ``dim``;
    the backward all-gathers the gradient, so it has ``x``'s shape."""
    return _ReduceScatterAG.apply(x, group, what, dim % x.dim())


# ---------------------------------------------------------------------------
# Megatron-SP: the residual stream sharded along S over "model"
# ---------------------------------------------------------------------------

#: the families whose blocks the reference sends through
#: ``transformer.block`` (its ``_sp`` constrains the residual there): the
#: dense blocks, moe's leading dense layers, the vlm's self-attention
#: blocks and hybrid's shared attention block
SP_FAMILIES = ("dense", "moe", "vlm", "hybrid")


def sp_on(cfg, seq_len: int) -> int:
    """Whether a full-sequence call of ``seq_len`` tokens (the rank's,
    under batch-1 sequence sharding) runs Megatron-SP, as the length the
    call runs it on (truthy), else 0: ``cfg.seq_parallel`` under a
    tensor-parallel state (a "model" axis larger than 1, or a one-rank
    one: ``runtime.steps`` runs a seq_parallel config on any mesh's
    "model" axis), in the blocks the reference sends through
    ``transformer.block`` (:data:`SP_FAMILIES`; moe only when it has
    leading dense layers).  The family decides it once at its entry
    point and passes it down as ``sp``.  A length M does not divide runs
    over uneven blocks (:func:`sp_rows`); a Q/O, K/V, MLP or vocab dim
    that the rule replicates runs its product on the whole residual
    (:func:`sp_whole`, then :func:`sp_split` after a row-parallel
    product).  The ssm and audio families never call
    ``transformer.block`` (nor does moe without dense layers), so there
    ``seq_parallel`` changes nothing, in the reference as here: 0."""
    if not cfg.seq_parallel or current() is None \
            or cfg.family not in SP_FAMILIES \
            or (cfg.family == "moe" and not cfg.first_k_dense):
        return 0
    return seq_len


def sp_rows(sp: int) -> int:
    """Rows of the sequence a rank holds under Megatron-SP over a
    sequence of ``sp`` rows: ceil(S / M), rank i holding rows [i·n,
    (i+1)·n) of the sequence padded with zero rows to M·n (the last
    blocks padded where M does not divide S)."""
    return -(-sp // current().size)


def _sp_pad(x: torch.Tensor, sp: int) -> torch.Tensor:
    """A whole sequence [B, S, ..] padded with zero rows to M·n (the
    backward drops the padding's gradient)."""
    pad = current().size * sp_rows(sp) - x.shape[1]
    if pad == 0:
        return x
    return torch.cat([x, x.new_zeros((x.shape[0], pad) + tuple(
        x.shape[2:]))], dim=1)


def _sp_trim(x: torch.Tensor, sp: int) -> torch.Tensor:
    """The sequence's ``sp`` rows of the gathered blocks [B, M·n, ..]
    (the backward pads the gradient with zero rows)."""
    return x if x.shape[1] == sp else x.narrow(1, 0, sp)


def sp_in(x: torch.Tensor, sp: int, what: str = "tp_in") -> torch.Tensor:
    """A column-parallel product's input: under SP the whole sequence
    gathered over "model" (reduce-scatter backward), else :func:`copy`."""
    if not sp:
        return copy(x, what)
    return _sp_trim(gather_rs(x, current().group, 1, "sp_" + what), sp)


def sp_out(y: torch.Tensor, sp: int, what: str = "tp_out") -> torch.Tensor:
    """A row-parallel product's output: under SP the rank's block of the
    sequence of the group's sum (all-gather backward), else
    :func:`reduce`."""
    if not sp:
        return reduce(y, what)
    return reduce_scatter_ag(_sp_pad(y, sp), current().group, 1,
                             "sp_" + what)


class _WholeRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, rank, what, dim):
        ctx.rank, ctx.n, ctx.dim = rank, x.shape[dim], dim
        return sh.gather_dim(x, group, what, dim)

    @staticmethod
    def backward(ctx, g):
        return (g.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n), None, None,
                None, None)


def gather_keep(x: torch.Tensor, dim: int, what: str) -> torch.Tensor:
    """The "model" group's ``x`` concatenated along ``dim``, for a
    computation every rank then runs alike: the backward keeps the
    rank's block of the (whole, replicated) gradient, where
    :func:`gather`'s reduce-scatter would sum M copies of it."""
    tp = current()
    if tp is None:
        return x
    return _WholeRows.apply(x, tp.group, tp.rank, what, dim % x.dim())


class _SplitRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, rank, size, what):
        ctx.group, ctx.what = group, what
        n = x.shape[1] // size
        return x.narrow(1, rank * n, n)

    @staticmethod
    def backward(ctx, g):
        return (sh.gather_dim(g.contiguous(), ctx.group, ctx.what + "_grad",
                              1), None, None, None, None)


def sp_whole(x: torch.Tensor, sp: int) -> torch.Tensor:
    """The whole sequence [B, S, H] of a residual held as the rank's SP
    rows, before a block the reference does not constrain (an MoE layer,
    a cross-attention block, a Mamba2 group, a decomposed block) or a
    product whose weight the rule replicates: all-gathered over "model"
    (``all_gather/sp_whole``).  That computation then runs replicated,
    so each rank's gradient of the whole is the whole gradient, and the
    backward keeps the rank's rows of it.  ``x`` itself without SP."""
    if not sp:
        return x
    return _sp_trim(gather_keep(x, 1, "sp_whole"), sp)


def sp_split(x: torch.Tensor, sp: int) -> torch.Tensor:
    """The rank's SP rows of a whole (replicated) residual, after such a
    block (:func:`sp_whole`'s inverse): the forward narrows, the backward
    all-gathers the rows' gradients over "model"
    (``all_gather/sp_split_grad``)."""
    if not sp:
        return x
    tp = current()
    return _SplitRows.apply(_sp_pad(x, sp), tp.group, tp.rank, tp.size,
                            "sp_split")


def sp_rep(t: torch.Tensor, sp: int) -> torch.Tensor:
    """A replicated parameter read on the rank's rows under SP (its
    gradient is summed over "model"); itself otherwise."""
    return copy(t, "sp_rep") if sp else t


def block_of(t: torch.Tensor, dim: int) -> torch.Tensor:
    """This model rank's block of the whole ``t`` along ``dim``."""
    tp = current()
    if tp is None:
        return t
    n = t.shape[dim] // tp.size
    return t.narrow(dim, tp.rank * n, n)


# ---------------------------------------------------------------------------
# Vocab-parallel embedding and loss
# ---------------------------------------------------------------------------

def embed(w: torch.Tensor, tokens: torch.Tensor, sp: int = 0
          ) -> torch.Tensor:
    """``W[tokens]`` where ``w`` is this rank's rows [V/M, H] of W: rows of
    other ranks read as zeros, then the group's sum (under SP its
    reduce-scatter along the sequence: the rank's rows)."""
    tp = current()
    lo = tp.rank * w.shape[0]
    idx = tokens - lo
    mine = (idx >= 0) & (idx < w.shape[0])
    rows = w[torch.where(mine, idx, torch.zeros_like(idx))]
    rows = torch.where(mine[..., None], rows, torch.zeros((), dtype=w.dtype,
                                                          device=w.device))
    return sp_out(rows, sp, "embed")


class _VocabLSE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        m = torch.amax(x, dim=-1)
        sh.all_reduce(m, group, "lse_max", op="max")
        s = (x - m[..., None]).exp().sum(-1)
        sh.all_reduce(s, group, "lse_sum")
        out = s.log() + m
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, out = ctx.saved_tensors
        return g[..., None] * (x - out[..., None]).exp(), None


def vocab_lse(x: torch.Tensor) -> torch.Tensor:
    """logsumexp over the whole vocab of the rank's logits [.., V/M]."""
    return _VocabLSE.apply(x, current().group)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  ignore_id: int = -1) -> torch.Tensor:
    """``layers.cross_entropy`` over vocab-parallel logits [.., V/M]: the
    logsumexp through :func:`vocab_lse`, the label logit picked by a
    masked sum over the rank's columns and all-reduced."""
    tp = current()
    lg = logits.float()
    v_l = lg.shape[-1]
    lse = vocab_lse(lg)
    iota = torch.arange(v_l, device=lg.device) + tp.rank * v_l
    ll = reduce(torch.where(iota == labels[..., None], lg,
                            torch.zeros((), device=lg.device)).sum(dim=-1),
                "label_logit")
    nll = lse - ll
    mask = (labels != ignore_id).float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


# ---------------------------------------------------------------------------
# Attention layout under the model axis
# ---------------------------------------------------------------------------

class HeadLayout(NamedTuple):
    """How one rank's attention sees the heads.

    * ``nh_l``, ``q0``: the query heads the rank computes [q0, q0 + nh_l)
      (under a head split, every head its column block touches);
    * ``aligned``: the K/V projections hold whole kv heads, the ones the
      rank's query heads read ([k0, k0 + kvh_l)); else the rank computes
      the whole K/V (all-gathering the projection's columns when they
      are sharded) and picks heads [k0, k0 + kvh_l) for its queries;
    * ``kv_sharded``: the K/V projection's columns are sharded;
    * ``cache``: the dim of a K/V cache leaf [.., kvh, hd] sharded over
      "model" (``cache_pspec``'s rule: -2 kv heads, -1 head_dim, None);
    * ``split``: the rule's column block of ``wq`` (and row block of
      ``wo``), [c0, c0 + nh·hd/M), does not fall on head boundaries (M
      divides nh·hd but not nh): the rank all-gathers q over "model"
      (:func:`q_heads`), runs its touched heads, and keeps the columns
      [o0, o0 + ow) of their output, its block (:func:`o_cols`);
    * ``kv_index``: when the touched query heads read their kv heads
      unevenly (a group the block cuts), each one's kv head relative to
      ``k0``: :func:`compute_heads` and friends then return one kv head
      per query head (a group of 1); None for the grouped layout;
    * ``hd``: the head dim.
    """
    nh_l: int
    q0: int
    kvh_l: int
    k0: int
    aligned: bool
    kv_sharded: bool
    cache: Optional[int]
    split: bool
    o0: int
    ow: int
    kv_index: Optional[Tuple[int, ...]]
    hd: int


def head_layout(cfg, tp: Optional[TP]) -> HeadLayout:
    """The rank's layout under ``tp`` (None: every head, the whole K/V,
    nothing gathered)."""
    nh, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    if tp is None:
        return HeadLayout(nh, 0, kvh, 0, True, False, None, False, 0,
                          nh * hd, None, hd)
    m, r = tp.size, tp.rank
    split = False
    if (nh * hd) % m:
        nh_l, q0 = nh, 0                     # wq/wo replicated
    elif nh % m:
        w = nh * hd // m                     # the rule's column block
        q0 = r * w // hd
        nh_l = (r * w + w - 1) // hd + 1 - q0
        split = True
    else:
        nh_l, q0 = nh // m, r * (nh // m)
    c0 = (r * (nh * hd // m)) if split else q0 * hd
    kv_sharded = (kvh * hd) % m == 0
    aligned = kv_sharded and kvh % m == 0 and nh_l == nh // m and not split
    g = nh // kvh
    k0 = q0 // g
    kvh_l = (q0 + nh_l - 1) // g + 1 - k0
    idx = tuple((q0 + j) // g - k0 for j in range(nh_l))
    even = nh_l % kvh_l == 0 and idx == tuple(
        j // (nh_l // kvh_l) for j in range(nh_l))
    if kvh % m == 0 and (kvh > 1 or m == 1):
        cache = -2
    elif hd % m == 0:
        cache = -1
    else:
        cache = None
    ow = nh * hd // m if split else nh_l * hd
    return HeadLayout(nh_l, q0, kvh_l, k0, aligned, kv_sharded, cache,
                      split, c0 - q0 * hd, ow, None if even else idx, hd)


def layout(cfg) -> HeadLayout:
    """:func:`head_layout` under the current "model" axis."""
    return head_layout(cfg, current())


def full_kv(x: torch.Tensor, lay: HeadLayout, what: str) -> torch.Tensor:
    """The whole K/V projection [.., kvh·hd] from the rank's columns."""
    return gather(x, -1, what) if lay.kv_sharded and not lay.aligned else x


def cache_block(kv: torch.Tensor, lay: HeadLayout) -> torch.Tensor:
    """The rank's block, under the cache rule, of a K/V [.., kv heads, hd]
    from :func:`full_kv` (``aligned``: it holds the rank's heads, which
    are its block)."""
    if lay.aligned or lay.cache is None:
        return kv
    return block_of(kv, lay.cache)


def kv_whole(block: torch.Tensor, lay: HeadLayout, what: str
             ) -> torch.Tensor:
    """The whole K/V [.., kvh, hd] from the rank's cache block."""
    return block if lay.cache is None else gather(block, lay.cache, what)


def kv_local(whole: torch.Tensor, lay: HeadLayout) -> torch.Tensor:
    """The rank's cache block of a whole K/V [.., kvh, hd]."""
    return whole if lay.cache is None else block_of(whole, lay.cache)


def q_heads(q: torch.Tensor, lay: HeadLayout) -> torch.Tensor:
    """The touched heads' query columns [.., nh_l·hd] from the rank's
    ``wq`` block (a head split: the blocks all-gathered over "model",
    whose backward reduce-scatters the ranks' partial gradients of a
    head they share); ``q`` itself otherwise."""
    if not lay.split:
        return q
    return gather(q, -1, "q_cols").narrow(-1, lay.q0 * lay.hd,
                                          lay.nh_l * lay.hd)


def o_cols(x: torch.Tensor, lay: HeadLayout) -> torch.Tensor:
    """The rank's ``wo`` row block of the touched heads' attention
    output [.., nh_l·hd] (a head split); ``x`` itself otherwise."""
    return x.narrow(-1, lay.o0, lay.ow) if lay.split else x


def _per_query(kv: torch.Tensor, lay: HeadLayout) -> torch.Tensor:
    """kv heads [.., kvh_l, hd] → one per touched query head where the
    mapping is uneven (``kv_index``); ``kv`` itself otherwise."""
    if lay.kv_index is None:
        return kv
    idx = torch.tensor(lay.kv_index, device=kv.device)
    return kv.index_select(kv.dim() - 2, idx)


def compute_heads(block: torch.Tensor, lay: HeadLayout, what: str
                  ) -> torch.Tensor:
    """The kv heads the rank's queries read [.., kvh_l, hd] (one per
    query head under ``kv_index``), from its cache block (``aligned``:
    the block itself)."""
    if lay.aligned:
        return block
    return _per_query(kv_whole(block, lay, what).narrow(-2, lay.k0,
                                                        lay.kvh_l), lay)


def my_heads(kv: torch.Tensor, lay: HeadLayout) -> torch.Tensor:
    """The kv heads the rank's queries read, from :func:`full_kv`'s K/V
    (``aligned``: ``kv`` holds them already)."""
    if lay.aligned:
        return kv
    return _per_query(kv.narrow(-2, lay.k0, lay.kvh_l), lay)


def width_sharded(width: int) -> bool:
    """Whether a dim of ``width`` is sharded over "model" (the rules'
    condition, for a factor's kv width, the MLP's hidden width, the
    heads' dims, the padded vocab: M > 1 divides it)."""
    tp = current()
    return tp is not None and width % tp.size == 0


def vt_heads(vt: torch.Tensor, lay: HeadLayout, width: int, hd: int,
             what: str) -> torch.Tensor:
    """The columns [.., r, kvh_l·hd] of a Vᵀ factor that the rank's queries
    read (one head's per query head under ``kv_index``), from its block
    of the kv width (``aligned``: the block)."""
    if lay.aligned:
        return vt
    if width_sharded(width):
        vt = gather(vt, -1, what)
    vt = vt.narrow(-1, lay.k0 * hd, lay.kvh_l * hd)
    if lay.kv_index is None:
        return vt
    lead = tuple(vt.shape[:-1])
    return _per_query(vt.reshape(lead + (lay.kvh_l, hd)), lay).reshape(
        lead + (lay.nh_l * hd,))


def vt_local(vt: torch.Tensor, width: int) -> torch.Tensor:
    """The rank's block of a whole Vᵀ factor's kv width."""
    return block_of(vt, -1) if width_sharded(width) else vt


def vt_whole(vt: torch.Tensor, width: int, what: str) -> torch.Tensor:
    """The whole kv width of a Vᵀ factor from the rank's block."""
    return gather(vt, -1, what) if width_sharded(width) else vt


# ---------------------------------------------------------------------------
# Mamba2 layout under the model axis
# ---------------------------------------------------------------------------

class SSMLayout(NamedTuple):
    """How one rank's Mamba2 block sees the heads.

    * ``nh_l``, ``h0``: the SSD heads the rank runs [h0, h0 + nh_l)
      (under a head split, every head its row block touches);
    * ``x0``, ``di_l``: its rows [x0, x0 + di_l) of d_inner (the rule's
      row block of ``out_proj``; its z rows and gated-norm scale);
    * ``proj_sharded``: in_proj's columns are sharded (the rank
      all-gathers the projection), else the rank computes it whole;
    * ``conv``: the ``conv`` cache's channels are sharded over "model"
      (the rule's contiguous block of d_inner + 2·d_state, which is not
      head-aligned), else the rank holds the whole window;
    * ``xc0``, ``xcw``: the x channels of the heads it runs [xc0, xc0 +
      xcw) (its rows, unless ``split``);
    * ``split``: M does not divide the heads (it divides d_inner): the
      row block cuts a head, the rank runs its touched heads and keeps
      its rows of their output (:func:`ssm_y`), and the ``ssm`` state
      leaf is whole on every rank (``cache_pspec`` replicates it), the
      rank reading and writing its touched heads (:func:`ssm_state`);
    * ``rep``: M does not divide d_inner, so the rule replicates
      ``out_proj`` (and the ``ssm`` state): every rank runs every head
      alike, the in_proj projection gathered whole where the rule shards
      its columns (:func:`gather_keep`: the backward keeps the rank's
      block of the whole gradient), the gated norm over the whole
      d_inner and ``out_proj`` with no collective; the replicated leaves
      get the whole gradient on every rank with no sum over "model".
    """
    nh_l: int
    h0: int
    x0: int
    di_l: int
    proj_sharded: bool
    conv: bool
    xc0: int
    xcw: int
    split: bool
    rep: bool = False


def ssm_layout(cfg, tp: Optional[TP]) -> SSMLayout:
    """The rank's Mamba2 layout under ``tp`` (None: every head, nothing
    gathered)."""
    nh, hd, di, ds = (cfg.ssm_heads, cfg.ssm_head_dim, cfg.d_inner,
                      cfg.ssm_state)
    if tp is None:
        return SSMLayout(nh, 0, 0, di, False, False, 0, di, False)
    m = tp.size
    proj_sharded = (2 * di + 2 * ds + nh) % m == 0
    conv = (di + 2 * ds) % m == 0
    if di % m:
        return SSMLayout(nh, 0, 0, di, proj_sharded, conv, 0, di, False,
                         True)
    di_l = di // m
    x0 = tp.rank * di_l
    h0 = x0 // hd
    nh_l = (x0 + di_l - 1) // hd + 1 - h0
    return SSMLayout(nh_l, h0, x0, di_l, proj_sharded, conv, h0 * hd,
                     nh_l * hd, nh % m != 0)


def ssm(cfg) -> SSMLayout:
    """:func:`ssm_layout` under the current "model" axis."""
    return ssm_layout(cfg, current())


def ssm_rep(t: torch.Tensor, lay: SSMLayout) -> torch.Tensor:
    """A replicated Mamba2 leaf the rank reads (conv taps and bias, A, D,
    dt bias, the gated norm's scale): through :func:`copy` when the
    ranks read parts of it (each holds a partial gradient, summed over
    "model"); itself where every rank reads all of it alike (``rep``)."""
    return t if lay.rep else copy(t, "ssm_rep")


def ssm_heads(t: torch.Tensor, lay: SSMLayout) -> torch.Tensor:
    """The rank's heads [h0, h0 + nh_l) of a per-head last dim (the
    whole tensor without tensor parallelism)."""
    if current() is None:
        return t
    return t.narrow(-1, lay.h0, lay.nh_l)


def ssm_rows(t: torch.Tensor, lay: SSMLayout) -> torch.Tensor:
    """The rank's rows [x0, x0 + di_l) of a d_inner-wide last dim."""
    if current() is None:
        return t
    return t.narrow(-1, lay.x0, lay.di_l)


def ssm_y(y: torch.Tensor, lay: SSMLayout) -> torch.Tensor:
    """The rank's rows of its heads' output [.., xcw] (a head split);
    ``y`` itself otherwise."""
    return y.narrow(-1, lay.x0 - lay.xc0, lay.di_l) if lay.split else y


def ssm_state(t: torch.Tensor, lay: SSMLayout) -> torch.Tensor:
    """The rank's heads of an ``ssm`` state leaf [.., nh, hd, ds] (a view;
    a head split keeps the leaf whole); the leaf itself otherwise."""
    return t.narrow(-3, lay.h0, lay.nh_l) if lay.split else t


def ssm_state_heads(cfg) -> int:
    """Heads of an ``ssm`` state leaf on this rank (``cache_pspec``: the
    rank's block when M divides them, else all)."""
    tp, nh = current(), cfg.ssm_heads
    return nh // tp.size if tp is not None and nh % tp.size == 0 else nh


def ssm_channels(t: torch.Tensor, lay: SSMLayout, di: int) -> torch.Tensor:
    """The channels the rank's conv runs, from the whole conv channels
    [.., d_inner + 2·d_state]: its heads' x channels, then the whole B
    and C."""
    if current() is None:
        return t
    return torch.cat([t.narrow(-1, lay.xc0, lay.xcw),
                      t.narrow(-1, di, t.shape[-1] - di)], dim=-1)


def conv_whole(block: torch.Tensor, lay: SSMLayout) -> torch.Tensor:
    """The whole conv window [.., W−1, ch] from the rank's cache block."""
    return gather(block, -1, "conv_cache") if lay.conv else block


def conv_local(whole: torch.Tensor, lay: SSMLayout) -> torch.Tensor:
    """The rank's cache block of a whole conv window [.., ch]."""
    return block_of(whole, -1) if lay.conv else whole


def conv_width(cfg) -> int:
    """Channels of a ``conv`` cache leaf on this rank."""
    ch = cfg.d_inner + 2 * cfg.ssm_state
    return ch // current().size if ssm(cfg).conv else ch
