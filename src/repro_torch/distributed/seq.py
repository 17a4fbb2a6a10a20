"""Batch-1 sequence sharding over the DP axis (long context at global
batch 1: the reference's ``long_500k`` cell, batch-1 prefill and
training).

The reference's rules (``sharding.batch_spec``'s S branch and
``cache_pspec``'s B == 1 time branch) shard a batch-1 leaf's sequence
and a batch-1 decode cache's time axis; GSPMD then inserts the
collectives.  The port runs SPMD, one process per device: each rank
holds the contiguous block i of n = S / D rows (rank i of the group,
rows [i·n, (i+1)·n)), and the model functions, which ask
:func:`current` whether the sequence is sharded, issue the collectives
here:

* attention (prefill and training) — each rank's query block attends to
  the keys and values all-gathered over the group
  (:func:`gather_time`, whose backward reduce-scatters), causal at the
  rank's offset;
* Mamba2 — the causal conv reads a halo of the previous rank's last
  ``conv_width − 1`` rows (:func:`halo`), ``ssd_chunk_intra`` runs on the
  rank's chunks, and the state entering the rank's first chunk is the
  exclusive scan over the group of the ranks' end states and total
  decays (:func:`carry`); the backward runs the same in reverse, through
  the collectives' autograd duals;
* cross-attention (the vlm and audio families) — the memory (image
  embeddings, encoder frames) is a second sequence, split where the
  group divides its length (:func:`memory`); every query reads every
  memory row, so its K/V rows are all-gathered (:func:`gather_memory`),
  and the encoder's bidirectional self-attention over the rank's frames
  attends to every frame's keys;
* decode (:func:`merge_softmax`, :func:`merge_stats`) — each rank reduces
  its block of the cache's rows to flash-decoding statistics (max and
  sum of exponentials; the decomposed cache's weighted values too),
  all-gathered over the group and merged by log-sum-exp; the new row is
  written by the rank that owns its position (:func:`owner_rows`).

Prefill and training shard over the DP super-axis (``batch_spec`` names
``dp_name``), decode over "data" (``cache_pspec`` names "data"); on a
single-pod mesh both are the "data" group.  :func:`use` makes a group
current for the calls inside it (process-wide, as ``tp.use``: autograd's
backward runs on other threads).  Each collective goes through
``sharding``'s counted helpers.  A sequence runs sharded where the group
divides its length (``runtime.steps.seq_batch``), its block i of D equal
blocks; the rules keep a time axis D does not divide whole on every
rank (a prompt then runs whole, and a prefill cache of such a length is
gathered whole, :func:`to_blocks`).
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional, Tuple

import torch

from . import sharding as sh
from .tp import gather_rs

NEG = -1e30


class Seq(NamedTuple):
    """The group a batch-1 sequence is sharded over."""
    group: object
    size: int
    rank: int


_CURRENT: list = [None]


def current() -> Optional[Seq]:
    """The sequence sharding of the calls in flight (None: whole)."""
    return _CURRENT[0]


def group_of(mesh, axis: str):
    """The process group of ``axis``: "dp" (the DP super-axis, prefill
    and training) or "data" (decode)."""
    return sh.dp_group(mesh) if axis == "dp" else sh.axis_group(mesh,
                                                                  "data")


@contextlib.contextmanager
def use(mesh, axis: str = "dp"):
    """Run the body with a batch-1 sequence sharded over ``mesh``'s
    ``axis`` (a group of one rank included: the same collectives, each
    a copy); ``mesh`` None runs it whole."""
    import torch.distributed as dist
    prev = _CURRENT[0]
    if mesh is None:
        _CURRENT[0] = None
    else:
        g = group_of(mesh, axis)
        _CURRENT[0] = Seq(g, dist.get_world_size(g), dist.get_rank(g))
    try:
        yield _CURRENT[0]
    finally:
        _CURRENT[0] = prev


def offset(n_local: int) -> int:
    """The first global row of this rank's block of ``n_local`` rows."""
    s = current()
    return 0 if s is None else s.rank * n_local


def gather_time(x: torch.Tensor, dim: int, what: str) -> torch.Tensor:
    """The group's blocks of ``x`` concatenated along ``dim`` (the whole
    sequence); the backward reduce-scatters (every rank's queries read
    every rank's keys)."""
    s = current()
    return x if s is None else gather_rs(x, s.group, dim, what)


def gather_rows(x: torch.Tensor, dim: int, what: str) -> torch.Tensor:
    """:func:`gather_time` without a backward (decode)."""
    s = current()
    return x if s is None else sh.gather_dim(x, s.group, what, dim)


def splits(n: int) -> bool:
    """Whether the current group shards a time axis of ``n`` whole rows
    (the rules' condition: a group, and one that divides ``n``; else the
    axis stays whole on every rank)."""
    s = current()
    return s is not None and n % s.size == 0


def memory(mem: torch.Tensor) -> Tuple[torch.Tensor, bool]:
    """(the rank's rows of a cross-attention memory [B, M, H] given whole —
    image embeddings, encoder frames — where the group divides M, else
    the whole memory; whether it was split).  The memory is a second
    sequence: its rows are cut where the rules cut a batch-1 leaf's
    dim 1."""
    if not splits(mem.shape[1]):
        return mem, False
    s = current()
    n = mem.shape[1] // s.size
    return mem.narrow(1, s.rank * n, n), True


def gather_memory(kv, split: bool):
    """A cross-attention's K/V (k, v) [B, M_l, kvh, d] whole: every query
    reads every memory row, so a split memory's rows are all-gathered
    over the group (the backward reduce-scatters); ``kv`` itself when
    the memory is whole."""
    if not split:
        return kv
    return (gather_time(kv[0], 1, "xk_rows"), gather_time(kv[1], 1, "xv_rows"))


def cached_memory(t_local: int, n_whole: int) -> bool:
    """Whether a decode step's cross cache of ``t_local`` rows a rank
    holds its block of a memory of ``n_whole`` rows (``cache_pspec``
    shards a batch-1 k/v leaf's time axis over "data" where D divides
    it) or the whole memory; any other length is not a cache this
    memory made."""
    split = splits(n_whole)
    want = n_whole // current().size if split else n_whole
    if t_local != want:
        raise ValueError(f"a cross cache of {t_local} rows a rank for a "
                         f"memory of {n_whole} rows (expected {want})")
    return split


def halo(tail: torch.Tensor, what: str = "conv_halo") -> torch.Tensor:
    """The previous rank's ``tail`` [B, w, ch] (its last w rows), zeros
    on rank 0: one all-gather of every rank's tail, whose backward
    returns each rank the gradient its successor's rows read."""
    s = current()
    w = tail.shape[1]
    every = gather_rs(tail.contiguous(), s.group, 1, what)
    if s.rank == 0:
        # tied to the gathered blocks (times 0), so that rank 0's backward
        # also joins the reduce-scatter every rank issues
        return every.narrow(1, 0, w) * 0
    return every.narrow(1, (s.rank - 1) * w, w)


def carry(h_end: torch.Tensor, log_g: torch.Tensor, what: str = "ssd_state"):
    """The Mamba2 state entering this rank's first chunk, and the state
    at the end of the whole sequence: h_end [B, nh, hd, ds] is the state
    at the end of the rank's rows from a zero start, log_g [B, nh] the
    log of its total decay.  One all-gather each; the exclusive scan
    h ← exp(log_g_j)·h + h_end_j runs over the ranks in order."""
    s = current()
    hs = gather_rs(h_end[None].contiguous(), s.group, 0, what)
    gs = gather_rs(log_g[None].contiguous(), s.group, 0, what + "_decay")
    h = torch.zeros_like(h_end)
    into = h
    for j in range(s.size):
        if j == s.rank:
            into = h
        h = torch.exp(gs[j])[..., None, None] * h + hs[j]
    # tied to every gathered block (the final state, times 0), so that
    # each rank's backward joins both gathers' reduce-scatters
    return into + h * 0, h


def from_last(t: torch.Tensor, what: str) -> torch.Tensor:
    """The group's last rank's ``t`` on every rank (one counted
    broadcast; the rows at the end of the sequence live there)."""
    s = current()
    out = t.detach().contiguous().clone()
    sh.broadcast(out, s.group, s.size - 1, what)
    return out


def owner_rows(pos: torch.Tensor, n_local: int, live=None):
    """(local row, keep) of each slot's global row ``pos``, clamped into
    the whole axis of ``n_local`` rows a rank (as a dynamic update
    clamps): the row is written only where ``keep`` (its owner, and
    ``live`` where given; without a group every slot owns its row and
    ``keep`` is ``live``)."""
    s = current()
    if s is None:
        return torch.clamp(pos, 0, n_local - 1).long(), live
    w = torch.clamp(pos, 0, n_local * s.size - 1)
    local = w - offset(n_local)
    own = (local >= 0) & (local < n_local)
    return (torch.clamp(local, 0, n_local - 1).long(),
            own if live is None else own & live)


def merge_softmax(sc: torch.Tensor, valid: torch.Tensor, v: torch.Tensor,
                  what: str = "attn") -> torch.Tensor:
    """Softmax attention of one query row over the rank's rows: sc
    [B, kvh, g, T_l] float32 scores, ``valid`` [B, T_l], v [B, T_l, kvh, d]
    → out [B, kvh, g, d] float32.  The rank's (max, sum of exponentials)
    merge with the group's by log-sum-exp (:func:`merge_stats`); each
    rank's probabilities, normalized by the whole row's and rounded to
    v's dtype as a softmax's are, weight its values, and the ranks'
    partial outputs are all-reduced.  Without a group both merges are
    the identity: the row's own softmax.  A rank with no valid row
    contributes nothing (its max is NEG, which the group's outweighs)."""
    s = current()
    sc = torch.where(valid[:, None, None, :], sc, torch.full_like(sc, NEG))
    m = sc.amax(-1, keepdim=True)                              # [B,k,g,1]
    e = torch.exp(sc - m)
    _, big, tot = merge_stats(m[..., :0], m, e.sum(-1, keepdim=True),
                              what + "_stats")
    p = (e * (torch.exp(m - big) / tot)).to(v.dtype)
    o = torch.einsum("bkgt,btkd->bkgd", p.float(), v.float()).contiguous()
    if s is not None:
        sh.all_reduce(o, s.group, what + "_out")
    return o


def merge_stats(a: torch.Tensor, m: torch.Tensor, l_: torch.Tensor,
                what: str = "attn_stats"):
    """The group's flash statistics merged: a [.., r] (Σ p·values), m and
    l [.., 1] (max and Σ p of the rank's rows, m = NEG and a = l = 0
    where it has none) → (a, m, l) over every rank's rows."""
    s = current()
    if s is None:
        return a, m, l_
    packed = torch.cat([a, m, l_], dim=-1).contiguous()
    every = sh.gather_dim(packed[None], s.group, what, 0)   # [D, .., r+2]
    r = a.shape[-1]
    ms = every[..., r:r + 1]
    big = ms.amax(0)
    scale = torch.exp(ms - big)
    return ((every[..., :r] * scale).sum(0), big,
            (every[..., r + 1:] * scale).sum(0))


def to_blocks(rows: torch.Tensor, t_whole: int, what: str) -> torch.Tensor:
    """The rank's block of a time axis of ``t_whole`` rows (zeros past
    the sequence) from its ``rows`` [1, n, ...] of the sequence's n·D:
    one all-to-all that moves each rank only the rows its block holds
    (none at all where ``t_whole`` is the sequence's length).  A length
    D does not divide stays whole on every rank (``cache_pspec``): the
    rows are all-gathered."""
    s = current()
    n = rows.shape[1]
    if t_whole == n * s.size:
        return rows
    if t_whole % s.size:
        every = gather_rows(rows, 1, what + "_whole")
        out = every.new_zeros((1, t_whole) + tuple(every.shape[2:]))
        out[:, :every.shape[1]] = every
        return out
    m, i = t_whole // s.size, s.rank

    def span(a, b):                      # rows of block a (n) in block b (m)
        return max(0, min((a + 1) * n, (b + 1) * m) - max(a * n, b * m))
    send = [span(i, j) for j in range(s.size)]
    recv = [span(j, i) for j in range(s.size)]
    src = rows[0].contiguous()
    out = torch.zeros((m,) + tuple(src.shape[1:]), dtype=src.dtype,
                      device=src.device)
    sh.all_to_all(out[:sum(recv)], src, recv, send, s.group, what)
    return out[None]
