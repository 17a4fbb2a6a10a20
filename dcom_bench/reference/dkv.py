"""Serving through a decomposed KV cache, float32, teacher-forced.

A request's prompt is left-padded with id 0 to its admission length
``plen`` and run through dense causal blocks.  Each layer's K (after the
rotary embedding) and V rows of the prompt, [plen, kvh·hd], are replaced
by their rank-r Lanczos factors (r = min(rank, plen, kv width), ``rank +
iters_extra`` steps, capped the same way).  A decode token at position
t attends, per layer, over the factored prefix rows (those below the
current frozen length) and the exact rows of the tail, from the frozen
length up to t itself, under one softmax.  At each fold position f the
prefix (rows below the old frozen length) and the tail rows up to f are
replaced by the best rank-r' approximation of their stack, r' = min(r,
r + tail, old frozen length + tail), and f becomes the frozen length.

Given the served tokens (the first from the prompt's last position),
the whole sequence is known, so this runs layer by layer over every
position of every request at once; it returns, for each request, the
logits [m, vocab] at the positions that produced its m served tokens.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from . import dense as D
from . import lanczos as LZ


def _segments(plen: int, n_dec: int, folds: Sequence[int]):
    """(start, stop) decode-position ranges between folds."""
    cuts = [plen] + [int(f) for f in folds] + [plen + n_dec]
    return [(a, b) for a, b in zip(cuts, cuts[1:]) if b > a]


def _decode_attention(q, k, v, plen: int, folds, rank: int, tail: int,
                      pk, pv, cast):
    """Attention of the decode rows of one request and layer.  q, k, v:
    [n, heads, hd] rows of every position; pk, pv: (U·Σ, Vᵀ) of the
    prompt's K and V.  Returns [n − plen, nh·hd]."""
    n = q.shape[0]
    kvh, hd = k.shape[1], k.shape[2]
    out = []
    frozen = plen
    for a, b in _segments(plen, n - plen, folds):
        if a != frozen:
            # fold at a: prefix rows (below ``frozen``) and tail rows
            # frozen..a-1 into one factored prefix of a rows
            r_in = pk[0].shape[-1]
            r_new = min(rank, r_in + tail, frozen + tail)
            new = []
            for (us, vt), rows in ((pk, k), (pv, v)):
                t_rows = rows[frozen:a].reshape(a - frozen, kvh * hd)
                left = torch.zeros(a, r_in + (a - frozen), device=q.device)
                left[:frozen, :r_in] = us[:frozen]
                left[frozen:, r_in:] = torch.eye(a - frozen,
                                                 device=q.device)
                right = torch.cat([vt, t_rows])
                new.append(LZ.truncate(left, right, r_new))
            pk, pv = new
            frozen = a
        kp = (pk[0][:frozen] @ pk[1]).reshape(frozen, kvh, hd)
        vp = (pv[0][:frozen] @ pv[1]).reshape(frozen, kvh, hd)
        kk = torch.cat([kp, k[frozen:b]])
        vv = torch.cat([vp, v[frozen:b]])
        rows = torch.arange(a, b, device=q.device)
        cols = torch.arange(b, device=q.device)
        valid = (cols[None, :] < frozen) | (cols[None, :] <= rows[:, None])
        out.append(D.attend(q[a:b], kk, vv, valid, cast))
    return torch.cat(out)


def serve(params: Dict, cfg, reqs: List[Dict], rank: int, tail: int,
          iters_extra: int, cast) -> List[torch.Tensor]:
    """``reqs``: dicts with ``tokens`` (the padded prompt, then the served
    tokens but the last: int64 [n]), ``plen`` and ``folds`` (the frozen
    lengths the request folded to, in order).  Returns each request's
    logits [n − plen + 1, vocab] float32."""
    dev = params["embed"]["w"].device
    xs = [D.embed(params, torch.as_tensor(r["tokens"], device=dev), cfg)
          for r in reqs]
    for i in range(cfg.num_layers):
        p = D.layer(params, i)
        qkv = []
        for r, x in zip(reqs, xs):
            pos = torch.arange(x.shape[0], device=dev)
            qkv.append(D.qkv(p["attn"], D.norm(p["attn_norm"], x, cfg),
                             pos, cfg, cast))
        # the prompts' K and V factors, one batched Lanczos each
        facs = {}
        for name, j in (("k", 1), ("v", 2)):
            width = qkv[0][j].shape[1] * qkv[0][j].shape[2]
            smax = max(r["plen"] for r in reqs)
            a = torch.zeros(len(reqs), smax, width, device=dev)
            for b, (r, t) in enumerate(zip(reqs, qkv)):
                a[b, :r["plen"]] = t[j][:r["plen"]].reshape(r["plen"], -1)
            # requests batch by their (rank, steps) caps
            groups: Dict[tuple, list] = {}
            for b, r in enumerate(reqs):
                key = (min(rank, r["plen"], width),
                       min(rank + iters_extra, r["plen"], width))
                groups.setdefault(key, []).append(b)
            us_all, vt_all = [None] * len(reqs), [None] * len(reqs)
            for (rk, it), bs in groups.items():
                us, vt = LZ.svd(a[bs], rk, it)
                for k_, b in enumerate(bs):
                    us_all[b] = us[k_, :reqs[b]["plen"]]
                    vt_all[b] = vt[k_]
            facs[name] = list(zip(us_all, vt_all))
            del a
        new_xs = []
        for b, (r, x, (q, k, v)) in enumerate(zip(reqs, xs, qkv)):
            pl = r["plen"]
            pre = D.attend(q[:pl], k[:pl], v[:pl], D.causal(pl, dev), cast)
            dec = _decode_attention(q, k, v, pl, r["folds"], rank, tail,
                                    facs["k"][b], facs["v"][b], cast) \
                if x.shape[0] > pl else pre[:0]
            att = torch.cat([pre, dec])
            x = x + D.linear(p["attn"]["wo"], att, cast)
            x = x + D.mlp(p["mlp"], D.norm(p["mlp_norm"], x, cfg), cfg, cast)
            new_xs.append(x)
        xs = new_xs
        del p, qkv, facs
    return [D.logits(params, x[r["plen"] - 1:], cfg, cast)
            for r, x in zip(reqs, xs)]
