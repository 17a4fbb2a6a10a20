"""ServingFamily — the per-family strategy behind ``serving.Engine``.

Counterpart of ``repro.serving.families`` for the slot path with sync
admission.  Registered families:

* ``dense`` — plain dense-KV transformer serving (the base class);
* ``transformer-dkv`` — the decomposed-KV path, selected whenever the
  engine's ``EngineConfig.kv_rank`` is > 0: prefill factorizes K/V
  through the engine's DecomposeEngine, decode attends through the
  factors, and each slot's dense tail folds back (``compress_tail`` with
  a per-slot mask) when THAT slot's tail fills.

All mutable serving state (``cache``, ``pos``, ``frozen_len``,
``rank_eff``, ``live``) stays on the Engine; families hold no state.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from ..models import decomposed_kv as DK, transformer as T

Admitted = Tuple[np.ndarray, np.ndarray]       # (first tokens, frozen lens)


def _pow2(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


_REGISTRY: Dict[str, type] = {}


def register_family(*names):
    def deco(cls):
        for n in names:
            if n in _REGISTRY:
                raise ValueError(f"serving family {n!r} already registered")
            _REGISTRY[n] = cls
        return cls
    return deco


def family_names() -> List[str]:
    return sorted(_REGISTRY)


def serving_family(eng) -> "ServingFamily":
    """A decomposed-KV rank > 0 selects transformer-dkv, otherwise the
    model config's family key."""
    key = "transformer-dkv" if eng.dkv_rank else eng.cfg.family
    cls = _REGISTRY.get(key)
    if cls is None:
        raise ValueError(f"no ServingFamily registered for {key!r} "
                         f"(have {family_names()})")
    return cls(eng)


class ServingFamily:
    """The base class IS the dense-KV slab path: a [L, slots, max_len,
    kvh, d] cache, prefill + splice admission, one-token decode, no
    folds."""

    def __init__(self, eng):
        self.eng = eng

    def alloc(self):
        eng = self.eng
        return T.init_cache(eng.cfg, eng.slots, eng.max_len,
                            device=eng.device)

    def _batch_rows(self, n: int) -> int:
        """Admission batches pad to a power of two (bounded shape set)."""
        return min(_pow2(n), max(self.eng.slots, 1))

    def admit(self, batch: List[Any], slots_idx: List[int],
              plen: int) -> Admitted:
        """Prefill ``batch`` into ``slots_idx``; returns the first sampled
        tokens and the slots' frozen lengths."""
        eng = self.eng
        toks = eng._toks(batch, self._batch_rows(len(batch)), plen)
        logits, fresh = T.prefill(eng.params, eng.cfg, toks, eng.max_len)
        idx = torch.as_tensor(slots_idx, device=eng.device)
        n = len(batch)
        for key in ("k", "v"):
            eng.cache[key][:, idx] = fresh[key][:, :n]
        return eng._sample_host(logits)[:n], np.zeros(n, np.int32)

    def decode(self, tok: torch.Tensor) -> torch.Tensor:
        eng = self.eng
        pos = torch.from_numpy(eng.pos).long().to(eng.device)
        logits, eng.cache = T.decode_step(eng.params, eng.cfg, tok,
                                          eng.cache, pos)
        return logits

    def maybe_fold(self) -> None:
        """Tail-fold check at a decode boundary (no-op without a tail)."""


@register_family("dense")
class DenseKVServing(ServingFamily):
    """Plain dense-KV transformer serving: the base path unmodified."""


@register_family("transformer-dkv")
class TransformerDKVServing(ServingFamily):
    """The paper's low-rank decomposed-KV serving path (dense family)."""

    def __init__(self, eng):
        assert eng.cfg.family == "dense", "decomposed KV: dense family"
        super().__init__(eng)

    def alloc(self):
        return None                  # built at the first prefill

    def admit(self, batch: List[Any], slots_idx: List[int],
              plen: int) -> Admitted:
        eng = self.eng
        toks = eng._toks(batch, self._batch_rows(len(batch)), plen)
        logits, fresh = DK.prefill_dkv(
            eng.params, eng.cfg, toks, eng.dkv_rank, tail=eng.dkv_tail,
            exact=eng.dkv_exact, engine=eng.dengine)
        n = len(batch)
        if eng.cache is None:
            eng.cache = DK.init_cache(
                eng.cfg, eng.slots, fresh["k_u"].shape[2],
                fresh["k_u"].shape[-1], tail=eng.dkv_tail,
                device=eng.device)
        eng.cache = DK.splice_dkv(eng.cache, fresh, slots_idx)
        eng.rank_eff[slots_idx] = fresh["k_u"].shape[-1]
        return eng._sample_host(logits)[:n], np.full(n, plen, np.int32)

    def decode(self, tok: torch.Tensor) -> torch.Tensor:
        eng = self.eng
        pos = torch.from_numpy(eng.pos).to(eng.device)
        frozen = torch.from_numpy(eng.frozen_len).to(eng.device)
        route = "kernel" if eng.dengine.config.backend == "cuda" \
            else "plain"
        logits, eng.cache = DK.decode_step_dkv(eng.params, eng.cfg, tok,
                                               eng.cache, pos, frozen,
                                               attention=route)
        return logits

    def maybe_fold(self) -> None:
        """Fold every live slot whose tail is full, and co-fold live slots
        at least half full so staggered slots re-synchronize their fold
        cadence (a co-folded slot's unused tail rows fold as zeros)."""
        eng = self.eng
        live_m = np.array([r is not None for r in eng.live])
        occ = eng.pos - eng.frozen_len
        must = live_m & (occ >= eng.dkv_tail)
        if must.any():
            fold = must | (live_m & (occ >= max(1, eng.dkv_tail // 2)))
            self._fold_slots(live_m, fold)

    def _fold_slots(self, live_m: np.ndarray, fold: np.ndarray) -> None:
        eng = self.eng
        r_in = int(eng.cache["k_u"].shape[-1])
        t_frozen = int(eng.cache["k_u"].shape[2])
        new_frozen = np.where(fold, eng.pos, eng.frozen_len).astype(np.int32)
        dev = eng.device
        eng.cache = DK.compress_tail(
            eng.cache, eng.cfg, eng.dkv_rank,
            frozen_len=torch.from_numpy(eng.frozen_len).to(dev),
            fold=torch.from_numpy(fold).to(dev),
            new_frozen=torch.from_numpy(new_frozen).to(dev))
        eng.frozen_len = new_frozen
        eng.rank_eff = np.where(
            fold, DK.fold_rank(eng.dkv_rank, r_in, t_frozen, eng.dkv_tail),
            eng.rank_eff).astype(np.int32)
        eng.stats.tail_folds += int(fold.sum())
        # keep only the rows and factor columns live slots reference
        t_need = int(eng.frozen_len[live_m].max())
        r_need = int(eng.rank_eff[live_m].max())
        for key in ("k_u", "v_u"):
            eng.cache[key] = eng.cache[key][:, :, :t_need,
                                            :r_need].contiguous()
        for key in ("k_vt", "v_vt"):
            eng.cache[key] = eng.cache[key][:, :, :r_need].contiguous()
