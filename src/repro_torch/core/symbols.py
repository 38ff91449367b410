"""FlashOmni unified sparse symbols (paper §3.3), port of ``repro.core.symbols``.

Boolean block masks (True = compute) pack into uint8 symbols, big-endian
within each byte (paper Fig. 5: mask [1,1,1,0,0] -> 0b11100000 = 224).
The index helpers reproduce the reference's tie rules exactly, because
every DispatchPlan field must match it bit for bit:

  * :func:`clamp_mask_topk` keeps the top ``cap`` scores with the LOWER
    index winning ties (``lax.top_k``'s rule) through a stable sort;
    ``torch.topk`` makes no such promise.
  * :func:`active_indices` lists live ids ascending and pads with the last
    live id (0 when none is live).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "packed_len",
    "pack_bits",
    "unpack_bits",
    "decode_spatial",
    "decode_reduction",
    "capacity_for",
    "clamp_mask_topk",
    "slot_positions",
    "active_indices",
]


def packed_len(n_bits: int) -> int:
    """Number of uint8 bytes needed to store ``n_bits`` big-endian bits."""
    return -(-n_bits // 8)


def pack_bits(mask: torch.Tensor) -> torch.Tensor:
    """Pack a bool mask (..., T) into uint8 (..., ceil(T/8)), big-endian,
    zero padded at the tail."""
    t = mask.shape[-1]
    bits = mask.to(torch.int32)
    pad = packed_len(t) * 8 - t
    if pad:
        bits = torch.nn.functional.pad(bits, (0, pad))
    bits = bits.reshape(*bits.shape[:-1], -1, 8)
    shifts = torch.arange(7, -1, -1, dtype=torch.int32, device=mask.device)
    return (bits << shifts).sum(dim=-1).to(torch.uint8)


def unpack_bits(sym: torch.Tensor, n_bits: int) -> torch.Tensor:
    """Inverse of :func:`pack_bits` -> bool mask of shape (..., n_bits)."""
    shifts = torch.arange(7, -1, -1, dtype=torch.int32, device=sym.device)
    bits = (sym.to(torch.int32)[..., :, None] >> shifts) & 1
    bits = bits.reshape(*sym.shape[:-1], -1)
    return bits[..., :n_bits].to(torch.bool)


def decode_spatial(sym: torch.Tensor, i) -> torch.Tensor:
    """Paper's spatial decoder ``F(S_c, i) = (S_c[i // 8] >> (7 - i % 8)) & 1``
    -> 0/1 (int32); ``sym``'s last dim indexes bytes, ``i`` is a block index
    (an int or an integer tensor) along the unpacked axis."""
    i = torch.as_tensor(i, dtype=torch.int64, device=sym.device)
    byte = torch.index_select(sym, -1, (i // 8).reshape(-1)).to(torch.int32)
    return ((byte >> (7 - i % 8).reshape(-1).to(torch.int32)) & 1).reshape(
        *sym.shape[:-1], *i.shape)


def decode_reduction(sym_flat: torch.Tensor, i, j, t_kv: int) -> torch.Tensor:
    """Paper's reduction decoder ``J(S_s, i, j) = F(S_s, i·T_kv + j)`` over a
    row-major packed (T_q × T_kv) bit matrix with no per-row byte padding."""
    flat = (torch.as_tensor(i, dtype=torch.int64) * t_kv
            + torch.as_tensor(j, dtype=torch.int64))
    return decode_spatial(sym_flat, flat)


def capacity_for(t: int, fraction: float, quantum: int = 8) -> int:
    """Static capacity (padded active-count) for a sparsity fraction."""
    keep = int(np.ceil(t * float(fraction)))
    keep = max(min(keep, t), 1)
    return int(min(-(-keep // quantum) * quantum, t))


def clamp_mask_topk(mask: torch.Tensor, score: torch.Tensor,
                    cap: int) -> torch.Tensor:
    """Bound the True-count of ``mask`` (last axis) by ``cap``, keeping the
    highest-``score`` entries; on equal scores the lower index wins."""
    t = mask.shape[-1]
    if cap >= t:
        return mask
    s = torch.where(mask, score.to(torch.float32),
                    torch.tensor(float("-inf"), device=mask.device))
    # Stable ascending sort of -s == descending by s, ties in index order.
    ids = torch.argsort(-s, dim=-1, stable=True)[..., :cap]
    keep = torch.zeros_like(mask).scatter_(-1, ids, True)
    return mask & keep


def slot_positions(ids: torch.Tensor, count: torch.Tensor, t: int) -> torch.Tensor:
    """Inverse of :func:`active_indices`: each of the ``t`` positions -> its
    slot in the compacted ``ids`` list (0 for positions never selected).
    Padding slots are routed to a discard column so a duplicated id can
    never overwrite a live slot assignment."""
    cap = ids.shape[-1]
    slot = torch.arange(cap, dtype=torch.int32, device=ids.device)
    sid = torch.where(slot < count[..., None], ids.to(torch.int64), t)
    scat = torch.zeros((*ids.shape[:-1], t + 1), dtype=torch.int32,
                       device=ids.device)
    scat.scatter_(-1, sid, slot.expand(sid.shape).contiguous())
    return scat[..., :t]


def active_indices(mask: torch.Tensor, capacity: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Compacted, capacity-padded index list of ``True`` positions.

    Returns ``(ids, count)``: ``ids`` (..., capacity) int32 in ascending
    order; slots past ``count`` repeat the last live id (0 when none).
    """
    t = mask.shape[-1]
    pos = torch.arange(t, dtype=torch.int64, device=mask.device)
    key = torch.where(mask, 0, 1) * t + pos           # unique keys
    order = torch.argsort(key, dim=-1)[..., :capacity]
    count = torch.clamp(mask.sum(dim=-1), max=capacity).to(torch.int32)
    slot = torch.arange(capacity, dtype=torch.int32, device=mask.device)
    last_valid = torch.gather(order, -1,
                              torch.clamp(count - 1, min=0).to(torch.int64)[..., None])
    ids = torch.where(slot < count[..., None], order, last_valid)
    return ids.to(torch.int32), count
