"""Collective matmul: overlap a tensor-parallel all-gather with the
products, port of ``repro.distributed.collective_matmul`` (Wang et al.,
"Overlap communication with computation": the 1-D ring pipeline).

The plain form of a TP matmul on ``x`` sharded on the sequence is

    all_gather(x) @ W        (the link idle while the products wait, then the reverse)

This one splits the all-gather into ``P`` ring steps and multiplies the
resident shard while the next one is in flight:

    for step in range(P):
        y[owner] = x_shard @ W
        x_shard = ring_shift(x_shard)      # to rank + 1, from rank - 1
        owner = (owner - 1) % P

Each step posts the send of the resident shard to the next rank and the
receive from the previous one (``dist.batch_isend_irecv``), launches the
product and then waits for the transfer.

Transport.  On NCCL the card tensors go to the ring as they are.  Gloo's
point-to-point ops take CPU tensors only, so on a gloo group a card shard is
staged through the host explicitly: copied to a host buffer before its
send, and the received host buffer copied back to the card.  The products
always run on the shards' device; the product of one step runs on the card
while the host moves the next shard.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["ag_matmul_overlapped"]


def ag_matmul_overlapped(x_shard: torch.Tensor, w: torch.Tensor, group=None) -> torch.Tensor:
    """``y = all_gather(x, seq) @ w``, pipelined over the ranks of ``group``
    (the world when ``None``).

    x_shard: this rank's ``(B, S/P, D)``, the sequence block ``rank``;
    w: ``(D, F)``, the same on every rank.  Returns ``(B, S, F)`` on every
    rank: each rank multiplies every shard as it passes through the ring,
    writing the product of shard ``owner`` at rows ``owner · S/P``."""
    group = group if group is not None else dist.group.WORLD
    p = dist.get_world_size(group)
    idx = dist.get_rank(group)
    nxt = dist.get_global_rank(group, (idx + 1) % p)
    prv = dist.get_global_rank(group, (idx - 1) % p)
    b, s_loc, _ = x_shard.shape
    dtype = torch.promote_types(x_shard.dtype, w.dtype)
    out = torch.empty((b, s_loc * p, w.shape[-1]), dtype=dtype, device=x_shard.device)
    staged = x_shard.device.type != "cpu" and dist.get_backend(group) == "gloo"
    shard = x_shard.contiguous()
    host = shard.cpu() if staged else shard          # what goes on the wire
    owner = idx
    for step in range(p):
        reqs, recv = [], None
        if step < p - 1:                             # the last shard goes nowhere
            recv = torch.empty_like(host)
            reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, host, nxt, group),
                                           dist.P2POp(dist.irecv, recv, prv, group)])
        out[:, owner * s_loc:(owner + 1) * s_loc] = shard @ w
        for r in reqs:
            r.wait()
        if recv is not None:
            host = recv
            shard = recv.to(x_shard.device, non_blocking=True) if staged else recv
        owner = (owner - 1) % p
    return out
