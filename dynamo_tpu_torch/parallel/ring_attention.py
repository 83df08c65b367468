"""Ring attention: sequence parallelism over the ``sp`` axis of a rank world.

The port of ``dynamo_tpu/parallel/ring_attention.py``. The reference runs
inside ``shard_map``: every device holds one sequence shard of q, k, v,
the positions and the validity mask, computes flash-style online softmax
against the K/V shard it holds, and hands that shard one hop round the
ring (``lax.ppermute``) for ``n`` iterations (blockwise / ring attention,
Liu et al. 2023). Here every device is a process: ``ring_attention`` is
one rank's shard and the hop is ``RankMesh.rotate``.

Numerics are the reference's: float32 scores and running (num, den, max)
state, masked scores at ``NEG_INF``, rows with no visible key yet
contributing zero, the division clamping ``den`` at ``1e-20`` and the
result cast to q's dtype. Two freedoms, neither changing a value beyond
the order of a matmul's sums: K/V go round the ring at their kv heads
and each query head group reads its kv head in place (the reference
repeats them to the query heads first, sending ``Hq / Hkv`` times the
bytes), and the query shard runs in blocks of ``Q_BLOCK`` rows (each
row's scores are its own), which bounds the float32 score block. The
last hop of the reference's loop carries nothing read: it is not made.
The matrix products are ``torch.einsum``, as the reference leaves them to
XLA outside any Pallas kernel.

``ring_self_attention`` is the full-array wrapper: it cuts the sequence
over ``sp`` (and the heads over ``head_axis``), runs this rank's shard and
gathers the result, so every rank returns the whole array.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30
# query rows per score block: at Llama-3.2-3B's 24 heads and a 4096-key
# shard one block's float32 scores are 24 x 1024 x 4096 x 4 B = 403 MB
Q_BLOCK = 1024


def _block_attend(qg: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  q_pos: torch.Tensor, kv_pos: torch.Tensor,
                  kv_valid: torch.Tensor, sm_scale: float):
    """One query shard against one kv shard: the partials ``(num [B, H,
    Sq, D], den [B, H, Sq], mx [B, H, Sq], live [B, H, Sq])``.

    qg: [B, Sq, Hkv, G, D] (query head ``n * G + g`` reads kv head ``n``);
    k/v: [B, Sk, Hkv, D]; q_pos [B, Sq]; kv_pos / kv_valid [B, Sk]."""
    B, Sq, Hkv, G, D = qg.shape
    kf, vf = k.float(), v.float()
    k_pos = kv_pos[:, None, None, None, :]              # [B, 1, 1, 1, Sk]
    k_pad = ~kv_valid[:, None, None, None, :]
    parts = []
    for r0 in range(0, Sq, Q_BLOCK):
        r1 = min(Sq, r0 + Q_BLOCK)
        # the block's causal and validity mask, [B, 1, 1, q, Sk]: the
        # working set grows with Q_BLOCK x Sk, not Sq x Sk
        hidden = (k_pos > q_pos[:, None, None, r0:r1, None]) | k_pad
        s = torch.einsum("bqngd,bknd->bngqk", qg[:, r0:r1].float(), kf)
        s.mul_(sm_scale).masked_fill_(hidden, NEG_INF)
        mx = s.amax(dim=-1)                             # [B, Hkv, G, q]
        # rows with no visible kv yet: mx = NEG_INF; zero their share
        live = mx > NEG_INF / 2
        s.sub_(mx[..., None]).exp_().masked_fill_(~live[..., None], 0.0)
        num = torch.einsum("bngqk,bknd->bngqd", s, vf)
        parts.append((num, s.sum(dim=-1), mx, live))
    num, den, mx, live = (torch.cat(x, dim=3) for x in zip(*parts))
    H = Hkv * G
    return (num.reshape(B, H, Sq, D), den.reshape(B, H, Sq),
            mx.reshape(B, H, Sq), live.reshape(B, H, Sq))


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   q_pos: torch.Tensor, kv_pos: torch.Tensor,
                   kv_valid: Optional[torch.Tensor] = None,
                   sm_scale: Optional[float] = None, *, mesh,
                   axis: str = "sp", return_partials: bool = False):
    """Causal self-attention with the kv sequence sharded over the ring
    of ``mesh``'s ``axis`` (``parallel/mesh.RankMesh``).

    Shapes are this rank's shard: q [B, Sq, Hq, D], k/v [B, Sk, Hkv, D],
    q_pos [B, Sq], kv_pos / kv_valid [B, Sk]. Every rank of the axis calls
    it together. Returns [B, Sq, Hq, D] in q's dtype, or with
    ``return_partials`` the un-normalised online-softmax state ``(num [B,
    Hq, Sq, D], den [B, Hq, Sq], mx [B, Hq, Sq])`` for merging with the
    partials of another context (the cached pages of a prefix-hit ring
    prefill)."""
    B, Sq, Hq, D = q.shape
    Hkv = k.shape[2]
    if sm_scale is None:
        sm_scale = D ** -0.5
    if kv_valid is None:
        kv_valid = torch.ones(kv_pos.shape, dtype=torch.bool,
                              device=kv_pos.device)
    n = mesh.shape[axis]
    qg = q.reshape(B, Sq, Hkv, Hq // Hkv, D)
    q_pos = q_pos.long()
    dev = q.device
    num = torch.zeros((B, Hq, Sq, D), dtype=torch.float32, device=dev)
    den = torch.zeros((B, Hq, Sq), dtype=torch.float32, device=dev)
    mx = torch.full((B, Hq, Sq), NEG_INF, dtype=torch.float32, device=dev)
    # what goes round the ring: the K/V shard, and its positions and
    # validity as one int32 array
    kv = torch.stack([k, v])
    meta = torch.stack([kv_pos.to(torch.int32), kv_valid.to(torch.int32)])
    for hop in range(n):
        pnum, pden, pmx, plive = _block_attend(
            qg, kv[0], kv[1], q_pos, meta[0].long(), meta[1].bool(),
            sm_scale)
        new_mx = torch.maximum(mx, pmx)
        # rescale both accumulators to the new max; dead partials give 0
        old_scale = torch.where(mx > NEG_INF / 2, torch.exp(mx - new_mx),
                                0.0)
        p_scale = torch.where(plive, torch.exp(pmx - new_mx), 0.0)
        num = num * old_scale[..., None] + pnum * p_scale[..., None]
        den = den * old_scale + pden * p_scale
        mx = new_mx
        if hop + 1 < n:
            kv = mesh.rotate(kv, axis)
            meta = mesh.rotate(meta, axis)
    if return_partials:
        return num, den, mx
    out = num / torch.clamp(den, min=1e-20)[..., None]   # [B, Hq, Sq, D]
    return out.transpose(1, 2).to(q.dtype)


def ring_self_attention(mesh, q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor, positions: torch.Tensor,
                        kv_valid: Optional[torch.Tensor] = None,
                        sm_scale: Optional[float] = None, axis: str = "sp",
                        head_axis: Optional[str] = None,
                        return_partials: bool = False):
    """Full-array wrapper: this rank's sequence shard of q/k/v [B, S, H, D]
    and positions / ``kv_valid`` [B, S] (S must divide by the axis size),
    and with ``head_axis`` its heads' shard too (attention is head-local;
    an axis absent from the mesh or of size 1 is ignored), through
    ``ring_attention``; the result gathered over both axes, so every rank
    returns the whole array (the reference's ``out_specs``): [B, S, Hq, D],
    or the partials ``(num [B, Hq, S, D], den [B, Hq, S], mx [B, Hq,
    S])``."""
    if kv_valid is None:
        kv_valid = torch.ones(positions.shape, dtype=torch.bool,
                              device=positions.device)
    if head_axis is not None and mesh.shape.get(head_axis, 1) <= 1:
        head_axis = None
    n, c = mesh.shape[axis], mesh.coords[axis]
    S = q.shape[1]
    if S % n:
        raise ValueError(f"sequence length {S} not divisible by "
                         f"{axis}={n}")
    seq = slice(c * (S // n), (c + 1) * (S // n))
    q, k, v = q[:, seq], k[:, seq], v[:, seq]
    if head_axis is not None:
        t, j = mesh.shape[head_axis], mesh.coords[head_axis]
        hq, hkv = q.shape[2] // t, k.shape[2] // t
        q = q[:, :, j * hq:(j + 1) * hq]
        k = k[:, :, j * hkv:(j + 1) * hkv]
        v = v[:, :, j * hkv:(j + 1) * hkv]
    pos = positions[:, seq]
    out = ring_attention(q, k, v, pos, pos, kv_valid[:, seq],
                         sm_scale=sm_scale, mesh=mesh, axis=axis,
                         return_partials=return_partials)

    def whole(x, seq_dim, head_dim):
        x = mesh.all_gather(x.contiguous(), axis, dim=seq_dim)
        if head_axis is not None:
            x = mesh.all_gather(x.contiguous(), head_axis, dim=head_dim)
        return x

    if return_partials:
        num, den, mx = out
        return whole(num, 2, 1), whole(den, 2, 1), whole(mx, 2, 1)
    return whole(out, 1, 2)


__all__ = ["ring_attention", "ring_self_attention", "NEG_INF", "Q_BLOCK"]
