"""Named rank meshes over ``torch.distributed``.

The port of ``dynamo_tpu/parallel/mesh.py``. The axis convention and order
are the reference's (any subset may be 1):

- ``dp``  — data parallel: model replicas, each running its rows of the
  batch (``DpRows``), one page pool replicated over them;
- ``pp``  — pipeline parallel: layer stages, each handing its
  activation to the next (``RankMesh.send_next``);
- ``tp``  — tensor parallel: attention heads / MLP columns over ranks;
- ``sp``  — sequence/context parallel: ring attention over the sequence;
- ``ep``  — expert parallel: MoE experts over ranks.

The reference's mesh is an array of devices driven by one controller, and
GSPMD lays its collectives onto the axes. PyTorch has no single controller:
every device is a process, so a mesh here is a RANK's view of the world —
its coordinates on each axis, and one process group per set of axes its
model's collectives run over (``group``). The rank order is the
reference's device order: ``rank = ((((dp * PP + pp) * TP + tp) * SP + sp)
* EP + ep)``, the innermost axes varying fastest.

A mesh made without a process group (``RankMesh(spec, rank)``) carries the
coordinates only: ``parallel/sharding.py`` slices parameters with it, and
the tests hold those slices against the reference's shards with no process
started. ``make_mesh`` makes the groups once the world is up.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Dict, Iterable, Optional, Tuple

import torch

AXES = ("dp", "pp", "tp", "sp", "ep")


@dataclass(frozen=True)
class MeshSpec:
    """Logical mesh shape; unspecified axes default to 1."""

    dp: int = 1
    pp: int = 1
    tp: int = 1
    sp: int = 1
    ep: int = 1

    @property
    def size(self) -> int:
        return self.dp * self.pp * self.tp * self.sp * self.ep

    def shape(self) -> Dict[str, int]:
        return {"dp": self.dp, "pp": self.pp, "tp": self.tp, "sp": self.sp,
                "ep": self.ep}

    @classmethod
    def from_dict(cls, d: Dict[str, int]) -> "MeshSpec":
        unknown = set(d) - set(AXES)
        if unknown:
            raise ValueError(f"unknown mesh axes {sorted(unknown)}")
        return cls(**{k: int(v) for k, v in d.items()})


def rank_coords(spec: MeshSpec, rank: int) -> Dict[str, int]:
    """A rank's coordinate on every axis (the innermost axis fastest)."""
    out = {}
    for axis in reversed(AXES):
        n = getattr(spec, axis)
        out[axis] = rank % n
        rank //= n
    return {a: out[a] for a in AXES}


def coords_rank(spec: MeshSpec, coords: Dict[str, int]) -> int:
    rank = 0
    for axis in AXES:
        rank = rank * getattr(spec, axis) + coords.get(axis, 0)
    return rank


class RankMesh:
    """One rank's view of a mesh: ``shape`` (the reference's ``mesh.shape``
    dict), this rank's ``coords``, and the process groups its collectives
    use, keyed by the axes they span (``group("tp")``, ``group("tp",
    "ep")``). A group over axes whose sizes multiply to 1 is None: no
    collective is issued there."""

    def __init__(self, spec: MeshSpec, rank: int = 0,
                 groups: Optional[Dict[Tuple[str, ...], object]] = None,
                 backend: Optional[str] = None):
        if not 0 <= rank < spec.size:
            raise ValueError(f"rank {rank} is outside mesh {spec.shape()}")
        self.spec = spec
        self.rank = rank
        self.shape = spec.shape()
        self.coords = rank_coords(spec, rank)
        self.backend = backend
        self._groups = dict(groups or {})

    @property
    def size(self) -> int:
        return self.spec.size

    def axis_size(self, *axes: str) -> int:
        n = 1
        for a in axes:
            n *= self.shape[a]
        return n

    def group(self, *axes: str):
        """The process group over ``axes`` containing this rank; None when
        those axes have one rank in all."""
        key = tuple(a for a in AXES if a in axes and self.shape[a] > 1)
        if not key:
            return None
        try:
            return self._groups[key]
        except KeyError:
            raise RuntimeError(
                f"mesh {self.shape} has no process group over {key}: "
                "make it with make_mesh once the world is up") from None

    def all_reduce(self, x: torch.Tensor, *axes: str, op=None) -> torch.Tensor:
        """Sum (or ``op``) ``x`` in place over the ranks of ``axes``; at one
        rank nothing is issued."""
        g = self.group(*axes)
        if g is None:
            return x
        import torch.distributed as dist
        dist.all_reduce(x, op=op or dist.ReduceOp.SUM, group=g)
        return x

    def all_gather(self, x: torch.Tensor, axis: str,
                   dim: int = -1) -> torch.Tensor:
        """``x`` of every rank along ``axis``, concatenated on ``dim`` in
        coordinate order; at one rank ``x`` itself."""
        g = self.group(axis)
        if g is None:
            return x
        import torch.distributed as dist
        n = self.shape[axis]
        if x.is_cuda and self.backend == "gloo":
            # gloo gathers no CUDA tensor; it sums them: each rank's block
            # in place, zeros elsewhere, summed (exact: x + 0 == x)
            dim = dim % x.dim()
            shape = list(x.shape)
            shape[dim] *= n
            full = torch.zeros(shape, dtype=x.dtype, device=x.device)
            full.narrow(dim, self.coords[axis] * x.shape[dim],
                        x.shape[dim]).copy_(x)
            dist.all_reduce(full, group=g)
            return full
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(n)]
        dist.all_gather(parts, x, group=g)
        return torch.cat(parts, dim=dim)

    def send_next(self, x: torch.Tensor, axis: str = "pp") -> torch.Tensor:
        """The reference's ``lax.ppermute`` over ``axis`` with pairs ``(i,
        i + 1)``: ``x`` goes to the rank one coordinate on, and the value
        the rank one coordinate back sent is returned (zeros at coordinate
        0, as ``ppermute`` leaves a rank no pair sends to)."""
        return self._ppermute(x, axis, wrap=False)

    def rotate(self, x: torch.Tensor, axis: str = "sp") -> torch.Tensor:
        """The reference's ``lax.ppermute`` over ``axis`` with wrap-around
        pairs ``(j, (j + 1) % n)``: as ``send_next``, with the last
        coordinate sending to coordinate 0; at one rank ``x`` itself."""
        return self._ppermute(x, axis, wrap=True)

    def _ppermute(self, x: torch.Tensor, axis: str,
                  wrap: bool) -> torch.Tensor:
        """One hop along ``axis``: each rank sends ``x`` one coordinate on
        and returns what the rank one coordinate back sent; without
        ``wrap`` the last coordinate sends nothing and coordinate 0
        receives zeros. Every rank of the axis calls it together. Over
        NCCL one batched send / receive; gloo takes no send of a CUDA
        tensor, so there the axis gathers every rank's ``x`` (the
        ``all_gather`` above) and each rank keeps its predecessor's."""
        g = self.group(axis)
        if g is None:
            return x if wrap else torch.zeros_like(x)
        import torch.distributed as dist
        c, n = self.coords[axis], self.shape[axis]
        x = x.contiguous()
        has_prev = wrap or c > 0
        if self.backend != "nccl":
            full = self.all_gather(x[None], axis, dim=0)
            return full[(c - 1) % n] if has_prev else torch.zeros_like(x)
        out = torch.zeros_like(x)

        def peer(j):
            return coords_rank(self.spec, dict(self.coords, **{axis: j % n}))

        ops = []
        if wrap or c + 1 < n:
            ops.append(dist.P2POp(dist.isend, x, peer(c + 1), group=g))
        if has_prev:
            ops.append(dist.P2POp(dist.irecv, out, peer(c - 1), group=g))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return out

    def __repr__(self) -> str:
        return f"RankMesh({self.shape}, rank={self.rank})"


class DpRows:
    """One rank's rows of a batch split over ``dp``: rows ``lo:lo+rows``
    of the padded batch, the rank's coordinate on ``dp`` times its share.

    The reference shards the batch over ``dp`` with GSPMD and keeps the
    page pool replicated over it; the pool stays replicated here because
    every replica writes EVERY row's new K/V (``ops.attention.
    write_kv_rows``): each layer's new rows are gathered over ``dp``
    before the cache write, with the whole batch's page table, positions
    and new-token counts. The table is the step's (every rank holds the
    whole host arrays); positions and counts are given for a step and
    gathered once per forward for a fused block, whose carry is per
    rank."""

    def __init__(self, mesh: RankMesh, rows: int, table: torch.Tensor,
                 positions: Optional[torch.Tensor] = None,
                 new_lens: Optional[torch.Tensor] = None):
        self.mesh = mesh
        self.rows = rows
        self.lo = mesh.coords["dp"] * rows
        self.table = table
        self._pos = positions
        self._new = new_lens

    @staticmethod
    def split(mesh: Optional[RankMesh], batch: int) -> bool:
        """Does ``dp`` split a padded batch of ``batch`` rows? A batch dp
        does not divide runs replicated, as the reference's
        ``_shard_batch`` leaves it."""
        if mesh is None:
            return False
        dp = mesh.shape["dp"]
        return dp > 1 and batch % dp == 0

    def local(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a whole-batch tensor."""
        return x[self.lo:self.lo + self.rows]

    def gather(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Every replica's rows of ``x``, in batch order."""
        return self.mesh.all_gather(x.contiguous(), "dp", dim)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the replicas (a drop count)."""
        return self.mesh.all_reduce(x.clone(), "dp")

    def write_args(self, positions: torch.Tensor, new_lens: torch.Tensor):
        """(table, positions, new_lens) of the whole batch, for the cache
        write; this rank's ``positions`` / ``new_lens`` are gathered with
        the other replicas' on first use when the step did not give
        them."""
        if self._pos is None:
            both = self.gather(torch.cat(
                [positions.to(torch.int32),
                 new_lens.to(torch.int32)[:, None]], dim=1))
            self._pos, self._new = both[:, :-1], both[:, -1]
        return self.table, self._pos, self._new


def _axis_sets(spec: MeshSpec) -> Iterable[Tuple[str, ...]]:
    """Every non-empty set of axes of size > 1, in one fixed order (every
    rank must create the same groups in the same order)."""
    live = [a for a in AXES if getattr(spec, a) > 1]
    for n in range(1, len(live) + 1):
        yield from itertools.combinations(live, n)


def make_mesh(spec: Optional[MeshSpec] = None) -> RankMesh:
    """This rank's mesh over the running ``torch.distributed`` world (a
    world of one when none is running), with the reference's axis order
    and size check: the mesh spans the whole world. Every rank calls this
    at the same point of its set-up, since making a group is a collective
    of the whole world."""
    import torch.distributed as dist
    up = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if up else 1
    spec = spec or MeshSpec(tp=world)
    if spec.size != world:
        raise ValueError(
            f"mesh spec {spec.shape()} needs {spec.size} devices, "
            f"have {world}")
    rank = dist.get_rank() if up else 0
    groups: Dict[Tuple[str, ...], object] = {}
    for axes in _axis_sets(spec):
        fixed = [a for a in AXES if a not in axes]
        for base in itertools.product(
                *(range(getattr(spec, a)) for a in fixed)):
            ranks = []
            for free in itertools.product(
                    *(range(getattr(spec, a)) for a in axes)):
                c = dict(zip(fixed, base))
                c.update(zip(axes, free))
                ranks.append(coords_rank(spec, c))
            g = dist.new_group(sorted(ranks))
            if rank in ranks:
                groups[axes] = g
    return RankMesh(spec, rank, groups,
                    dist.get_backend() if up else None)


__all__ = ["MeshSpec", "RankMesh", "DpRows", "make_mesh", "rank_coords",
           "AXES"]
