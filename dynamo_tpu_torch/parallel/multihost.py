"""Rank worlds: ONE logical worker endpoint over one process per device.

The port of ``dynamo_tpu/parallel/multihost.py``. The reference is
single-controller JAX on one host (GSPMD inserts the collectives) and
multi-controller across hosts, where rank 0 alone schedules and the other
ranks replay its steps. PyTorch has no single controller: every device is
a process, even on one host, so the reference's multi-host leader/follower
layer is the footing for every axis here, tp included:

  - ``initialize_distributed`` joins this process to the world
    (``torch.distributed.init_process_group``): world rank ``node_rank *
    local_ranks + local_rank``, device ``cuda:local_rank``, backend
    ``nccl`` on the GPU and ``gloo`` on the CPU unless the caller names
    one. It also makes the host-side fanout group (gloo), which every rank
    joins.
  - Rank 0 is the ONLY rank with a scheduler, allocator, RPC endpoint and
    model registration. Its engine taps every dispatch: immediately before
    running a step it broadcasts the step's padded host arrays (token ids,
    page tables, sampling knobs — never device state) over the fanout
    group (``StepFanout``).
  - Ranks > 0 run ``follow_steps``: receive, unpack, run the SAME step
    function on the SAME arrays (``TorchEngine.execute_arrays``); the
    model's collectives (``models/llama.py``) meet the leader's there.
  - The KV data plane's page IO rides the same stream, as the reference's
    ``"gather"`` / ``"scatter"`` kinds: a gather's page ids, a scatter's
    ids and, after its message, each rank's own slice of the values (its
    stage's layers and its heads; one ``scatter`` over the fanout group:
    no rank receives the whole window). The leader relays every outcome,
    page IO included, for the followers' cross-check.

The difference from the reference: the fanout rides the process group
(``broadcast_object_list`` on a gloo group), not the coordinator's event
bus. A follower blocked in the broadcast cannot miss a step, so there is no
subscribe race; the profiler and the tests build engines with no
coordinator; and one transport serves every backend. The multi-node
bring-up still rendezvouses through ``runtime/barrier.py``, as the
reference's worker does.

``start_local_ranks`` starts a node's follower processes (local ranks 1..n-1)
from a command line; the worker, the profiler, the tests and
``chip_smoke.py`` use it. ``python -m dynamo_tpu_torch.parallel.multihost
--engine-spec FILE --local-rank R`` is a bare engine follower (the
profiler's ranks).
"""

from __future__ import annotations

import datetime
import json
import logging
import os
import socket
import subprocess
import sys
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

logger = logging.getLogger(__name__)

# the fanout group's collective timeout: a follower waits in the broadcast
# for as long as the leader is idle
FANOUT_TIMEOUT = datetime.timedelta(days=7)


def barrier_id(namespace: str, component: str) -> str:
    """Bring-up barrier id, namespaced like the step subject — two multihost
    groups on one coordinator must never satisfy each other's barriers."""
    return f"mh-bringup/{namespace}/{component}"


def step_subject(namespace: str, component: str) -> str:
    return f"{namespace}.{component}.mh_steps"


@dataclass
class RankWorld:
    """This process's place in the world: its ranks, its device, the
    backend of the model's collectives, and the fanout group."""

    rank: int
    world: int
    local_rank: int
    device: object
    backend: str
    fanout: object = None

    @property
    def leader(self) -> bool:
        return self.rank == 0


def rendezvous_url(address: str) -> str:
    """``host:port`` -> ``tcp://host:port``; ``tcp://`` and ``file://`` URLs
    pass as they are."""
    return address if "://" in address else f"tcp://{address}"


def free_address(host: str = "127.0.0.1") -> str:
    """A rendezvous address on a port free at the time of the call."""
    with socket.socket() as s:
        s.bind((host, 0))
        return f"{host}:{s.getsockname()[1]}"


def rank_device(device, local_rank: int):
    """A rank's device: ``cuda:local_rank`` (modulo the cards there are:
    ranks beyond the count share them), or the CPU."""
    import torch

    from dynamo_tpu_torch.utils.device import resolve_device
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
    return dev


def initialize_distributed(coordinator_address: str, num_nodes: int,
                           node_rank: int,
                           local_device_count: Optional[int] = None, *,
                           local_rank: int = 0, device=None,
                           backend: Optional[str] = None,
                           timeout: Optional[datetime.timedelta] = None
                           ) -> RankWorld:
    """Join this process into the world of ``num_nodes *
    local_device_count`` ranks rendezvousing at ``coordinator_address``
    (``host:port``, or a ``tcp://`` / ``file://`` URL). The backend is
    explicit: ``backend`` when given, else ``nccl`` on the GPU and
    ``gloo`` on the CPU. ``timeout`` bounds the model's collectives
    (default: torch's)."""
    import torch
    import torch.distributed as dist

    local = int(local_device_count or 1)
    dev = rank_device(device, local_rank)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    rank = node_rank * local + local_rank
    world = num_nodes * local
    kw = {} if timeout is None else {"timeout": timeout}
    if backend == "nccl":
        kw["device_id"] = dev
    dist.init_process_group(backend, init_method=rendezvous_url(
        coordinator_address), world_size=world, rank=rank, **kw)
    fanout = dist.new_group(backend="gloo", timeout=FANOUT_TIMEOUT)
    logger.info("torch.distributed: rank %d/%d (local %d) on %s, backend %s",
                rank, world, local_rank, dev, backend)
    return RankWorld(rank=rank, world=world, local_rank=local_rank,
                     device=dev, backend=backend, fanout=fanout)


def shutdown_distributed() -> None:
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


# ---------------------------------------------------------------- wire form

def _pack_arrays(kind: str, arrays: Dict[str, np.ndarray], step: int) -> dict:
    msg = {"kind": kind, "step": int(step)}
    for name, arr in arrays.items():
        a = np.ascontiguousarray(arr)
        msg[name] = {"d": str(a.dtype), "s": list(a.shape), "b": a.tobytes()}
    return msg


def _unpack_arrays(msg: dict) -> Dict[str, np.ndarray]:
    out = {}
    for name, v in msg.items():
        if isinstance(v, dict) and "b" in v:
            out[name] = np.frombuffer(v["b"], dtype=np.dtype(v["d"])).reshape(
                v["s"])
    return out


def _broadcast(group, msg=None):
    import torch.distributed as dist
    box = [msg]
    dist.broadcast_object_list(box, src=0, group=group)
    return box[0]


def _send_shards(group, parts: List[np.ndarray]) -> None:
    """Rank 0: each rank's part of a large array (a scatter's values) to
    that rank alone, as raw bytes over the fanout group (one ``scatter``;
    every part has one size). The message that announced it carries the
    parts' dtype and shape."""
    import torch
    import torch.distributed as dist
    bufs = [torch.from_numpy(np.ascontiguousarray(p).reshape(-1).view(
        np.uint8)) for p in parts]
    out = torch.empty_like(bufs[0])
    dist.scatter(out, bufs, src=0, group=group)


def _recv_shard(group, meta: dict) -> np.ndarray:
    """A follower's part of ``_send_shards``."""
    import torch
    import torch.distributed as dist
    dtype = np.dtype(meta["d"])
    n = int(np.prod(meta["s"])) * dtype.itemsize
    buf = torch.empty(n, dtype=torch.uint8)
    dist.scatter(buf, None, src=0, group=group)
    return buf.numpy().view(dtype).reshape(meta["s"])


# ---------------------------------------------------------------- rank 0

class StepFanout:
    """Rank-0 side: engine step tap → ordered broadcast to followers.

    The tap runs in the engine's step thread and returns once the message
    is out, before the step dispatches, so the wire order is exactly the
    execution order."""

    def __init__(self, group):
        self._group = group
        # resolved (step_id, ok) outcomes not yet relayed to followers;
        # appended from the event loop (engine _process/_fail_plan), drained
        # from the step thread inside tap() — list append/swap is
        # GIL-atomic, and ordering within one producer is preserved
        self._outcomes: list = []
        self.closed = False

    def note_outcome(self, step_id, ok: bool) -> None:
        if step_id is not None:
            self._outcomes.append((int(step_id), bool(ok)))

    def tap(self, kind: str, arrays: Dict[str, np.ndarray],
            step: int, shards: Optional[List[np.ndarray]] = None) -> None:
        """Broadcast one dispatch's host arrays. ``shards`` (a page
        scatter's values, one part per world rank) follow the message,
        each part to its rank alone (``vals`` on the follower's side)."""
        msg = _pack_arrays(kind, arrays, step)
        if shards is not None:
            msg["shard"] = {"d": str(shards[0].dtype),
                            "s": list(shards[0].shape)}
        if self._outcomes:
            drained, self._outcomes = self._outcomes, []
            # piggyback resolved outcomes on the next step message so
            # followers can cross-check their own per-step results
            msg["outcomes"] = drained
        _broadcast(self._group, msg)
        if shards is not None:
            _send_shards(self._group, shards)

    def install(self, engine) -> None:
        engine.step_tap = self.tap
        engine.step_outcome_cb = self.note_outcome

    def close(self) -> None:
        """Release the followers: they return from ``follow_steps``. Call
        it from the thread that issues the steps, once none is running."""
        if not self.closed:
            self.closed = True
            _broadcast(self._group, {"kind": "stop", "step": -1})


# ---------------------------------------------------------------- rank > 0

def follow_steps(group, engine) -> None:
    """Follower loop: execute every broadcast step on the local shards,
    until the leader's ``close``. Runs in ONE thread, which issues every
    collective of this rank (the broadcasts and the model's), in the
    leader's order. ``engine`` is a full TorchEngine (same config as rank
    0) whose scheduler is simply never used."""
    consecutive_failures = 0
    my_failed_steps: Dict[int, bool] = {}
    while True:
        msg = _broadcast(group)
        # this rank's part of the message's values first: the leader waits
        # in their scatter whatever this rank does next
        shard = (_recv_shard(group, msg["shard"]) if "shard" in msg
                 else None)
        # cross-check the leader's resolved outcomes against our own: a
        # step WE failed that the LEADER completed means this rank's
        # KV/pages state silently diverged — restart the group now rather
        # than serve corrupt state. The reverse (leader failed, we
        # succeeded) is benign: only the leader holds scheduler
        # bookkeeping, device state advanced identically on all ranks.
        for step_id, leader_ok in msg.get("outcomes", []):
            if my_failed_steps.pop(step_id, False) and leader_ok:
                raise RuntimeError(
                    f"multihost divergence: leader completed step {step_id} "
                    "but this rank failed it — restarting the group")
        if msg["kind"] == "stop":
            return
        arrays = _unpack_arrays(msg)
        if shard is not None:
            arrays["vals"] = shard
        try:
            engine.execute_arrays(msg["kind"], arrays, msg["step"])
            consecutive_failures = 0
        except Exception:
            # when a step raises on ALL ranks — the common case, it's one
            # SPMD program — every rank logs and stays in lockstep for the
            # next step; the outcome cross-check above catches the
            # asymmetric case one message later.
            my_failed_steps[int(msg["step"])] = True
            consecutive_failures += 1
            if consecutive_failures >= 3:
                # persistently failing rank (dead cache, OOM): exit so the
                # orchestrator restarts the group, instead of silently
                # diverging or wedging the leader's collectives
                raise
            logger.exception("follower step %s failed; continuing in "
                             "lockstep", msg.get("step"))


# ---------------------------------------------------------------- spawning

def start_local_ranks(cmd: List[str], local_ranks: int,
                      env: Optional[dict] = None, **popen_kw
                      ) -> List[subprocess.Popen]:
    """Start this node's follower processes: ``cmd + ["--local-rank", r]``
    for r in 1..local_ranks-1 (the caller is local rank 0)."""
    procs = []
    for r in range(1, int(local_ranks)):
        procs.append(subprocess.Popen(list(cmd) + ["--local-rank", str(r)],
                                      env=env, **popen_kw))
    return procs


def stop_local_ranks(procs: List[subprocess.Popen],
                     timeout: float = 30.0) -> List[int]:
    """Wait for follower processes (a released follower exits by itself);
    terminate, then kill, those still running after ``timeout``. Returns
    their exit codes."""
    codes = []
    for p in procs:
        try:
            codes.append(p.wait(timeout=timeout))
        except subprocess.TimeoutExpired:
            p.terminate()
            try:
                codes.append(p.wait(timeout=10))
            except subprocess.TimeoutExpired:
                p.kill()
                codes.append(p.wait())
    return codes


# ---------------------------------------------------------------- engines

def build_rank_engine(model_cfg, engine_cfg, world: Optional[RankWorld],
                      mesh_spec=None, params=None, seed: int = 0,
                      device=None):
    """A ``TorchEngine`` for this rank: the mesh over the world (``mesh_spec``
    default: tp over every rank), the sharding hooks of ``ModelSharding``
    (of ``pipeline.pp_sharding_fns`` on a mesh with ``pp`` > 1: the rank's
    stage) and, without ``params``, the WHOLE tree made from ``seed`` on
    the rank's device and then sliced, so every world size serves the
    same model. Leader and followers call it alike."""
    import dataclasses

    import torch

    from dynamo_tpu_torch.engine.torch_engine import TorchEngine
    from dynamo_tpu_torch.models import get_family
    from dynamo_tpu_torch.parallel.mesh import MeshSpec, make_mesh
    from dynamo_tpu_torch.parallel.sharding import ModelSharding

    dev = world.device if world is not None else rank_device(device, 0)
    if world is not None and world.world > 1:
        mesh = make_mesh(mesh_spec or MeshSpec(tp=world.world))
        if mesh.shape["pp"] > 1:
            from dynamo_tpu_torch.parallel.pipeline import pp_sharding_fns
            shard_params, shard_pages = pp_sharding_fns(mesh, model_cfg,
                                                        device=dev)
        else:
            shard = ModelSharding(model_cfg, mesh, device=dev)
            shard_params, shard_pages = shard.shard_params, shard.shard_pages
        engine_cfg = dataclasses.replace(
            engine_cfg, mesh=mesh, shard_params_fn=shard_params,
            shard_pages_fn=shard_pages)
    if params is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        params = get_family(model_cfg).init_params(model_cfg, gen,
                                                   device=dev)
    return TorchEngine(model_cfg, params, engine_cfg, device=dev)


def engine_spec(model_cfg, engine_cfg, address: str, world: int,
                backend: Optional[str], device, mesh_spec=None,
                seed: int = 0) -> dict:
    """The JSON description a bare engine follower builds from: the same
    model, engine sizes, mesh and seed as the leader's."""
    import dataclasses
    ecfg = {f.name: getattr(engine_cfg, f.name)
            for f in dataclasses.fields(engine_cfg)
            if f.name not in ("mesh", "shard_params_fn", "shard_pages_fn")}
    return {"model": dataclasses.asdict(model_cfg), "engine": ecfg,
            "address": address, "world": int(world), "backend": backend,
            "device": None if device is None else str(device),
            "mesh": None if mesh_spec is None else mesh_spec.shape(),
            "seed": int(seed)}


def _engine_follower_main(spec: dict, local_rank: int) -> None:
    from dynamo_tpu_torch.engine.torch_engine import TorchEngineConfig
    from dynamo_tpu_torch.models.config import ModelConfig
    from dynamo_tpu_torch.parallel.mesh import MeshSpec

    world = initialize_distributed(
        spec["address"], 1, 0, spec["world"], local_rank=local_rank,
        device=spec["device"], backend=spec["backend"])
    try:
        engine = build_rank_engine(
            ModelConfig(**spec["model"]), TorchEngineConfig(**spec["engine"]),
            world, MeshSpec.from_dict(spec["mesh"]) if spec["mesh"] else None,
            seed=spec["seed"])
        follow_steps(world.fanout, engine)
    finally:
        shutdown_distributed()


def main(argv: Optional[List[str]] = None) -> None:
    import argparse
    p = argparse.ArgumentParser(
        description="bare TorchEngine follower rank (see engine_spec)")
    p.add_argument("--engine-spec", required=True,
                   help="JSON file written by the leader (engine_spec)")
    p.add_argument("--local-rank", type=int, required=True)
    args = p.parse_args(argv)
    with open(args.engine_spec) as f:
        spec = json.load(f)
    _engine_follower_main(spec, args.local_rank)


if __name__ == "__main__":
    logging.basicConfig(level=os.environ.get("DYN_LOG", "WARNING").upper(),
                        stream=sys.stderr)
    main()


__all__ = ["initialize_distributed", "StepFanout", "follow_steps",
           "step_subject", "barrier_id", "RankWorld", "start_local_ranks",
           "stop_local_ranks", "build_rank_engine", "engine_spec",
           "free_address", "rank_device", "shutdown_distributed"]
