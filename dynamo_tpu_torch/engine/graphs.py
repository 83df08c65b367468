"""One CUDA graph per fused decode block shape: the port's counterpart of
the reference's per-width ``jax.jit`` of ``JaxEngine._multistep_impl``.

A fused block is ``w`` decode steps (forward, penalties, mask, sampling,
stop checks) of a few thousand small launches. ``BlockGraphs.run``
captures the block's body once per shape and replays it afterwards, so a
block costs the host one replay instead of the launches:

- the first call of a key warms the body up on a side stream (which also
  builds and loads the kernels: ``nvcc`` and ``cudaFuncSetAttribute`` must
  not run inside a capture), on inputs the caller made harmless (the
  engine's warm-up rows are dead, so they write only the garbage page),
  then captures it with ``torch.cuda.graph``;
- every call copies its inputs into the graph's static input buffers and
  replays; the outputs land in static output buffers that the next replay
  of the same graph overwrites, so a caller consumes them (copies or
  chains them) before that replay;
- the static buffers are ordinary allocations; only the body's
  temporaries live in the one memory pool all graphs share, and those are
  dead between replays, so graphs may replay in any order;
- the body's kernel wrappers count launches in Python, which a replay
  does not run: the counts the capture added are taken back out and added
  again at every replay.

A capture or replay that fails raises; nothing falls back to the eager
body. The body must not synchronise with the host (``.item()``, a
pageable copy) and must keep every launch shape a function of its input
shapes, which the split planners of ``ops/kernels`` are.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch

Tensors = Dict[str, torch.Tensor]


class _Captured:
    __slots__ = ("graph", "inputs", "outputs", "launches")

    def __init__(self, graph, inputs: Tensors, outputs: Tensors,
                 launches: List[Dict[str, int]]):
        self.graph = graph
        self.inputs = inputs
        self.outputs = outputs
        self.launches = launches


def shape_key(tensors: Tensors) -> tuple:
    """The shapes and dtypes of a dict of tensors, as part of a graph key."""
    return tuple((k, tuple(v.shape), v.dtype)
                 for k, v in sorted(tensors.items()))


class BlockGraphs:
    """Captured graphs of one device, keyed by the caller's static key and
    the shapes of the inputs. ``counters`` are the launch-count dicts the
    body's wrappers add to; each replay adds what its capture counted."""

    def __init__(self, device: torch.device,
                 counters: List[Dict[str, int]]):
        self.device = device
        self.counters = counters
        self.pool = torch.cuda.graph_pool_handle()
        self.graphs: Dict[tuple, _Captured] = {}
        self.replays = 0

    def __len__(self) -> int:
        return len(self.graphs)

    def run(self, key: tuple, body: Callable[[Tensors], Tensors],
            inputs: Tensors, warm: Tensors) -> Tuple[Tensors, bool]:
        """Replay the graph of ``key`` on ``inputs`` (capturing it first,
        warmed up on ``warm``, when the key is new). Returns the static
        outputs and whether this call captured."""
        key = (key, shape_key(inputs))
        cap = self.graphs.get(key)
        fresh = cap is None
        if fresh:
            cap = self._capture(body, warm)
            self.graphs[key] = cap
        for name, dst in cap.inputs.items():
            dst.copy_(inputs[name], non_blocking=True)
        cap.graph.replay()
        self.replays += 1
        for counter, delta in zip(self.counters, cap.launches):
            for k, n in delta.items():
                counter[k] += n
        return cap.outputs, fresh

    def _capture(self, body, warm: Tensors) -> _Captured:
        dev = self.device
        static = {k: torch.empty(v.shape, dtype=v.dtype, device=dev)
                  for k, v in warm.items()}
        for k, v in warm.items():
            static[k].copy_(v)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            out = body(static)
        torch.cuda.current_stream(dev).wait_stream(side)
        outputs = {k: torch.empty_like(v) for k, v in out.items()}
        del out
        before = [dict(c) for c in self.counters]
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self.pool,
                              capture_error_mode="thread_local"):
            out = body(static)
            for k, v in out.items():
                outputs[k].copy_(v)
        launches = []
        for counter, snap in zip(self.counters, before):
            launches.append({k: counter[k] - snap.get(k, 0)
                             for k in counter if counter[k] != snap.get(k, 0)})
            counter.clear()
            counter.update(snap)
        return _Captured(graph, static, outputs, launches)


__all__ = ["BlockGraphs", "shape_key"]
