"""KVBM: the multi-tier KV block manager, on ``TorchEngine``.

The port of ``dynamo_tpu/kvbm/``:

- **G1 (HBM)** is the engine's paged device cache + ``PageAllocator`` LRU.
- **G2 (host RAM)** and **G3 (disk)** are byte-budgeted LRU pools of block
  payloads keyed by chained block hash (``tiers.py``; bfloat16 blocks
  ride as their uint16 bits, files are the reference's raw bytes).
- **Offload** is event-driven: the allocator's eviction hook gathers the
  evicted pages on the steps' stream before they are reused, and a spill
  thread copies the snapshot to pinned host memory on a CUDA stream of its
  own. Host-pool overflow demotes G2 -> G3.
- **Onboard** is pipelined lookahead (``prefetch.py``): the first prefill
  chunk's blocks inject synchronously so admission's prefix match sees
  them, and the rest stream in pinned ahead of the chunked-prefill cursor
  through ``engine/transfer.InjectPipeline``. Every onboard writes the
  cache in place.
- **G4 (remote)** is the disagg block-transfer plane itself
  (``worker/disagg.py``): peers' caches are reachable by the same hashes.
"""

from dynamo_tpu_torch.kvbm.manager import TieredEngine, TieredKvConfig
from dynamo_tpu_torch.kvbm.prefetch import (PrefetchScheduler,
                                            prefetch_depth_bytes)
from dynamo_tpu_torch.kvbm.tiers import DiskTier, HostTier

__all__ = ["TieredEngine", "TieredKvConfig", "HostTier", "DiskTier",
           "PrefetchScheduler", "prefetch_depth_bytes"]
