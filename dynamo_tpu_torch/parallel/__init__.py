"""Parallelism over ranks: meshes, model shardings, the rank world.

The port of ``dynamo_tpu/parallel``. The reference hands GSPMD its mesh and
shardings and lets XLA insert the collectives; here every device is a
process (``multihost.py``: rank 0 schedules and fans each step out, the
others replay it), every rank holds its slice of the weights and the cache
(``sharding.py``), and the model forwards issue their few collectives
themselves over the mesh's process groups (``mesh.py``):

- ``mesh.py`` — the named rank mesh (axes ``dp``/``pp``/``tp``/``sp``/
  ``ep``) and its per-axis process groups;
- ``sharding.py`` — the reference's partition specs of the parameter trees
  and the paged KV cache, and each rank's slices;
- ``multihost.py`` — the world, the step fanout and the follower loop;
- ``pipeline.py`` — pipeline parallelism: layer stages over ``pp``, the
  microbatch ring and its stage handoff;
- ``ring_attention.py`` / ``ring_prefill.py`` — sequence parallelism: ring
  attention over ``sp`` (``RankMesh.rotate``) and the whole-prompt ring
  prefill that fills the paged cache.

Served: tensor parallelism (heads, FFN width and kv heads over ``tp``),
expert parallelism (experts over ``ep``), data parallelism (batch rows over
``dp``, the weights and the page pool replicated: ``mesh.DpRows``),
pipeline parallelism (layers over ``pp``, composed with ``tp`` and ``dp``:
``pipeline.py``), sequence parallelism (long prompts in one ring step over
``sp``, composed with ``tp`` and ``dp``, the weights and the page pool
replicated over ``sp``), and the KV data plane (page gathers and scatters)
on any of these worlds.
"""

from dynamo_tpu_torch.parallel.mesh import MeshSpec, make_mesh
from dynamo_tpu_torch.parallel.sharding import ModelSharding, tp_sharding

__all__ = ["MeshSpec", "make_mesh", "ModelSharding", "tp_sharding"]
