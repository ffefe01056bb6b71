"""Multi-device (mesh) execution for catch_tpu_torch.

Port of catch_tpu/parallel/.  What catch_tpu spreads over a
jax.sharding.Mesh runs here over a Mesh of places (parallel/mesh.py):

- the span scan's verification: the candidate pairs in contiguous
  blocks, one per place, each verified against that place's replica of
  the corpus and probe rows (ops/scan_sparse.verify_spans_sharded);
- the design scan: sample ranges (stages A and B) and candidate blocks
  (stage C) per place, joined on the lead (ops/scan_instance);
- the greedy set-cover solve: the sets in contiguous blocks, the
  coverage state replicated, the pick merged across places every step
  (parallel/set_cover.py).

Clustering and the near-duplicate filter are not spread, as in
catch_tpu.  A mesh across processes (parallel/distributed.py, the port
of catch_tpu/parallel/distributed.py) spans every rank's places: each
rank scans the whole design on its own places, and the span scan's
verification and the sharded solve exchange across ranks through
host-staged gloo collectives.  NCCL and distinct cards are not run
(ROADMAP queue 1, item 4).
"""

from catch_tpu_torch.parallel.distributed import maybe_initialize
from catch_tpu_torch.parallel.mesh import Mesh, make_mesh
from catch_tpu_torch.parallel.set_cover import solve_instance_sharded

__all__ = ["Mesh", "make_mesh", "maybe_initialize", "solve_instance_sharded"]
