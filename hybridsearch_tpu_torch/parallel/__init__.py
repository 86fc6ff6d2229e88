"""The mesh: one process a rank over ``torch.distributed``
(``parallel/mesh.py``) and the collective retrieval programs over its data
axis (``parallel/collectives.py``)."""

from hybridsearch_tpu_torch.parallel.mesh import (  # noqa: F401
    build_mesh,
    doc_sharding,
    replicated_sharding,
)
from hybridsearch_tpu_torch.parallel.collectives import (  # noqa: F401
    sharded_dense_topk,
    sharded_hybrid_topk,
    sharded_supertile_topk,
)
