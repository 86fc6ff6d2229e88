"""Tensor ops and the CUDA kernel wrappers of the port: dense retrieval,
BM25 sparse scoring, fusion, MMR, LSH (the JAX package's ``ops`` exports
under the same names)."""

from hybridsearch_tpu_torch.ops.dense import (  # noqa: F401
    cosine_scores,
    dense_topk,
    l2_normalize,
    scan_dense_topk,
)
from hybridsearch_tpu_torch.ops.fusion import (  # noqa: F401
    max_normalize,
    minmax_normalize,
    rrf_fusion,
    weighted_fusion,
)
from hybridsearch_tpu_torch.ops.lsh import lsh_planes, lsh_signatures  # noqa: F401
from hybridsearch_tpu_torch.ops.mmr import mmr_select  # noqa: F401
