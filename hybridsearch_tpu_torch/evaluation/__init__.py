"""Search-quality evaluation (the port of ``hybridsearch_tpu/evaluation``):
metrics, the fp64 NumPy oracle, the evaluator, BEIR loading and the
in-repo multilingual and OOD-English evals. Host code over the port's
searcher, BM25 and encoders."""

from hybridsearch_tpu_torch.evaluation.metrics import (  # noqa: F401
    precision_at_k,
    recall_at_k,
    f1_at_k,
    mrr,
    ndcg_at_k,
    latency_percentiles,
)
from hybridsearch_tpu_torch.evaluation import oracle  # noqa: F401
