"""hybridsearch_tpu_torch — the PyTorch/CUDA port of hybridsearch_tpu.

The port mirrors the JAX package's layout (``ops/``, ``index/``,
``retrieval/``, ``pipelines/``, ``services/``, ``text/``, ``models/``,
``store/``, ``utils/``) so each module's counterpart sits under the same
path. It imports ``torch`` and
numpy, never ``jax`` and never the JAX package: what it shares with that
package (configuration, tokenization, the sqlite store) is copied here.

Entry points (``Indexer``, ``Searcher``, the index classes, the pipelines
of ``create_pipeline``, ``SemanticCache``) take a ``device`` argument that
defaults to ``"cuda"``; the CPU is used only when the caller asks for it,
and without a card the default raises.

Every TPU kernel on the ported path is a CUDA C++ kernel under ``csrc/``,
built at first use by ``ops/cuda_build.py``. A kernel's wrapper launches it
for CUDA tensors and runs its plain PyTorch version only for CPU tensors.
"""

import torch

# The supertile certificate (ops/supertile.py) is sound only while the
# stats sweep (K1), the resident scores (K2) and the finalist rescore differ
# by float32 summation order alone; TF32 would round the products to ~10
# mantissa bits in some of them and not others. Pin full float32.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"


def __getattr__(name):
    # Lazy top-level exports, as the JAX package's, so that importing the
    # package stays light.
    import importlib

    lazy_map = {
        "Searcher": ("hybridsearch_tpu_torch.retrieval.searcher", "Searcher"),
        "Indexer": ("hybridsearch_tpu_torch.index.builder", "Indexer"),
        "BM25": ("hybridsearch_tpu_torch.index.sparse_index", "BM25"),
        "create_pipeline": ("hybridsearch_tpu_torch.pipelines", "create_pipeline"),
        "QueryMemory": ("hybridsearch_tpu_torch.retrieval.query_memory", "QueryMemory"),
    }
    if name in lazy_map:
        mod, attr = lazy_map[name]
        return getattr(importlib.import_module(mod), attr)
    raise AttributeError(f"module 'hybridsearch_tpu_torch' has no attribute {name!r}")
