"""Typed configuration tree for the engine (copy of hybridsearch_tpu/config.py).

The reference scatters configuration across constructor kwargs (SURVEY §5.6;
reference core.py:118, core.py:229-230, bm25.py:19-35, pipelines.py:445-455,
pipelines.py:521). Here everything lives in one serializable dataclass tree
that is also written into index manifests.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Optional


@dataclass
class MeshConfig:
    """Device mesh layout. `data` shards the document axis; `model` shards
    encoder weights (tensor parallel) during training/encoding."""

    data_axis: str = "data"
    model_axis: str = "model"
    # -1 = use all available devices on the data axis.
    data_parallel: int = -1
    model_parallel: int = 1


@dataclass
class ModelConfig:
    """Encoder configuration. `kind` selects the implementation:
    - "hashing": deterministic offline hashing encoder (no pretrained weights)
    - "minilm": MiniLM-class transformer (models/minilm.py)
    Reference defaults: all-MiniLM-L6-v2, 384-dim (core.py:118).
    """

    kind: str = "hashing"
    name: str = "all-MiniLM-L6-v2"
    dim: int = 384
    max_seq_len: int = 256
    vocab_size: int = 30522
    num_layers: int = 6
    num_heads: int = 12
    hidden_dim: int = 384
    mlp_dim: int = 1536
    dtype: str = "bfloat16"
    # Cross-encoder (reranker) counterpart (reference reranker.py:19).
    cross_encoder_name: str = "ms-marco-MiniLM-L-6-v2"


@dataclass
class BM25Config:
    """BM25 parameters (reference bm25.py:19-35)."""

    k1: float = 1.5
    b: float = 0.75
    delta: float = 1.0  # BM25+ only (reference bm25.py:160-179)
    variant: str = "bm25"  # "bm25" | "bm25plus"


@dataclass
class FusionConfig:
    """Hybrid fusion weights; must sum to 1.0 (reference core.py:229-233)."""

    semantic_weight: float = 0.7
    lexical_weight: float = 0.3


@dataclass
class FunnelConfig:
    """Multi-stage retrieval funnel 100 -> 20 -> 5 (reference pipelines.py:445-455)."""

    stage1_k: int = 100
    stage2_k: int = 20
    final_k: int = 5


@dataclass
class CacheConfig:
    """Semantic cache (reference api.py:117, semantic_cache.py)."""

    similarity_threshold: float = 0.95
    ttl_seconds: float = 3600.0
    max_entries: int = 10000
    lsh_tables: int = 10
    lsh_bits: int = 8


@dataclass
class IndexConfig:
    """Device index layout. Capacity is padded so incremental adds don't
    recompile; tombstones support deletes with periodic compaction."""

    dim: int = 384
    block_n: int = 4096  # doc-block size for the dense query sweep
    capacity_round: int = 4096  # capacity rounded up to a multiple of this
    # storage order: "source" keeps input order; "clustered" permutes the
    # corpus by k-means cluster at full-reindex time so similar docs share
    # 128-doc tiles (tile-budgeted dense probes + tighter certificates)
    layout: str = "source"
    dtype: str = "float32"  # embedding storage dtype on device
    max_postings: int = 0  # 0 = derive from corpus (max df)
    # approximate mode: "flat" (exact), "ivf" (k-means coarse quantizer,
    # index/ivf.py), or "auto" (flat below the measured exact<->IVF
    # crossover, IVF above it — Indexer._want_ivf). IVF accelerates
    # stage-1 retrieval at very large N.
    ann: str = "flat"
    ivf_clusters: int = 0  # 0 = sqrt(N)
    ivf_nprobe: int = 8
    ivf_chunk_cap: int = 0  # 0 = 4N/clusters (IVF list slice width)


@dataclass
class PerfConfig:
    """Serving-kernel levers of the supertile ladder, under the JAX
    package's key names, so a JAX-written config selects the same route.
    The port reads no environment variable for them.

      * ``scores_dedup``: resident scores from pairs sorted by supertile
        before the launch (kernel K4 ``super_scores_dedup``) instead of
        K2's in-launch pair sort, when B*S % 8 == 0. None means off, as the
        JAX package with its env gate unset;
      * ``place_fused``: resident lexical buffers read straight from the
        CSR (kernel K5 ``place_fused``) instead of staged windows + K3.
        None means the card's route: K5 where the corpus is on the card
        and K5's plan fits a supertile's buffer, else the staged windows;
        True forces K5 (an error where no plan fits), False forces the
        staged windows + K3.

    Every choice gives the same results bit for bit. The JAX package's
    other five keys (``dedup_mxu``, ``pallas_tpb``, ``tile_stats_sub``,
    ``place_tlhs``, ``place_skip``) pick among TPU compiler layouts and
    block shapes of one result; the card's kernels have no such choices,
    so those keys are ignored on load."""

    place_fused: Optional[bool] = None
    scores_dedup: Optional[bool] = None


@dataclass
class ServingConfig:
    """API-layer serving behavior.

    `dynamic_batching` coalesces concurrent /search requests into ONE
    batched device dispatch (api/batching.py): the device serializes
    programs, so N concurrent single-query dispatches queue behind each
    other while a single [N]-query program costs barely more than one.
    The reference serves strictly one request at a time (reference
    api.py:272). Continuous-batching policy: an idle engine dispatches a
    lone request immediately (no added latency); arrivals during an
    in-flight batch form the next batch."""

    dynamic_batching: bool = True
    # hard cap on one coalesced dispatch; also the largest pad bucket
    max_batch: int = 64
    # a request older than this in the queue fails with 503 (the engine
    # is not keeping up) instead of waiting forever
    queue_timeout_s: float = 30.0
    # supertile-ladder certification effort: stop escalating once the
    # uncertified tail of a batch is <= this fraction (chip, B=1024/10M:
    # deeper rungs closed ~1 query each at a dispatch + round trip per
    # rung). 0.0 = certify-or-exhaust (quality harnesses).
    uncertified_tol: float = 0.005


@dataclass
class EngineConfig:
    mesh: MeshConfig = field(default_factory=MeshConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    bm25: BM25Config = field(default_factory=BM25Config)
    fusion: FusionConfig = field(default_factory=FusionConfig)
    funnel: FunnelConfig = field(default_factory=FunnelConfig)
    cache: CacheConfig = field(default_factory=CacheConfig)
    index: IndexConfig = field(default_factory=IndexConfig)
    perf: PerfConfig = field(default_factory=PerfConfig)
    serving: ServingConfig = field(default_factory=ServingConfig)
    # MMR diversity lambda (reference pipelines.py:521).
    mmr_lambda: float = 0.5
    # Dedup threshold (reference api.py:124).
    dedup_threshold: float = 0.9

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "EngineConfig":
        return cls.from_dict(json.loads(text))

    @classmethod
    def from_dict(cls, d: dict) -> "EngineConfig":
        def build(tp, val):
            if dataclasses.is_dataclass(tp) and isinstance(val, dict):
                fields = {f.name: f.type for f in dataclasses.fields(tp)}
                kwargs = {}
                for k, v in val.items():
                    if k not in fields:
                        continue
                    ft = fields[k]
                    sub = _TYPE_MAP.get(k)
                    kwargs[k] = build(sub, v) if sub is not None else v
                return tp(**kwargs)
            return val

        return build(cls, d)


_TYPE_MAP = {
    "mesh": MeshConfig,
    "model": ModelConfig,
    "bm25": BM25Config,
    "fusion": FusionConfig,
    "funnel": FunnelConfig,
    "cache": CacheConfig,
    "index": IndexConfig,
    "perf": PerfConfig,
    "serving": ServingConfig,
}
