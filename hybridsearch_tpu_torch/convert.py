"""Carry the JAX package's parameters and index state into the port.

Every function takes plain numpy arrays (and Python scalars), as read out
of a ``hybridsearch_tpu`` index, and returns the port's object on the
chosen device. With them a test builds both packages on identical state:
the ``HashingEncoder`` table and the semantic cache's LSH planes
(``jax.random`` bits the port's generator cannot repeat), the dense
snapshot, the BM25 CSR state, the supertile postings, the impact tier, and
the clustered permutation of the corpus, the int8 copy of a corpus.

On a mesh the JAX package stacks every shard's arrays on a leading axis
([S, ...], read out as numpy); the ``sharded_*`` functions take those
stacks and a mesh and return this rank's shard in the port's form (the
dense snapshot is global in both packages and is cut by ``dense_index``).
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Union

import numpy as np
import torch
from torch import nn

from hybridsearch_tpu_torch.config import EngineConfig
from hybridsearch_tpu_torch.index.builder import Indexer
from hybridsearch_tpu_torch.index.dense_index import DenseIndex
from hybridsearch_tpu_torch.index.ivf import IVFIndex
from hybridsearch_tpu_torch.index.sparse_index import BM25, _DeltaSeg
from hybridsearch_tpu_torch.models.encoder import HashingEncoder
from hybridsearch_tpu_torch.ops.bm25 import ShardedBM25Postings, postings_from_csr
from hybridsearch_tpu_torch.ops.impact import ImpactPostings
from hybridsearch_tpu_torch.ops.supertile import ShardedSuperPostings, SuperPostings
from hybridsearch_tpu_torch.text.extractor import HashVocabulary, Vocabulary
from hybridsearch_tpu_torch.utils.device import DeviceLike, resolve_device


def hashing_encoder(table: np.ndarray, seed: int = 42, bigram_weight: float = 0.5,
                    max_tokens: int = 256, device: DeviceLike = None) -> HashingEncoder:
    """HashingEncoder whose bucket table is ``table`` [n_buckets, dim]."""
    n_buckets, dim = table.shape
    enc = HashingEncoder(dim=dim, n_buckets=n_buckets, seed=seed,
                         bigram_weight=bigram_weight, max_tokens=max_tokens,
                         device=device)
    enc.table = torch.from_numpy(np.array(table, dtype=np.float32))
    return enc


def dense_index(docs: np.ndarray, bias: np.ndarray, n: int,
                capacity_round: int = 4096, device: DeviceLike = None,
                mesh=None) -> DenseIndex:
    """DenseIndex adopting a snapshot: ``docs`` [capacity, D] L2-normalized
    rows, ``bias`` [capacity] 0 / -inf, ``n`` rows assigned. On a mesh the
    arrays are the whole (gathered) snapshot and this rank keeps its
    ``capacity / shards`` rows."""
    idx = DenseIndex(dim=docs.shape[1], capacity_round=capacity_round,
                     device=device, mesh=mesh)
    docs_t = torch.from_numpy(np.array(docs, dtype=np.float32))
    bias_t = torch.from_numpy(np.array(bias, dtype=np.float32))
    if mesh is None:
        idx.load_snapshot(docs_t, bias_t, int(n))
        return idx
    from hybridsearch_tpu_torch.index.dense_index import _Snapshot

    lo, rows = idx._rows(docs.shape[0])
    idx._snap = _Snapshot(docs_t[lo:lo + rows].to(idx.device),
                          bias_t[lo:lo + rows].to(idx.device), int(n), docs.shape[0])
    idx.deleted_count = int((bias_t[:int(n)] == float("-inf")).sum())
    return idx


def bm25_index(vocab: Union[np.ndarray, Sequence[str]], indptr: np.ndarray,
               doc_ids: np.ndarray, weights: np.ndarray, n_docs: int,
               k1: float = 1.5, b: float = 0.75, delta: float = 1.0,
               device: DeviceLike = None, tf_cache: Optional[tuple] = None,
               frozen: Optional[tuple] = None,
               delta_seg: Optional[tuple] = None) -> BM25:
    """BM25 holding a fitted CSR state. ``vocab`` is the uint64 token hashes
    of a HashVocabulary (ids in order) or the token strings of a
    Vocabulary; ``indptr`` [V+1], ``doc_ids``/``weights`` [>= nnz] and
    ``n_docs`` are the main postings'.

    Given the JAX state's ``tf_cache`` (t, d, c, doc_lens) and ``frozen``
    (df, avg_len, len_sum), the index adds in O(delta) as the JAX one does;
    without them it is a loaded index, whose next add refits. A pending
    ``delta_seg`` is ((t, d, c, doc_lens), indptr, doc_ids, weights) of the
    JAX ``_DeltaSeg``; the state then counts its docs too."""
    bm = BM25(k1=k1, b=b, delta=delta, device=device)
    voc = _vocab(vocab)
    postings = postings_from_csr(indptr, doc_ids, weights, n_docs, len(indptr) - 1,
                                 bm.device)
    seg, total = None, int(n_docs)
    if delta_seg is not None:
        tf, d_indptr, d_ids, d_ws = delta_seg
        total += len(tf[3])
        seg = _DeltaSeg(tf=tf, postings=postings_from_csr(
            d_indptr, d_ids, d_ws, total, len(d_indptr) - 1, bm.device))
    bm.set_state(voc, postings, total, tf_cache=tf_cache, frozen=frozen,
                 delta_seg=seg)
    return bm


def sharded_bm25_postings(indptr_s: np.ndarray, doc_ids_s: np.ndarray,
                          weights_s: np.ndarray, n_docs: int, docs_per_shard: int,
                          mesh) -> ShardedBM25Postings:
    """This rank's shard of a JAX ``ShardedBM25Postings`` (``indptr``
    [S, V+1], ``doc_ids`` / ``weights`` [S, nnz_pad])."""
    r = mesh.data_index
    ip = np.asarray(indptr_s, np.int64)
    runs = np.diff(ip, axis=1)  # [S, V]
    return ShardedBM25Postings(
        indptr=torch.from_numpy(ip[r].copy()).to(mesh.device),
        doc_ids=torch.from_numpy(np.array(doc_ids_s[r], np.int32)).to(mesh.device),
        weights=torch.from_numpy(np.array(weights_s[r], np.float32)).to(mesh.device),
        n_docs=int(n_docs), docs_per_shard=int(docs_per_shard),
        max_postings=max(1, int(runs.max()) if runs.size else 1),
        vocab_size=ip.shape[1] - 1, n_shards=ip.shape[0], shard=r,
        starts_host=ip[r, :-1].copy(), lengths_host=runs[r].copy(),
        max_run_host=runs.max(axis=0))


def sharded_bm25_index(vocab, indptr_s: np.ndarray, doc_ids_s: np.ndarray,
                       weights_s: np.ndarray, n_docs: int, docs_per_shard: int,
                       mesh, k1: float = 1.5, b: float = 0.75,
                       delta: float = 1.0) -> BM25:
    """BM25 on ``mesh`` holding this rank's shard of a JAX sharded fit
    (``vocab`` as in ``bm25_index``). Its sharded supertile structures come
    from ``attach_sharded_super_postings``."""
    from hybridsearch_tpu_torch.index.sparse_index import _BM25State

    bm = BM25(k1=k1, b=b, delta=delta, mesh=mesh)
    bm.docs_per_shard = int(docs_per_shard)
    sh = sharded_bm25_postings(indptr_s, doc_ids_s, weights_s, n_docs,
                               docs_per_shard, mesh)
    bm._state = _BM25State(_vocab(vocab), None, int(n_docs),
                           np.append(sh.max_run_host, 0), sharded=sh)
    return bm


def sharded_super_postings(sup_max_s: np.ndarray, sup_pos_s: np.ndarray,
                           ids_rows_s: np.ndarray, ws_rows_s: np.ndarray,
                           docs_per_shard: int, n_docs: int, super_tiles: int,
                           df_host: np.ndarray, win_max_host: np.ndarray,
                           mesh) -> ShardedSuperPostings:
    """This rank's shard of a JAX ``ShardedSuperPostings``."""
    r, dev = mesh.data_index, mesh.device

    def t(a, dtype):
        return torch.from_numpy(np.array(a[r], dtype=dtype)).to(dev)

    return ShardedSuperPostings(
        sup_max=t(sup_max_s, np.float32), sup_pos=t(sup_pos_s, np.int32),
        ids_rows=t(ids_rows_s, np.int32), ws_rows=t(ws_rows_s, np.float32),
        docs_per_shard=int(docs_per_shard), n_docs=int(n_docs),
        super_tiles=int(super_tiles), n_shards=len(sup_max_s), shard=r,
        df_host=np.asarray(df_host, np.int64),
        win_max_host=np.asarray(win_max_host, np.int64))


def attach_sharded_super_postings(bm: BM25, ssp: ShardedSuperPostings) -> None:
    """Serve ``ssp`` as the sharded supertile structures of ``bm``'s
    current state."""
    bm._super_shard_cache = (bm._state, ssp)


def sharded_ivf_index(centroids_s: np.ndarray, docs_perm_s: np.ndarray,
                      chunk_starts_s: np.ndarray, chunk_lens_s: np.ndarray,
                      perm_to_orig_s: np.ndarray, chunk_cap: int, n_docs: int,
                      mesh, nprobe: int = 8,
                      storage_dtype: torch.dtype = torch.float32) -> IVFIndex:
    """IVFIndex on ``mesh`` holding this rank's chunks of a JAX sharded IVF
    (``[S, chunks_pad, D]`` centroids, ``[S, rows_pad, D]`` rows, ``[S,
    chunks_pad]`` starts and lengths, ``[S, rows_pad]`` global doc ids);
    ``storage_dtype`` as in ``ivf_index``."""
    r, dev = mesh.data_index, mesh.device
    return IVFIndex(dim=docs_perm_s.shape[-1], nprobe=nprobe, mesh=mesh,
                    storage_dtype=storage_dtype).load_arrays(
        torch.from_numpy(np.array(centroids_s[r], np.float32)),
        torch.from_numpy(np.array(docs_perm_s[r], np.float32)).to(dev, storage_dtype),
        *(torch.from_numpy(np.asarray(a[r], np.int64))
          for a in (chunk_starts_s, chunk_lens_s, perm_to_orig_s)),
        chunk_cap, n_docs)


def _vocab(vocab):
    """A HashVocabulary of uint64 token hashes, or a Vocabulary of tokens."""
    vocab_arr = np.asarray(vocab)
    if vocab_arr.dtype == np.uint64:
        return HashVocabulary.from_hashes(vocab_arr.tolist())
    voc = Vocabulary()
    for tok in vocab_arr.tolist():
        voc.add(str(tok))
    return voc


def super_postings(sup_max: np.ndarray, sup_pos: np.ndarray, ids_rows: np.ndarray,
                   ws_rows: np.ndarray, n_docs: int, n_super: int, super_tiles: int,
                   starts_host: np.ndarray, df_host: np.ndarray,
                   win_max_host: np.ndarray, device: DeviceLike = None) -> SuperPostings:
    """SuperPostings from the JAX build's arrays."""
    dev = resolve_device(device)

    def t(a, dtype):
        return torch.from_numpy(np.array(a, dtype=dtype)).to(dev)

    return SuperPostings(
        sup_max=t(sup_max, np.float32), sup_pos=t(sup_pos, np.int32),
        ids_rows=t(ids_rows, np.int32), ws_rows=t(ws_rows, np.float32),
        n_docs=int(n_docs), n_super=int(n_super), super_tiles=int(super_tiles),
        starts_host=np.asarray(starts_host, np.int64),
        df_host=np.asarray(df_host, np.int64),
        win_max_host=np.asarray(win_max_host, np.int64))


def attach_super_postings(bm: BM25, sp: SuperPostings) -> None:
    """Serve ``sp`` as the supertile structures of ``bm``'s current state."""
    bm._super_cache = (bm._state, sp)


def impact_postings(doc_ids: np.ndarray, weights: np.ndarray, n_docs: int,
                    p_max: int, starts_host: np.ndarray, lengths_host: np.ndarray,
                    slack_host: np.ndarray, weights_host: np.ndarray,
                    df_host: np.ndarray, device: DeviceLike = None) -> ImpactPostings:
    """ImpactPostings from the JAX build's arrays (built with align=1, the
    JAX package's alignment off the TPU)."""
    dev = resolve_device(device)
    return ImpactPostings(
        doc_ids=torch.from_numpy(np.array(doc_ids, dtype=np.int32)).to(dev),
        weights=torch.from_numpy(np.array(weights, dtype=np.float32)).to(dev),
        n_docs=int(n_docs), p_max=int(p_max),
        starts_host=np.asarray(starts_host, np.int64),
        lengths_host=np.asarray(lengths_host, np.int64),
        slack_host=np.asarray(slack_host, np.float32),
        weights_host=np.asarray(weights_host, np.float32),
        df_host=np.asarray(df_host, np.int64))


def attach_impact_postings(bm: BM25, imp: ImpactPostings) -> None:
    """Serve ``imp`` as the impact tier of ``bm``'s current state."""
    bm._impact_cache = (bm._state, imp.p_max, imp)


def ivf_index(centroids_per_chunk: np.ndarray, docs_perm: np.ndarray,
              chunk_starts: np.ndarray, chunk_lens: np.ndarray,
              perm_to_orig: np.ndarray, chunk_cap: int, n_docs: int,
              nprobe: int = 8, device: DeviceLike = None,
              storage_dtype: torch.dtype = torch.float32) -> IVFIndex:
    """IVFIndex holding a JAX ``IVFIndex``'s single-device arrays: the
    per-chunk centroids [n_chunks, D], the cluster-ordered rows [rows, D]
    (with at least ``chunk_cap`` rows past the last chunk), the chunks'
    starts and lengths, each row's doc id (-1 pad) and the chunk width.
    The rows of a ``storage_dtype=jnp.bfloat16`` index come as float32
    arrays (numpy has no bfloat16; the values are bfloat16-exact) and are
    stored in ``storage_dtype`` again."""
    dev = resolve_device(device)
    return IVFIndex(dim=docs_perm.shape[1], nprobe=nprobe, device=dev,
                    storage_dtype=storage_dtype).load_arrays(
        torch.from_numpy(np.array(centroids_per_chunk, np.float32)),
        torch.from_numpy(np.array(docs_perm, np.float32)).to(dev, storage_dtype),
        *(torch.from_numpy(np.asarray(a, np.int64))
          for a in (chunk_starts, chunk_lens, perm_to_orig)),
        chunk_cap, n_docs)


def int8_corpus(d8: np.ndarray, scale: np.ndarray, tile_resid: np.ndarray,
                device: DeviceLike = None):
    """The JAX ``quantize_corpus_int8`` triple (d8 [N, D] int8, scale [N],
    tile_resid [n_tiles]) as the port's tensors on the device, for
    ``ops/dense.py`` ``int8_swept_topk``."""
    dev = resolve_device(device)
    return (torch.from_numpy(np.array(d8, np.int8)).to(dev),
            torch.from_numpy(np.array(scale, np.float32)).to(dev),
            torch.from_numpy(np.array(tile_resid, np.float32)).to(dev))


def lsh_planes(planes: np.ndarray, device: DeviceLike = None) -> torch.Tensor:
    """The JAX ``lsh_planes`` draw ([n_tables * n_bits, dim], threefry bits
    the port's generator cannot repeat) as a float32 tensor on the device,
    for ``SemanticCache(planes=...)`` and ``ops/lsh.py``."""
    return torch.from_numpy(np.array(planes, dtype=np.float32)).to(
        resolve_device(device))


def indexer(contents: Sequence[str], encoder: HashingEncoder, dense: DenseIndex,
            bm: BM25, config: Optional[EngineConfig] = None,
            perm: Optional[np.ndarray] = None, db_path: str = ":memory:") -> Indexer:
    """Indexer over carried state. ``contents`` are the docs in index
    order, or in source order with ``perm`` the clustered permutation
    (index row i holds source doc perm[i]). It runs on ``dense``'s mesh
    when it has one."""
    docs = list(contents) if perm is None else [contents[i] for i in perm]
    idx = Indexer(db_path=db_path, encoder=encoder, config=config,
                  device=dense.device, mesh=dense.mesh)
    idx.dense, idx.bm25 = dense, bm
    idx.doc_ids = idx.store.replace_documents(docs)
    idx.contents = docs
    return idx


# Flax leaf name -> torch parameter name
_FLAX_LEAF = {"kernel": "weight", "scale": "weight", "embedding": "weight",
              "bias": "bias"}


def bert_state(flat: Mapping[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """State dict of a ``models/bert.py`` module from flat Flax arrays keyed
    ``"params/<module path>/<leaf>"``: Flax ``[in, out]`` kernels transposed
    into ``nn.Linear``'s ``[out, in]``, LayerNorm scales and embedding
    tables as the modules' weights."""
    out = {}
    for key, arr in flat.items():
        path = key.split("/")
        if path[0] == "params":
            path = path[1:]
        *mods, leaf = path
        a = np.array(arr, dtype=np.float32)
        if leaf == "kernel":
            a = np.ascontiguousarray(a.T)
        out[".".join(mods + [_FLAX_LEAF[leaf]])] = torch.from_numpy(a)
    return out


def bert_flat(module: nn.Module) -> Dict[str, np.ndarray]:
    """The inverse of ``bert_state``: flat float32 numpy arrays in the
    ``hst_params.npz`` layout."""
    out = {}
    for name, sub in module.named_modules():
        base = "params/" + name.replace(".", "/")
        if isinstance(sub, nn.Linear):
            out[base + "/kernel"] = sub.weight.detach().float().cpu().numpy().T.copy()
            out[base + "/bias"] = sub.bias.detach().float().cpu().numpy()
        elif isinstance(sub, nn.Embedding):
            out[base + "/embedding"] = sub.weight.detach().float().cpu().numpy()
        elif isinstance(sub, nn.LayerNorm):
            out[base + "/scale"] = sub.weight.detach().float().cpu().numpy()
            out[base + "/bias"] = sub.bias.detach().float().cpu().numpy()
    return out


def adamw_state(count, mu: Mapping[str, np.ndarray],
                nu: Mapping[str, np.ndarray]) -> dict:
    """An ``optax.adamw`` state (its ``ScaleByAdamState``: ``count``, and
    the moments ``mu`` and ``nu`` as flat Flax arrays keyed like
    ``bert_state``'s input) as a trainer's ``opt_state``: the moments by
    state-dict name, kernels transposed as their parameters are. Assigned
    with the carried parameters, a JAX train state takes its next step in
    the port."""
    return {"count": int(np.asarray(count)), "mu": bert_state(mu), "nu": bert_state(nu)}
