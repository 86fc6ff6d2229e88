"""Carry the JAX package's parameters and index state into the port.

Every function takes plain numpy arrays (and Python scalars), as read out
of a ``hybridsearch_tpu`` index, and returns the port's object on the
chosen device. With them a test builds both packages on identical state:
the ``HashingEncoder`` table (``jax.random`` bits the port's generator
cannot repeat), the dense snapshot, the BM25 CSR state, the supertile
postings, the impact tier, and the clustered permutation of the corpus.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Union

import numpy as np
import torch
from torch import nn

from hybridsearch_tpu_torch.config import EngineConfig
from hybridsearch_tpu_torch.index.builder import Indexer
from hybridsearch_tpu_torch.index.dense_index import DenseIndex
from hybridsearch_tpu_torch.index.sparse_index import BM25, _DeltaSeg
from hybridsearch_tpu_torch.models.encoder import HashingEncoder
from hybridsearch_tpu_torch.ops.bm25 import postings_from_csr
from hybridsearch_tpu_torch.ops.impact import ImpactPostings
from hybridsearch_tpu_torch.ops.supertile import SuperPostings
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
                capacity_round: int = 4096, device: DeviceLike = None) -> DenseIndex:
    """DenseIndex adopting a snapshot: ``docs`` [capacity, D] L2-normalized
    rows, ``bias`` [capacity] 0 / -inf, ``n`` rows assigned."""
    idx = DenseIndex(dim=docs.shape[1], capacity_round=capacity_round,
                     device=device)
    idx.load_snapshot(torch.from_numpy(np.array(docs, dtype=np.float32)),
                      torch.from_numpy(np.array(bias, dtype=np.float32)), int(n))
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
    vocab_arr = np.asarray(vocab)
    if vocab_arr.dtype == np.uint64:
        voc = HashVocabulary.from_hashes(vocab_arr.tolist())
    else:
        voc = Vocabulary()
        for tok in vocab_arr.tolist():
            voc.add(str(tok))
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


def indexer(contents: Sequence[str], encoder: HashingEncoder, dense: DenseIndex,
            bm: BM25, config: Optional[EngineConfig] = None,
            perm: Optional[np.ndarray] = None, db_path: str = ":memory:") -> Indexer:
    """Indexer over carried state. ``contents`` are the docs in index
    order, or in source order with ``perm`` the clustered permutation
    (index row i holds source doc perm[i])."""
    docs = list(contents) if perm is None else [contents[i] for i in perm]
    idx = Indexer(db_path=db_path, encoder=encoder, config=config,
                  device=dense.device)
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
