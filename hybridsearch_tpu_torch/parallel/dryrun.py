"""Start a world of ranks, and the mesh dry run.

``launch`` spawns ``world`` processes (``torch.multiprocessing``, spawn),
initializes the default process group in each through a file store (no
TCP port to pick, so parallel test workers cannot collide), runs
``fn(rank, world, *args)`` and hands every rank's return value back to the
parent through a file (the arguments reach the ranks through a file
too). A rank that raises stops the world and the parent raises. The ranks
run on the CPU unless ``device="cuda"``: then rank r takes card
r % device_count, so ranks share a card when there are more ranks than
cards (gloo only: NCCL refuses two ranks on one device). ``start``
returns at once, so the caller can work while the world runs, and
``World.join`` collects it.

``dryrun_multichip`` is the JAX package's
``__graft_entry__.dryrun_multichip``: first its training half
(``_dryrun_training``: one ``ContrastiveTrainer`` step on a tiny trunk
over a (data, model) mesh, the model axis 2 when the rank count is even,
and a finite loss), then its retrieval half: on an n-rank mesh, the
hybrid, BM25, IVF and supertile programs are held to their single-device
results (``_dryrun_retrieval``), then a sharded dense top-k over 1M docs is
timed (``_dryrun_sharded_throughput``).

    python -m hybridsearch_tpu_torch.parallel.dryrun --ranks 4
"""

from __future__ import annotations

import argparse
import datetime
import os
import pickle
import shutil
import tempfile
import time
from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _child(rank: int, fn: Callable, world: int, backend: str, workdir: str,
           threads: int, device: str, timeout_s: float) -> None:
    torch.set_num_threads(threads)
    with open(os.path.join(workdir, "args.pkl"), "rb") as f:
        args = pickle.load(f)
    if device == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method="file://" + os.path.join(workdir, "store"),
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout_s))
    try:
        out = fn(rank, world, *args)
        with open(os.path.join(workdir, f"rank_{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


class World:
    """A started world of ranks (``start``); ``join`` waits for it and
    returns the ranks' return values in rank order."""

    def __init__(self, ctx, workdir: str, world: int, own: bool) -> None:
        self.ctx, self.workdir, self.world, self.own = ctx, workdir, world, own

    def stop(self) -> None:
        """End every rank still running (a caller that fails before
        ``join``)."""
        for proc in self.ctx.processes:
            if proc.is_alive():
                proc.terminate()
            proc.join()
        if self.own:
            shutil.rmtree(self.workdir, ignore_errors=True)

    def join(self) -> List[Any]:
        try:
            while not self.ctx.join():  # raises when a rank fails
                pass
            out = []
            for r in range(self.world):
                with open(os.path.join(self.workdir, f"rank_{r}.pkl"), "rb") as f:
                    out.append(pickle.load(f))
            return out
        finally:
            if self.own:
                shutil.rmtree(self.workdir, ignore_errors=True)


def start(fn: Callable, world: int, args: Sequence = (), backend: str = "gloo",
          device: str = "cpu", workdir: Optional[str] = None, threads: int = 1,
          timeout_s: float = 600.0) -> World:
    """Spawn ``world`` ranks of a fresh default process group running
    ``fn(rank, world, *args)`` and return at once; the caller goes on with
    other work and calls ``join``. ``fn`` must be a module-level function
    of an importable module (the children import it); ``workdir`` (made,
    and removed by ``join``, when None) holds the file store, the
    arguments and the results."""
    own = workdir is None
    workdir = os.path.abspath(workdir or tempfile.mkdtemp(prefix="hst_world_"))
    os.makedirs(workdir, exist_ok=True)
    store = os.path.join(workdir, "store")
    if os.path.exists(store):
        os.remove(store)
    with open(os.path.join(workdir, "args.pkl"), "wb") as f:
        pickle.dump(tuple(args), f)
    ctx = mp.spawn(_child, args=(fn, world, backend, workdir, threads, device,
                                 timeout_s), nprocs=world, join=False)
    return World(ctx, workdir, world, own)


def launch(fn: Callable, world: int, args: Sequence = (), backend: str = "gloo",
           device: str = "cpu", workdir: Optional[str] = None, threads: int = 1,
           timeout_s: float = 600.0) -> List[Any]:
    """``start`` and ``join``: the ranks' return values in rank order."""
    return start(fn, world, args, backend, device, workdir, threads,
                 timeout_s).join()


# -- the dry run ----------------------------------------------------------------

_DOCS = [
    "machine learning trains models on data",
    "deep neural networks learn hierarchical features",
    "the stock market closed higher this quarter",
    "pasta recipes with garlic and olive oil",
    "tpu systolic arrays multiply matrices fast",
    "transformers encode sentences into vectors",
    "gradient descent optimizes the training loss",
    "central banks adjust interest rates",
    "tomato basil soup simmered slowly",
    "sharded indexes merge candidates over the interconnect",
    "sparse retrieval scores only matching postings",
    "semantic caches answer repeated queries instantly",
]


def _dryrun_retrieval(mesh) -> dict:
    """The serving programs on the mesh against the single-device path:
    the exact collective hybrid, sharded BM25 top-k, the sharded IVF at
    full probe against exact search, and the sharded supertile program at
    full probe (which must certify) against a plain fused reference."""
    from hybridsearch_tpu_torch.index.ivf import IVFIndex
    from hybridsearch_tpu_torch.index.sparse_index import BM25
    from hybridsearch_tpu_torch.models.encoder import HashingEncoder
    from hybridsearch_tpu_torch.ops.dense import l2_normalize
    from hybridsearch_tpu_torch.ops.supertile import (
        build_super_postings_sharded,
        encode_super_queries_sharded,
    )
    from hybridsearch_tpu_torch.parallel.collectives import sharded_supertile_topk
    from hybridsearch_tpu_torch.parallel.mesh import doc_sharding, shard_count
    from hybridsearch_tpu_torch.retrieval.searcher import Searcher

    dev = mesh.device
    enc = HashingEncoder(dim=128, device=dev)
    plain = Searcher(encoder=enc, use_query_memory=False, device=dev)
    plain.indexer.index_documents(_DOCS)
    meshy = Searcher(encoder=enc, use_query_memory=False, mesh=mesh)
    meshy.indexer.index_documents(_DOCS)
    queries = ("machine learning training", "cooking pasta soup")
    for q in queries:
        a = plain.search(q, top_k=5, log=False)
        b = meshy.search(q, top_k=5, log=False)  # sharded_hybrid_topk
        assert [r[2] for r in a] == [r[2] for r in b], (q, a, b)
        np.testing.assert_allclose([r[0] for r in a], [r[0] for r in b],
                                   rtol=1e-4, atol=1e-5)
    single_bm25 = BM25(device=dev).fit(_DOCS)
    mesh_bm25 = BM25(mesh=mesh).fit(_DOCS)  # sharded_bm25_topk
    for q in queries:
        assert mesh_bm25.search(q, top_k=3) == single_bm25.search(q, top_k=3), q

    rng = np.random.default_rng(3)
    vecs = rng.standard_normal((256, 64)).astype(np.float32)
    ivf = IVFIndex(dim=64, n_clusters=8, mesh=mesh).build(vecs)
    qs = vecs[:4] + 0.01 * rng.standard_normal((4, 64)).astype(np.float32)
    _, got = ivf.search(qs, 5, nprobe=10**9)
    v = torch.from_numpy(vecs)
    want = torch.topk(l2_normalize(torch.from_numpy(qs)) @ l2_normalize(v).T, 5).indices
    for b in range(4):
        assert set(got[b].tolist()) == set(want[b].tolist()), b

    n, V = 2048, 60
    S = shard_count(mesh)
    per = -(-(-(-n // S)) // 128) * 128
    tl, dl, wl = [], [], []
    for t in range(V):
        df = int(rng.integers(1, 80))
        tl.append(np.full(df, t))
        dl.append(np.sort(rng.choice(n, size=df, replace=False)))
        wl.append(rng.exponential(1.0, df).astype(np.float32))
    t_ids, d_ids, w = (np.concatenate(x) for x in (tl, dl, wl))
    ssp = build_super_postings_sharded(t_ids, d_ids, w, n, V, docs_per_shard=per,
                                       n_shards=S, shard=mesh.data_index,
                                       device=dev, super_tiles=2)
    docs = l2_normalize(torch.from_numpy(
        rng.standard_normal((n, 64)).astype(np.float32)))
    docs_pad = torch.cat([docs, docs.new_zeros((per * S - n, 64))])
    term_lists = [list(rng.choice(V, size=3, replace=False)) for _ in range(3)]
    enc_s = encode_super_queries_sharded(ssp, term_lists)
    sq = l2_normalize(torch.from_numpy(rng.standard_normal((3, 64)).astype(np.float32)))
    vals, idxs, exact = sharded_supertile_topk(
        mesh, sq.to(dev), doc_sharding(mesh).local(docs_pad), ssp.sup_max,
        ssp.sup_pos, ssp.ids_rows, ssp.ws_rows, enc_s, k=5, semantic_weight=0.7,
        lexical_weight=0.3, s_probe=ssp.sup_max.shape[-1], valid_n=n, n_alive=n,
        super_tiles=2)
    assert bool(exact.all()), "full probing must certify"
    sem = sq @ docs.T
    lex = torch.zeros((3, n))
    for b, terms in enumerate(term_lists):
        for t in terms:
            m = t_ids == t
            lex[b].index_add_(0, torch.from_numpy(d_ids[m]), torch.from_numpy(w[m]))

    def norm(x):
        mn, mx = x.amin(1, keepdim=True), x.amax(1, keepdim=True)
        return torch.where(mx - mn > 1e-12, (x - mn) / (mx - mn).clamp_min(1e-12),
                           torch.ones_like(x))

    ref = torch.topk(0.7 * norm(sem) + 0.3 * norm(lex), 5)
    np.testing.assert_allclose(vals.cpu().numpy(), ref.values.numpy(), rtol=1e-4,
                               atol=1e-5)
    return {"hybrid": True, "bm25": True, "ivf": True, "supertile": True}


def _dryrun_sharded_throughput(mesh, n_docs: int = 1_000_000, dim: int = 128,
                               batch: int = 64, k: int = 10, iters: int = 3) -> dict:
    """Timed sharded dense top-k over ``n_docs`` docs: each rank draws its
    own rows (seeded by shard), the program runs once to warm and then
    ``iters`` times. Returns qps and ms a step on this mesh's devices."""
    from hybridsearch_tpu_torch.parallel.collectives import sharded_dense_topk
    from hybridsearch_tpu_torch.parallel.mesh import shard_count

    S = shard_count(mesh)
    per = -(-n_docs // (128 * S)) * 128
    rng = np.random.default_rng(11 + mesh.data_index)
    docs = rng.standard_normal((per, dim)).astype(np.float32)
    lo = mesh.data_index * per
    docs[max(0, min(per, n_docs - lo)):] = 0.0
    docs /= np.maximum(np.linalg.norm(docs, axis=1, keepdims=True), 1e-9)
    docs_dev = torch.from_numpy(docs).to(mesh.device)
    q = np.random.default_rng(12).standard_normal((batch, dim)).astype(np.float32)
    q = torch.from_numpy(q / np.linalg.norm(q, axis=1, keepdims=True)).to(mesh.device)
    vals, _ = sharded_dense_topk(mesh, q, docs_dev, k, valid_n=n_docs)
    acc = float(vals.sum())
    t0 = time.perf_counter()
    for i in range(iters):
        v, _ = sharded_dense_topk(mesh, torch.roll(q, i + 1, 0), docs_dev, k,
                                  valid_n=n_docs)
        acc += float(v.sum())
    dt = time.perf_counter() - t0
    assert np.isfinite(acc)
    return {"n_docs": n_docs, "shards": S, "batch": batch,
            "qps": batch * iters / dt, "ms_per_step": dt / iters * 1e3}


def _dryrun_training(world: int, device: str) -> dict:
    """One contrastive step with data and tensor parallelism: a mesh with
    the model axis 2 when ``world`` is even, the tiny trunk of the JAX dry
    run (vocab 512, hidden 64, 2 layers, 4 heads, MLP 128), a batch of
    ``max(8, 2 * n_data)`` rows rounded to the data axis, seq 16. Returns
    the mesh's shape and the loss, which must be finite."""
    from hybridsearch_tpu_torch.models.bert import BertConfig
    from hybridsearch_tpu_torch.parallel.mesh import build_mesh
    from hybridsearch_tpu_torch.training.contrastive import ContrastiveTrainer

    n_model = 2 if world % 2 == 0 else 1
    n_data = world // n_model
    mesh = build_mesh(n_data=n_data, n_model=n_model, device=device)
    cfg = BertConfig(vocab_size=512, hidden_dim=64, num_layers=2, num_heads=4,
                     mlp_dim=128, max_position=64)
    trainer = ContrastiveTrainer(cfg=cfg, mesh=mesh)
    rng = np.random.default_rng(0)
    B, L = max(8, n_data * 2), 16
    B = -(-B // n_data) * n_data
    batch = (rng.integers(0, 512, (B, L)).astype(np.int32), np.ones((B, L), np.int32),
             rng.integers(0, 512, (B, L)).astype(np.int32), np.ones((B, L), np.int32))
    loss = trainer.train_step(batch)
    assert np.isfinite(loss), f"non-finite loss: {loss}"
    return {"data": n_data, "model": n_model, "loss": loss}


def _dryrun_rank(rank: int, world: int, n_docs: int, device: str) -> dict:
    from hybridsearch_tpu_torch.parallel.mesh import build_mesh

    training = _dryrun_training(world, device)
    mesh = build_mesh(device=device)
    out = _dryrun_retrieval(mesh)
    out["training"] = training
    out["throughput"] = _dryrun_sharded_throughput(mesh, n_docs=n_docs)
    return out


def dryrun_multichip(n_ranks: int = 4, n_docs: int = 1_000_000,
                     device: str = "cpu") -> dict:
    """The dry run (training half, then retrieval half) on ``n_ranks`` gloo
    ranks (on the CPU, or sharing the card with ``device="cuda"``); returns
    rank 0's report (every rank asserted its checks)."""
    return launch(_dryrun_rank, n_ranks, args=(n_docs, device), device=device)[0]


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description="the port's mesh dry run")
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--docs", type=int, default=1_000_000)
    ap.add_argument("--device", default="cpu", choices=("cpu", "cuda"))
    a = ap.parse_args()
    print(dryrun_multichip(a.ranks, a.docs, a.device))
