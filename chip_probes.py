#!/usr/bin/env python3
"""Design probes of kernels of the PyTorch/CUDA port, on one NVIDIA card.

    python3 chip_probes.py              # K2/K4's scoring body, K1 and K3
    python3 chip_probes.py --only ss    # the scoring body alone
    python3 chip_probes.py --only k5k7  # K5's and K7's designs
    python3 chip_probes.py --only k7    # K7's alone
    python3 chip_probes.py --only k6    # K6's designs and its wrapper's host time
    python3 chip_probes.py --only k5cell  # K5 at the clustered cell's shapes

K1 (``csrc/tile_stats.cu``): every configuration of the kernel worth
trying -- (query block BQ, queries a thread TN, blocks an SM, ring stages)
-- at the main path's corpus shape (524,288 x 384 float32 docs) and
B = 256, 128, 64 and 32 queries, each held bit-equal to the first design
(``hst_tile_stats_v1``) and timed beside it and beside cuBLAS + amax/amin.
``hst_tile_stats`` launches the fastest of these for each BQ.

K3 (``csrc/place_windows.cu``): the kernel against a copy of itself with
the barrier between chunks taken out (which gives another sum order; it is
timed, never used), on windows laid out as the clustered path lays them
(24,576 entries a row, the slots past 17,408 mostly padding of weight 0),
at 512 and 4,096 rows: what the chunk barriers cost.

K2/K4 (``csrc/super_scores.cu``): every configuration of the shared
scoring body -- (rows a block RB, pairs a group PW, pairs a thread TN,
blocks an SM, ring stages) -- on the group tables of the main path's
shapes (B = 256 over 524,288 x 384 float32 docs): K2's probe tables at
S = 2, 4, 8, 16 over 32 supertiles (and at S = 16 with every group
full), and pass 3's (query, tile) pairs at
512, 1,024 and 2,048 tiles a query over 4,096 tiles (RB = 128 only). Each
is held bit-equal to the first design (K2) or to the other configurations
and the plain version (pass 3), and timed on the score kernel alone.
``hst_super_scores`` / ``hst_super_scores_dedup`` launch the configuration
``ss::launch_pw`` names for each pair width.

K5 (``csrc/place_fused.cu``): configurations of the design -- (threads a
block, blocks an SM, ring stages, window entries a stage, shared-memory
atomics or plain adds, the row's store: every thread's 16-byte stores, a
bulk copy from one buffer, or from two) -- on windows
shaped as the levers path's (B = 256 queries of one wide slot of about
5,000 entries and three narrow ones over 16,384-doc supertiles, four empty
slots, at S = 2, 4, 8, 16), each held bit-equal to the first design
(``hst_place_fused_v1``) and timed beside it, and the same launch with
the scatter compiled out (the loads and the store alone) and with the
loads of all but the first stages compiled out (the scatter of stale
stages and the store).

With ``--only k5cell`` the same configurations run on windows shaped as
the clustered benchmark cell's (``quora-clustered.dup-b256``): B = 256
questions at t_pad = 32 slots, every slot capped at 16,384 (the batch's
widest), one or two head words a query with windows of 4,900 to 16,000
entries in every supertile, 3 to 10 narrow words and the other slots
empty, at S = 2, 4, 8, 16 (512 to 4,096 rows). There the shipped launcher
is also held bit-equal to the staged windows + K3 and timed against them
(``window_entries`` + ``place_windows``, CUDA events, host work
included), and against its byte bound (8 bytes a window entry read, the
bounds, and 64 KB stored a row, at 3.35 TB/s).

K7 (``csrc/impact_rescore.cu``): configurations (threads a block, blocks
an SM its registers must allow, entries a thread a segment, segments held
ahead in registers) at the impact ladder's (T, p, C) -- the three rungs, the margin rescore and
T = 32 -- each held bit-equal to the first design and timed beside it.
K6 (``csrc/slice_runs.cu``, ``csrc/slice_runs_variants.cuh``): every
variant of the design -- (how a row is read: 4-byte copies, 4-byte loads
into a lane's chunk of 4, or aligned 16-byte words re-aligned across the
warp by shuffles; lanes a row; entries a lane in flight a pass), each on a
grid of a group a row or of one wave (also capped at 1, 2 or 4 blocks an
SM) -- on slices drawn as the impact ladder draws them: B = 256 queries
(32 on a compacted rung) of 3-5 real terms in T = 8 slots (17-32 in
T = 32), the other slots sentinels of length 0; topic-word runs of 40-159
entries and one Zipf(1.1) background word's run capped at 4,096; starts
at every residue mod 4. Each variant is held bit-equal to the first
design (``hst_slice_runs_v1``) and timed beside it, the shipped launcher,
an empty kernel on the same replay harness (the floor of a launch), the
two outputs zeroed by PyTorch and the shipped launcher with every length
0 (what writing the outputs alone costs), and both designs writing into
outputs 1,152 bytes apart in one allocation. Successive launches write ten
output buffers in turn (writes that reach device memory, as a fresh
allocation's may), and again one buffer, written again and again (writes
that stay in L2, as in the smoke's replays of the wrapper, whose outputs
are freed and reused within the captured graph). The wrapper's host time (events around 10 back-to-back calls less
device time, and the host clock a call) is taken in turns against a copy
of the wrapper as it was before its host work was cut, with the medians
of several rounds, and so are its pieces.

K5, K6 and K7 are timed by CUDA-graph replays (device time; events around
back-to-back calls would time the host's launches at these sizes), the
shipped wrappers and the first designs both ways.

The variants are compiled from the checkout's sources into
``hybridsearch_tpu_torch/_build/probes``. Times are CUDA events around 20
back-to-back launches. The last two lines are the card's name and power
limit and a JSON object of every number. Without a CUDA card the script
exits non-zero.
"""

from __future__ import annotations

import argparse
import ctypes
import itertools
import json
import os
import subprocess
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
# (BQ, TN, blocks an SM, ring stages)
K1_CONFIGS = [(256, 16, 1, 4), (256, 16, 1, 3), (128, 8, 2, 4), (128, 8, 2, 3),
              (128, 16, 2, 4), (64, 8, 3, 3), (64, 8, 2, 4), (32, 8, 4, 3),
              (32, 8, 3, 4)]
K1_BATCHES = (256, 128, 64, 32)
K3_BARRIER = "__syncthreads();  // chunk c's adds land before chunk c + 1's"
# (RB, PW, TN, blocks an SM, ring stages) of the scoring body
SS_CONFIGS = [(128, 32, 8, 3, 3), (256, 32, 8, 2, 3), (128, 64, 8, 3, 3),
              (128, 64, 8, 2, 4), (256, 64, 8, 1, 4), (128, 128, 8, 2, 4),
              (128, 128, 8, 2, 3), (128, 128, 16, 2, 4), (256, 128, 8, 1, 4),
              (256, 128, 16, 1, 4)]
SS_PROBES = (2, 4, 8, 16)
SMEM_BLOCK = 232448  # dynamic shared memory a block may take
# K5: (threads, blocks an SM, ring stages, entries a stage, shared-memory
# atomics (1) or plain adds (0), store: 16-byte stores (0), a bulk copy
# (TMA) from one buffer (1) or from two (2))
K5_CONFIGS = [(256, 2, 4, 1024, 0, 1), (256, 2, 2, 2048, 0, 0), (256, 2, 2, 2048, 0, 1),
              (256, 2, 3, 2048, 0, 0), (256, 2, 3, 2048, 0, 1), (256, 2, 2, 1536, 0, 1),
              (384, 2, 2, 2048, 0, 1), (256, 2, 2, 2048, 1, 1), (256, 1, 2, 2048, 0, 2),
              (512, 2, 2, 2048, 0, 1)]
K5_PROBES = (2, 4, 8, 16)
# K5 at the clustered cell's shapes: head words' shares of a supertile's
# docs (windows of about 16,000, 13,100, 9,000 and 4,900 entries), narrow
# words, and the query slots (t_pad)
K5_CELL_HEAD = (0.98, 0.8, 0.55, 0.3)
K5_CELL_NARROW = 4000
K5_CELL_SLOTS = 32
# K7: (threads, blocks an SM the registers must allow, entries a thread a
# group, a one-column group's adds fused with its lookups); (T, p, C) of
# the ladder's rungs, the margin call and T = 32
K7_CONFIGS = [(1024, 2, 2, 1), (1024, 2, 3, 1), (1024, 2, 4, 1), (1024, 2, 1, 1),
              (1024, 2, 2, 0), (1024, 2, 3, 0), (1024, 2, 4, 0), (1024, 1, 8, 1),
              (1024, 1, 8, 0), (1024, 2, 8, 1)]
# the first design's column loop, and the same loop run zero times
K7_V1_WALK = "  for (int t = 0; t < T; ++t) {\n    const int* it = ib"
K7_V1_NO_WALK = "  for (int t = 0; t < 0; ++t) {\n    const int* it = ib"
K7_SHAPES = [(8, 256, 1024), (8, 1024, 2048), (8, 4096, 4096), (8, 1024, 128),
             (32, 4096, 10240)]
SS_TILES = (512, 1024, 2048)
# K6: (how a row is read: 0 4-byte copies (Copy), 1 4-byte loads into
# chunks of 4 (Ld4), 2 aligned 16-byte words and shuffles (Shfl); lanes a
# row; entries (or chunks) a lane in flight a pass); (B, T, p) of the
# ladder's rungs: B = 32 is a compacted rung
K6_CONFIGS = [(0, 32, 2), (0, 32, 4), (0, 32, 8), (0, 32, 16), (0, 64, 4), (0, 64, 8),
              (0, 64, 16), (0, 128, 2), (0, 128, 4), (0, 128, 8), (0, 256, 1), (0, 256, 2),
              (0, 256, 4), (0, 256, 8), (0, 256, 16), (2, 32, 2), (2, 128, 2), (2, 256, 1),
              (1, 32, 2), (1, 256, 1)]
K6_WAVE_CAPPED = [(0, 256, 4), (0, 256, 8)]  # also one wave of 1, 2, 4 blocks an SM
K6_SHAPES = [(256, 8, 256), (32, 8, 1024), (256, 8, 1024), (32, 8, 4096), (256, 8, 4096),
             (256, 32, 256), (256, 32, 4096)]
# postings entries, as many as the small-topic/source tier of chip_smoke.py
# holds; 4,096 sentinels follow them
K6_NNZ = 10_932_506
K6_ROUNDS = 9  # rounds of the host-time turns; medians reported
K6_OUTPUTS = 10  # output buffers a timed launch cycles through


def _name(cfg) -> str:
    return "probe_k1_" + "_".join(map(str, cfg))


def _ss_name(cfg) -> str:
    return "probe_ss_" + "_".join(map(str, cfg))


def build_ss(work: str):
    """Compile every scoring-body configuration (float32 docs) beside the
    first designs; returns the loaded library."""
    from hybridsearch_tpu_torch.ops import cuda_build

    csrc = os.path.join(REPO, "hybridsearch_tpu_torch", "csrc")
    os.makedirs(work, exist_ok=True)
    lines = [f'#include "{os.path.join(csrc, "super_scores.cu")}"']
    for cfg in SS_CONFIGS:
        rb, pw, tn, mb, ring = cfg
        lines.append(
            f'extern "C" int {_ss_name(cfg)}(const void* docs, const float* q, '
            "const int* qid, const int* dst, const int* gs, const int* gl, const int* gk, "
            "long long g_max, int d, int sd, int ch, long long last, float* out, "
            f"void* s) {{ return ss::launch<{rb}, {pw}, {tn}, {mb}, {ring}, false>(docs, q, "
            "qid, dst, gs, gl, gk, g_max, d, sd, ch, last, out, "
            "static_cast<cudaStream_t>(s)); }")
    src, so = os.path.join(work, "ss_probes.cu"), os.path.join(work, "ss_probes.so")
    with open(src, "w") as f:
        f.write("\n".join(lines) + "\n")
    proc = subprocess.run([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-shared",
                           "-o", so, src], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}{proc.stderr}")
    regs = [ln.strip() for ln in (proc.stdout + proc.stderr).splitlines()
            if "score_kernel" in ln or "registers" in ln or "spill" in ln]
    return ctypes.CDLL(so), regs


def balanced_table(tid, units: int, pw: int, warp_pairs: int = 16):
    """A group table that cuts a run of L pairs into ceil(L / pw) groups of
    equal size (rounded up to whole warps of pairs) instead of pw-sized
    groups and a remainder; the slot of a run's m-th group is
    run0 // pw + m + key + 1 (distinct, below the same bound)."""
    P = tid.shape[0]
    g_max = -(-P // pw) + units + 2
    key = tid.long().clamp(-1, units)
    pos = torch.arange(P, device=tid.device)
    run0 = torch.searchsorted(key, key, side="left")
    end = torch.searchsorted(key, key, side="right")
    length = end - run0
    n = (length + pw - 1) // pw
    g = ((length + n - 1) // n + warp_pairs - 1) // warp_pairs * warp_pairs
    head = (pos - run0) % g == 0
    slot = torch.where(head, run0 // pw + (pos - run0) // g + key + 1, g_max)

    def table(values):
        out = torch.zeros(g_max + 1, dtype=torch.long, device=tid.device)
        return out.scatter_(0, slot, values)[:g_max].to(torch.int32).contiguous()

    return table(pos), table(torch.minimum(g, end - pos)), table(key)


def probe_ss(lib) -> dict:
    """Every scoring-body configuration on K2's and pass 3's group tables."""
    from hybridsearch_tpu_torch.ops import cuda_supertile as cs

    P_, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    sig = [P_, P_, P_, P_, P_, P_, P_, L, I, I, I, L, P_, P_]
    fns = {cfg: getattr(lib, _ss_name(cfg)) for cfg in SS_CONFIGS}
    for fn in fns.values():
        fn.argtypes, fn.restype = sig, I
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    N, D, B = 524_288, 384, 256
    docs = torch.randn((N, D), generator=gen, device=dev)
    docs /= docs.norm(dim=1, keepdim=True)
    q = torch.randn((B, D), generator=gen, device=dev)
    q /= q.norm(dim=1, keepdim=True)
    stream = torch.cuda.current_stream().cuda_stream
    cases = []
    for S in SS_PROBES:
        sup = torch.sort(torch.randint(0, 32, (B, S), generator=gen, device=dev),
                         dim=1).values.int()
        cases.append(("S", S, sup, 16384, 1024))
    # every supertile probed by exactly 128 queries: each group full at
    # PW = 128 (the body's ceiling, no warp idle)
    full = ((torch.arange(B, device=dev)[:, None] * 16 + torch.arange(16, device=dev)) % 32)
    cases.append(("S16 full groups", 16, torch.sort(full, dim=1).values.int(), 16384, 1024))
    for kt in SS_TILES:
        tiles = torch.rand((B, N // 128), generator=gen, device=dev).topk(kt, dim=1).indices
        cases.append(("tiles", kt, tiles, 128, 128))
    out_rows = []
    for kind, n, ids, sd, ch in cases:
        units = cs.n_units(N, sd, ch)
        tid, qid, dst = cs.sort_pairs(ids, ids.shape[1])
        P = tid.shape[0]
        if kind.startswith("S"):
            want = cs.super_scores_v1(q, docs, ids, sd, ch)
            ref = "v1"
        else:
            want = None
            ref = "the first configuration"

        k2_ms = events_ms(lambda: cs.super_scores(q, docs, ids, sd, ch))
        route_ms = events_ms(lambda: cs.super_scores_dedup(q, docs, ids, sd, ch))
        row = {"case": kind, "n": n, "pairs": P, "pair_width": cs.pair_width(P, units),
               "k2_ms": k2_ms, "k4_route_ms": route_ms, "configs": [], "want": want}
        for cfg in SS_CONFIGS:
            rb, pw = cfg[0], cfg[1]
            if ch % rb:
                continue
            tables = {"cut": cs.group_table(tid, units, pw)}
            if pw >= 64:
                tables["balanced"] = balanced_table(tid, units, pw)
            for cut, (g_start, g_len, g_key) in tables.items():
                _probe_one(fns[cfg], cfg, cut, kind, n, row, q, docs, qid, dst, g_start,
                           g_len, g_key, P, sd, ch, N, D, ids, ref, stream, B)
                if row["want"] is None:
                    row["want"] = row.pop("got")
        print(f"  {kind}={n}: K2 wrapper {k2_ms:.4f} ms, K4 route (sort, table, kernel) "
              f"{route_ms:.4f} ms, shipped pair width {row['pair_width']}", flush=True)
        row.pop("want", None)
        row.pop("got", None)
        out_rows.append(row)
    return {"rows": out_rows}


def _probe_one(fn, cfg, cut, kind, n, row, q, docs, qid, dst, g_start, g_len, g_key,
               P, sd, ch, N, D, ids, ref, stream, B):
    """One configuration on one group table: checked against row["want"]
    (bit for bit; the first result becomes it when there is none, checked
    against the plain version), timed, appended to row["configs"]."""
    from hybridsearch_tpu_torch.ops import cuda_supertile as cs

    g_max = g_start.shape[0]
    out = torch.empty((P, sd), device=q.device)

    def call():
        rc = fn(docs.data_ptr(), q.data_ptr(), qid.data_ptr(), dst.data_ptr(),
                g_start.data_ptr(), g_len.data_ptr(), g_key.data_ptr(), g_max,
                D, sd, ch, N // ch - 1, out.data_ptr(), stream)
        if rc:
            raise RuntimeError(f"CUDA error {rc} at launch")

    call()
    torch.cuda.synchronize()
    got = out.reshape(B, -1)
    if row["want"] is None:
        err = float((got - cs.tile_scores_plain(q, docs, ids)).abs().max())
        if not err <= 1e-5:
            raise AssertionError(f"scoring body {cfg} off its plain version "
                                 f"by {err} at {kind}={n}")
        row["got"] = got
        same = True
    else:
        same = torch.equal(got, row["want"])
    ms = events_ms(call)
    flops = 2.0 * P * sd * D
    row["configs"].append({"config": list(cfg), "cut": cut, "ms": ms,
                           "bit_equal": same, "tflops": flops / ms / 1e9})
    print(f"  scoring body {kind}={n} (RB, PW, TN, blocks/SM, ring)={cfg} {cut}: "
          f"{ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), bit-equal to {ref} "
          f"{same}", flush=True)
    if not same:
        raise AssertionError(f"scoring body {cfg} differs at {kind}={n}")


def _k5_name(cfg, mode="") -> str:
    return "probe_k5_" + "_".join(map(str, cfg)) + mode


def _k7_name(cfg) -> str:
    return "probe_k7_" + "_".join(map(str, cfg))


# the K5 kernel's scatter and its loads, for the variants that leave one out
K5_SCATTER = ("    scatter<kT, kAtomic>(P, d, ring + (s % NS) * 2 * P.entries,\n"
              "                         bufs + static_cast<long long>(cur) * P.r_len);\n")
K5_LOADS = ("    issue<kT, kPiece>(P, desc[(s + NS - 1) % (NS + 1)],\n"
            "                      ring + ((s + NS - 1) % NS) * 2 * P.entries);\n")


def build_k5k7(work: str):
    """Compile K5's and K7's configurations, two sources built side by
    side; returns the two loaded libraries and the register lines."""
    from hybridsearch_tpu_torch.ops import cuda_build

    csrc = os.path.join(REPO, "hybridsearch_tpu_torch", "csrc")
    os.makedirs(work, exist_ok=True)
    with open(os.path.join(csrc, "place_fused.cu")) as f:
        k5 = f.read()
    if K5_SCATTER not in k5 or K5_LOADS not in k5:
        raise RuntimeError("place_fused.cu no longer has the lines probed here")
    k5_sig = ("(const void* lo, const void* hi, const void* base, const int* ids, "
              "const float* ws, long long n_entries, long long rows, int n_slots, "
              "const int* slot_rows, int r_len, float* out, int entries, int grid, "
              "void* s)")
    k5_body = ("{{ {ns}SlotRows sr = {{}}; for (int j = 0; j < n_slots; ++j) sr.v[j] = "
               "slot_rows[j]; const {ns}Params<long long> P{{static_cast<const long long*>(lo), "
               "static_cast<const long long*>(hi), static_cast<const long long*>(base), "
               "ids, ws, out, n_entries, rows, n_slots, r_len, entries}}; return "
               "{ns}launch<{t}, {b}, {st}, 4, long long, {atomic}, {store}>(P, sr, grid, "
               "static_cast<cudaStream_t>(s)); }}")
    parts = [k5]
    # the kernel with the scatter left out, and with the loads left out, in
    # namespaces of their own
    for mode, cut in (("noscatter", K5_SCATTER), ("noload", K5_LOADS)):
        body = k5[k5.index("namespace {"):k5.index("}  // namespace") + 15]
        parts.append(f"namespace {mode} {{\n" + body.replace(cut, "") + "\n}\n")
    for cfg in K5_CONFIGS:
        t, b, st, _e, atomic, store = cfg
        for mode in ("", "noscatter", "noload"):
            ns = f"{mode}::" if mode else ""
            parts.append(f'extern "C" int {_k5_name(cfg, mode)}{k5_sig} '
                         + k5_body.format(ns=ns, t=t, b=b, st=st,
                                          atomic="true" if atomic else "false",
                                          store=store))
    with open(os.path.join(csrc, "impact_rescore.cu")) as f:
        k7_src = f.read()
    if K7_V1_WALK not in k7_src:
        raise RuntimeError("impact_rescore.cu no longer has the first design's walk")
    k7 = [k7_src]
    # the first design with its column walk compiled out, in a namespace of
    # its own: what the table, the inserts and the read-back cost
    body = k7_src[k7_src.index("namespace {"):k7_src.index("}  // namespace") + 15]
    k7.append("namespace nowalk {\n" + body.replace(K7_V1_WALK, K7_V1_NO_WALK) + "\n}\n")
    k7.append('extern "C" int probe_k7_v1_nowalk(const int* cand, const int* ids, '
              "const float* ws, long long B, int C, int T, int p, int n_docs, "
              "int log2_slots, float* out, void* s) { const size_t smem = "
              "(static_cast<size_t>(1) << log2_slots) * 8; cudaFuncSetAttribute("
              "nowalk::impact_rescore_v1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, "
              "static_cast<int>(smem)); nowalk::impact_rescore_v1_kernel<<<static_cast<"
              "unsigned>(B), 1024, smem, static_cast<cudaStream_t>(s)>>>(cand, ids, ws, C, T, "
              "p, n_docs, log2_slots, out); return static_cast<int>(cudaGetLastError()); }")
    for cfg in K7_CONFIGS:
        t, mb, e, fuse = cfg
        k7.append(f'extern "C" int {_k7_name(cfg)}(const int* cand, const int* ids, '
                  "const float* ws, long long B, int C, int T, int p, int n_docs, "
                  "int log2_slots, float* out, void* s) { return "
                  f"launch<{t}, {mb}, {e}, {'true' if fuse else 'false'}>(cand, ids, ws, "
                  "B, C, T, p, n_docs, log2_slots, out, static_cast<cudaStream_t>(s)); }")
    # registers, local memory and resident blocks an SM of every
    # configuration and of the first design
    for cfg in K7_CONFIGS + [None]:
        kern = ("impact_rescore_v1_kernel" if cfg is None else
                "impact_rescore_kernel<{}, {}, {}, {}>".format(
                    *cfg[:3], "true" if cfg[3] else "false"))
        name = "probe_k7_v1" if cfg is None else _k7_name(cfg)
        k7.append(f'extern "C" int {name}_attrs(int smem, int* out) {{ '
                  f"cudaFuncAttributes a; cudaError_t e = cudaFuncGetAttributes(&a, {kern}); "
                  "if (e != cudaSuccess) return static_cast<int>(e); int blocks = 0; "
                  f"cudaFuncSetAttribute({kern}, cudaFuncAttributeMaxDynamicSharedMemorySize, "
                  "232448); e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, "
                  f"{kern}, {1024 if cfg is None else cfg[0]}, smem); out[0] = a.numRegs; "
                  "out[1] = static_cast<int>(a.localSizeBytes); out[2] = blocks; "
                  "return static_cast<int>(e); }")
    procs = []
    for stem, text in (("k5_probes", "\n".join(parts) + "\n"),
                       ("k7_probes", "\n".join(k7) + "\n")):
        src, so = os.path.join(work, stem + ".cu"), os.path.join(work, stem + ".so")
        with open(src, "w") as f:
            f.write(text)
        procs.append((src, so, subprocess.Popen(
            [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-I", csrc, "-shared",
             "-o", so, src], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    libs, regs = [], []
    for src, so, proc in procs:
        text = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {src}:\n{text}")
        regs += [ln.strip() for ln in text.splitlines()
                 if "registers" in ln or "spill" in ln]
        libs.append(ctypes.CDLL(so))
    return libs[0], libs[1], regs


def k5_csr(dev):
    """A CSR shaped as the levers path's: 32 supertiles of 16,384 docs, 8 wide
    terms from 2% to 90% of a supertile's docs (a Zipf background word's
    window, 330 to 14,750 entries) and 56 narrow ones (0.1-3%)."""
    from hybridsearch_tpu_torch.ops import supertile as st

    N, V = 524_288, 64
    rng = np.random.default_rng(5)
    wide = (0.9, 0.6, 0.4, 0.25, 0.15, 0.08, 0.04, 0.02)
    t_l, d_l = [], []
    for term in range(V):
        frac = wide[term] if term < 8 else float(rng.uniform(0.001, 0.03))
        hit = np.flatnonzero(rng.random(N) < frac)
        t_l.append(np.full(len(hit), term))
        d_l.append(hit)
    t_a, d_a = np.concatenate(t_l), np.concatenate(d_l)
    w_a = (rng.random(len(t_a)) * 8 + 0.01).astype(np.float32)
    return st.build_super_postings(t_a, d_a, w_a, N, V, dev)


def k5_windows(sp, S: int, dev):
    """Window bounds of B = 256 queries probing S of the 32 supertiles: slot
    0 a wide term (rows from a few hundred to 15,000 entries, as the path's
    background words give), slots 1-3 narrow ones, slots 4-7 empty; the
    path's caps (16384,) + (512,) * 7. int64 bounds, as the path hands
    them over."""
    from hybridsearch_tpu_torch.ops import supertile as st

    B, V = 256, 64
    rng = np.random.default_rng(6 + S)
    term_ids = np.full((B, 8), V)
    term_ids[:, 0] = rng.integers(0, 8, B)
    term_ids[:, 1:4] = rng.integers(8, V, (B, 3))
    sup_s = np.sort(np.stack([rng.permutation(32)[:S] for _ in range(B)]), axis=1)
    wcaps = (16384,) + (512,) * 7
    lo, hi, base, _ovf = st._flat_windows(sp.sup_pos, torch.from_numpy(term_ids).to(dev),
                                          torch.from_numpy(sup_s).to(dev), sp.super_docs,
                                          wcaps)
    return lo, hi, base, wcaps


def k5_cell_csr(dev):
    """A CSR shaped as the clustered cell's: 32 supertiles of 16,384 docs,
    the K5_CELL_HEAD head words in that share of every supertile's docs
    and K5_CELL_NARROW narrow words of 52 to 5,243 postings (0.01-1% of
    the docs, a few to 164 a supertile)."""
    from hybridsearch_tpu_torch.ops import supertile as st

    N = 524_288
    rng = np.random.default_rng(22)
    d_l = [np.flatnonzero(rng.random(N) < f) for f in K5_CELL_HEAD]
    d_l += [np.unique(rng.integers(0, N, int(rng.uniform(1e-4, 1e-2) * N)))
            for _ in range(K5_CELL_NARROW)]
    t_a = np.concatenate([np.full(len(d), t) for t, d in enumerate(d_l)])
    d_a = np.concatenate(d_l)
    w_a = (rng.random(len(t_a)) * 8 + 0.01).astype(np.float32)
    return st.build_super_postings(t_a, d_a, w_a, N, len(d_l), dev)


def k5_cell_windows(sp, S: int, dev):
    """Window bounds of B = 256 queries probing S of the 32 supertiles, as
    the clustered cell's batches give them: slot 0 a head word, slot 1 a
    second head word for half the queries, then 3 to 10 narrow words, the
    other slots of K5_CELL_SLOTS empty; every cap 16,384. int64 bounds."""
    from hybridsearch_tpu_torch.ops import supertile as st

    B, n_head = 256, len(K5_CELL_HEAD)
    V = n_head + K5_CELL_NARROW
    rng = np.random.default_rng(222 + S)
    term_ids = np.full((B, K5_CELL_SLOTS), V)
    for b in range(B):
        heads = rng.choice(n_head, 1 + int(rng.random() < 0.5), replace=False)
        narrow = n_head + rng.choice(K5_CELL_NARROW, int(rng.integers(3, 11)),
                                     replace=False)
        row = np.concatenate([np.sort(heads), narrow])
        term_ids[b, :len(row)] = row
    sup_s = np.sort(np.stack([rng.permutation(32)[:S] for _ in range(B)]), axis=1)
    wcaps = (16384,) * K5_CELL_SLOTS
    lo, hi, base, _ovf = st._flat_windows(sp.sup_pos, torch.from_numpy(term_ids).to(dev),
                                          torch.from_numpy(sup_s).to(dev), sp.super_docs,
                                          wcaps)
    return lo, hi, base, wcaps


def probe_k5(lib, cell: bool = False) -> list:
    """K5's configurations on the levers path's windows, or (``cell``) on
    the clustered cell's, with the staged route beside it there."""
    from hybridsearch_tpu_torch.ops import cuda_supertile as cs

    P_, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    sig = [P_, P_, P_, P_, P_, L, L, I, P_, I, P_, I, I, P_]
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rows_out = []
    sp = k5_cell_csr(dev) if cell else k5_csr(dev)
    for S in K5_PROBES:
        lo, hi, base, wcaps = (k5_cell_windows if cell else k5_windows)(sp, S, dev)
        BS, T = lo.shape
        R = sp.super_tiles * 128
        n_read = int((torch.minimum(hi, (lo // 128 + torch.tensor(
            cs._slot_rows(wcaps), device=dev)) * 128) - lo).clamp_min(0).sum())
        bound_ms = (n_read * 8 + BS * T * 16 + BS * 8 + BS * R * 4) / 3.35e12 * 1e3
        want = cs.place_fused_v1(lo, hi, base, sp.ids_rows, sp.ws_rows, wcaps,
                                 sp.super_tiles)
        v1 = lambda: cs.place_fused_v1(lo, hi, base, sp.ids_rows, sp.ws_rows,  # noqa: E731
                                       wcaps, sp.super_tiles)
        shipped = lambda: cs.place_fused(lo, hi, base, sp.ids_rows,  # noqa: E731
                                         sp.ws_rows, wcaps, sp.super_tiles)
        if not torch.equal(shipped(), want):
            raise AssertionError(f"K5 differs from the first design at S={S}")
        row = {"S": S, "rows": BS, "entries_read": n_read, "bound_ms": bound_ms,
               "v1_ms": events_ms(v1), "v1_device_ms": graph_ms(v1),
               "shipped_ms": events_ms(shipped), "shipped_device_ms": graph_ms(shipped),
               "configs": []}
        row["shipped_bound_pct"] = 100.0 * bound_ms / row["shipped_device_ms"]
        if cell:
            k5_staged(cs, sp, lo, hi, base, wcaps, want, row)
        slot_rows = (ctypes.c_int * T)(*cs._slot_rows(wcaps))
        for cfg in K5_CONFIGS:
            t, per_sm, st_, e, _atomic, store = cfg
            smem = 4 * R * (2 if store == 2 else 1) + 8 * st_ * e + 128 + 40 * (st_ + 1)
            if smem > min(cs.SMEM_BLOCK, cs.SMEM_SM // per_sm - cs.SMEM_RESERVED):
                continue
            for grid in (min(BS, sms * per_sm), BS):
                _probe_k5_one(lib, cfg, grid, S, BS, T, R, lo, hi, base, sp, slot_rows,
                              e, want, sig, row)
        print(f"  K5 S={S} B*S={BS}: v1 {row['v1_ms']:.4f} ms (device "
              f"{row['v1_device_ms']:.4f}), shipped wrapper {row['shipped_ms']:.4f} ms "
              f"(device {row['shipped_device_ms']:.4f}), bound {bound_ms:.4f} ms "
              f"({n_read} window entries; {row['shipped_bound_pct']:.1f}% of it)",
              flush=True)
        rows_out.append(row)
        del want
    return rows_out


def k5_staged(cs, sp, lo, hi, base, wcaps, want, row) -> None:
    """The staged route on K5's inputs: ``window_entries`` + K3, held
    bit-equal to K5's first design (``want``) and timed whole (CUDA events
    around calls, host work included), and K3 alone on its staged windows
    (device, graph replays); the staged entries a row into ``row``."""
    def staged():
        l, w = cs.window_entries(lo, hi, base, sp.ids_rows, sp.ws_rows, wcaps)
        return cs.place_windows(l, w, sp.super_tiles)

    if not torch.equal(staged(), want):
        raise AssertionError(f"K5 differs from the staged windows + K3 at rows="
                             f"{lo.shape[0]}")
    l, w = cs.window_entries(lo, hi, base, sp.ids_rows, sp.ws_rows, wcaps)
    row.update(staged_entries_a_row=l.shape[1], staged_ms=events_ms(staged, reps=3),
               k3_device_ms=graph_ms(lambda: cs.place_windows(l, w, sp.super_tiles),
                                     reps=3),
               shipped_equal_to_staged=True)
    del l, w
    torch.cuda.empty_cache()
    print(f"  K5 rows={lo.shape[0]}: staged windows + K3 {row['staged_ms']:.4f} ms "
          f"({row['staged_entries_a_row']} staged entries a row; K3 alone device "
          f"{row['k3_device_ms']:.4f} ms); K5 bit-equal to them True", flush=True)


def _probe_k5_one(lib, cfg, grid, S, BS, T, R, lo, hi, base, sp, slot_rows, e, want, sig,
                  row):
    """One K5 configuration at one grid (persistent blocks, or a block a
    row): checked bit-equal to the first design, timed with and without its
    scatter and its loads, appended to row["configs"]."""
    dev = lo.device
    times = {}
    for mode in ("", "noscatter", "noload"):
        fn = getattr(lib, _k5_name(cfg, mode))
        fn.argtypes, fn.restype = sig, ctypes.c_int
        out = torch.empty((BS, R), device=dev)

        def call():
            rc = fn(lo.data_ptr(), hi.data_ptr(), base.data_ptr(),
                    sp.ids_rows.data_ptr(), sp.ws_rows.data_ptr(),
                    sp.ids_rows.numel(), BS, T, slot_rows, R, out.data_ptr(),
                    e, grid, torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"CUDA error {rc} at launch")

        call()
        torch.cuda.synchronize()
        if not mode:
            same = torch.equal(out.view_as(want), want)
            if not same:
                raise AssertionError(f"K5 {cfg} differs from the first design "
                                     f"at S={S}")
        times[mode or "device_ms"] = graph_ms(call)
    row["configs"].append({"config": list(cfg), "grid": grid, "bit_equal_to_v1": True,
                           "device_ms": times["device_ms"],
                           "no_scatter_device_ms": times["noscatter"],
                           "no_load_device_ms": times["noload"]})
    print(f"  K5 S={S} (threads, blocks/SM, stages, entries, atomic, store)={cfg} "
          f"grid {grid}: device {times['device_ms']:.4f} ms, without the scatter "
          f"{times['noscatter']:.4f}, without the loads {times['noload']:.4f}; "
          "bit-equal to v1 True", flush=True)


def probe_k7(lib) -> list:
    from hybridsearch_tpu_torch.ops import cuda_impact as ci

    P_, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    sig = [P_, P_, P_, L, I, I, I, I, I, P_, P_]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    B, nd = 256, 524_288
    nnz = 8 * nd
    attrs = {}
    for cfg in K7_CONFIGS + [None]:
        fn = getattr(lib, ("probe_k7_v1" if cfg is None else _k7_name(cfg)) + "_attrs")
        fn.argtypes, fn.restype = [I, P_], I
        for C in (1024, 4096):
            got = (ctypes.c_int * 3)()
            if fn(8 << ci.rescore_slots(C), got):
                raise RuntimeError(f"K7 {cfg}: attributes not read")
            attrs[f"{cfg or 'v1'} C={C}"] = list(got)
            print(f"  K7 {cfg or 'v1'} at C={C}: {got[0]} registers, {got[1]} bytes local, "
                  f"{got[2]} blocks an SM", flush=True)
    run = (torch.arange(nnz, device=dev) * 7919 % nd).int()
    rows_out = []
    for (T, p, C), fill in [(shape, fill) for shape in K7_SHAPES for fill in
                            ("full", "runs", "short")]:
        starts = torch.randint(0, nnz - p, (B, T), generator=gen, device=dev).int()
        pos = (starts.long()[:, :, None] + torch.arange(p, device=dev)).reshape(B, T * p)
        ids_flat = run[pos]
        ws_flat = torch.rand((B, T * p), generator=gen, device=dev) + 0.01
        ws_flat[:, ::7] = 0.0
        if fill != "full":  # runs as the path slices them, pads past them: length
            # 0 .. 2p ("runs") or 0 .. p/4 ("short", a deep rung's mostly short runs)
            top = 2 * p if fill == "runs" else max(1, p // 4)
            length = torch.randint(0, top, (B, T, 1), generator=gen, device=dev)
            pad = (torch.arange(p, device=dev) >= length).reshape(B, T * p)
            ids_flat = torch.where(pad, nd, ids_flat).int()
            ws_flat = torch.where(pad, 0.0, ws_flat)
        cand = ids_flat[:, torch.randperm(T * p, generator=gen, device=dev)[:C]].clone()
        cand[:, 1::13] = cand[:, :1]
        cand[:, -3:] = torch.tensor([nd, nd + 2, -1], device=dev)
        want = ci.rescore_v1(cand, ids_flat, ws_flat, p, nd)
        v1 = lambda: ci.rescore_v1(cand, ids_flat, ws_flat, p, nd)  # noqa: E731
        shipped = lambda: ci.rescore(cand, ids_flat, ws_flat, p, nd)  # noqa: E731
        if not torch.equal(shipped(), want):
            raise AssertionError(f"K7 differs from the first design at {(T, p, C)}")
        bound_ms = (B * C * 8 + B * T * p * 8) / 3.35e12 * 1e3
        log2 = ci.rescore_slots(C)
        row = {"T": T, "p": p, "C": C, "fill": fill, "bound_ms": bound_ms,
               "v1_ms": events_ms(v1),
               "v1_device_ms": graph_ms(v1), "shipped_ms": events_ms(shipped),
               "shipped_device_ms": graph_ms(shipped),
               "shipped_plan": list(ci.rescore_plan(C, T, p)), "configs": []}
        for cfg in K7_CONFIGS:
            t, _mb, e, _fuse = cfg
            if t * e > 4 * T * p:  # three quarters of the threads or more idle in a group
                continue
            fn = getattr(lib, _k7_name(cfg))
            fn.argtypes, fn.restype = sig, I
            out = torch.empty((B, C), device=dev)

            def call():
                rc = fn(cand.data_ptr(), ids_flat.data_ptr(), ws_flat.data_ptr(), B, C, T,
                        p, nd, log2, out.data_ptr(), torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f"CUDA error {rc} at launch")

            call()
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                raise AssertionError(f"K7 {cfg} differs from the first design at "
                                     f"(T, p, C)={(T, p, C)}")
            ms = graph_ms(call)
            row["configs"].append({"config": list(cfg), "device_ms": ms,
                                   "bit_equal_to_v1": True})
            print(f"  K7 {fill} (T, p, C)={(T, p, C)} (threads, blocks/SM, entries a thread a group, fused)={cfg}: "
                  f"device {ms:.4f} ms, bit-equal to v1 True", flush=True)
        for label, fn, check in [("v1_nowalk", lib.probe_k7_v1_nowalk, False)]:
            fn.argtypes, fn.restype = sig, I
            out = torch.empty((B, C), device=dev)

            def call():
                rc = fn(cand.data_ptr(), ids_flat.data_ptr(), ws_flat.data_ptr(), B, C, T,
                        p, nd, log2, out.data_ptr(), torch.cuda.current_stream().cuda_stream)
                if rc:
                    raise RuntimeError(f"CUDA error {rc} at launch")

            call()
            torch.cuda.synchronize()
            if check and not torch.equal(out, want):
                raise AssertionError(f"K7 {label} differs from the first design")
            row[label] = graph_ms(call)
            print(f"  K7 {fill} (T, p, C)={(T, p, C)} {label}: device {row[label]:.4f} ms",
                  flush=True)
        print(f"  K7 {fill} (T, p, C)={(T, p, C)}: v1 {row['v1_ms']:.4f} ms (device "
              f"{row['v1_device_ms']:.4f}), shipped wrapper {row['shipped_ms']:.4f} ms "
              f"(device {row['shipped_device_ms']:.4f}; plan {row['shipped_plan']}), "
              f"bound {bound_ms:.4f} ms", flush=True)
        rows_out.append(row)
    rows_out.append({"attributes": attrs})
    return rows_out


def _k6_name(cfg) -> str:
    return "probe_k6_" + "_".join(map(str, cfg))


def build_k6(work: str):
    """Compile every K6 variant (the shipped copies of ``slice_runs.cu`` and
    the others of ``slice_runs_variants.cuh``, each at a group a row or
    one wave), an empty kernel and their attribute readers beside the
    shipped launcher and the first design; returns the loaded library and
    the register lines."""
    from hybridsearch_tpu_torch.ops import cuda_build

    csrc = os.path.join(REPO, "hybridsearch_tpu_torch", "csrc")
    os.makedirs(work, exist_ok=True)
    lines = [f'#include "{os.path.join(csrc, "slice_runs.cu")}"',
             f'#include "{os.path.join(csrc, "slice_runs_variants.cuh")}"',
             "__global__ void probe_k6_empty_kernel() {}",
             'extern "C" int probe_k6_empty(unsigned grid, void* s) { '
             "probe_k6_empty_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(s)>>>(); "
             "return static_cast<int>(cudaGetLastError()); }"]
    for cfg in K6_CONFIGS:
        read, rt, u = cfg
        row = f"k6::{('Copy', 'Ld4', 'Shfl')[read]}<{rt}, {u}>"
        kern = f"k6::slice_runs_kernel<{row}>"
        lines.append(
            f'extern "C" int {_k6_name(cfg)}(const int* ids, const float* ws, '
            "const int* st, const int* ln, long long rows, int p, int n_docs, int* io, "
            "float* wo, int one_wave, void* s) { const k6::Args a{ids, ws, st, ln, rows, "
            "p, n_docs, io, wo}; const cudaStream_t cs = static_cast<cudaStream_t>(s); "
            f"return one_wave ? k6::launch_wave<{row}>(a, one_wave, cs) : "
            f"k6::launch<{row}>(a, cs); }}")
        lines.append(
            f'extern "C" int {_k6_name(cfg)}_attrs(int* out) {{ cudaFuncAttributes a; '
            f"cudaError_t e = cudaFuncGetAttributes(&a, {kern}); if (e != cudaSuccess) "
            "return static_cast<int>(e); int blocks = 0; e = "
            f"cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, {kern}, 256, 0); "
            "out[0] = a.numRegs; out[1] = static_cast<int>(a.localSizeBytes); "
            "out[2] = blocks; return static_cast<int>(e); }")
    src, so = os.path.join(work, "k6_probes.cu"), os.path.join(work, "k6_probes.so")
    with open(src, "w") as f:
        f.write("\n".join(lines) + "\n")
    proc = subprocess.run([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-shared",
                           "-o", so, src], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}{proc.stderr}")
    regs = [ln.strip() for ln in (proc.stdout + proc.stderr).splitlines()
            if "registers" in ln or "spill" in ln]
    return ctypes.CDLL(so), regs


def k6_postings(dev):
    """Postings of K6_NNZ entries (ids in [0, 524,288), weights > 0), then
    4,096 sentinel entries (524,288, 0), as the impact tier lays them."""
    nd = 524_288
    rng = np.random.default_rng(6)
    ids = np.concatenate([rng.integers(0, nd, K6_NNZ), np.full(4096, nd)]).astype(np.int32)
    ws = np.concatenate([rng.random(K6_NNZ) + 0.01, np.zeros(4096)]).astype(np.float32)
    return torch.from_numpy(ids).to(dev), torch.from_numpy(ws).to(dev), nd


def k6_slices(rng, B: int, T: int, p: int, dev):
    """(starts, lengths) [B, T] int32 as the ladder's encode draws them:
    3-5 real terms a query at T = 8 (17-32 at T = 32), all but the last a
    topic word of 40-159 entries, the last a Zipf(1.1) background word
    over 30,000 words (a run of about 1.9 M / rank^1.1 entries, kept to
    4,096); the other slots sentinels (start K6_NNZ, length 0); each
    length cut to p; starts uniform, so at every residue mod 4."""
    lo, hi = (3, 6) if T == 8 else (17, 33)
    n_real = rng.integers(lo, hi, B)
    real = np.arange(T)[None, :] < n_real[:, None]
    kept = rng.integers(40, 160, (B, T))
    rank = np.minimum(rng.zipf(1.1, B), 30_000)
    kept[np.arange(B), n_real - 1] = np.minimum(1.9e6 / rank ** 1.1, 4096).astype(int)
    starts = np.where(real, rng.integers(0, K6_NNZ - 4096, (B, T)), K6_NNZ)
    lengths = np.where(real, np.minimum(kept, p), 0)
    t = lambda a: torch.from_numpy(a.astype(np.int32)).to(dev)  # noqa: E731
    return t(starts), t(lengths)


def slice_runs_first_wrapper(doc_ids, weights, starts, lengths, p, n_docs):
    """``slice_runs`` with the host work its wrapper did before it was cut
    (four device lookups, two allocations, two contiguity calls, the
    stream through a helper), launching the same kernel: the before of the
    host-time turns, nothing else."""
    from hybridsearch_tpu_torch.ops import cuda_build
    from hybridsearch_tpu_torch.ops import cuda_impact as ci

    if not doc_ids.is_cuda:
        raise ValueError("CUDA tensors only")
    if doc_ids.dtype != torch.int32 or weights.dtype != torch.float32:
        raise ValueError("dtypes")
    if doc_ids.dim() != 1 or weights.shape != doc_ids.shape:
        raise ValueError("postings shapes")
    if starts.shape != lengths.shape:
        raise ValueError("starts vs lengths")
    dev = doc_ids.get_device()
    if (weights.get_device() != dev or starts.get_device() != dev
            or lengths.get_device() != dev):
        raise ValueError("devices")
    if p < 1 or p > doc_ids.shape[0] or not 0 <= n_docs < 2**31:
        raise ValueError("range")
    rows = starts.numel()
    st, ln = ci._int32(starts), ci._int32(lengths)
    ids = doc_ids.new_empty((rows, p))
    ws = weights.new_empty((rows, p))
    rc = cuda_build.library().hst_slice_runs(
        ci._contiguous(doc_ids).data_ptr(), ci._contiguous(weights).data_ptr(),
        st.data_ptr(), ln.data_ptr(), rows, p, n_docs, ids.data_ptr(), ws.data_ptr(),
        cuda_build.stream_of(doc_ids))
    cuda_build.check(rc, "hst_slice_runs")
    return ids, ws


def _host_ms(fn, reps: int = 200) -> float:
    """Median host milliseconds a call: the host clock around each of
    ``reps`` calls (launches queue on the card)."""
    import time

    times = []
    for _ in range(reps):
        t = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t)
    torch.cuda.synchronize()
    return float(np.median(times)) * 1e3


def probe_k6(lib) -> dict:
    from hybridsearch_tpu_torch.ops import cuda_impact as ci

    P_, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    sig = [P_, P_, P_, P_, L, I, I, P_, P_, P_]
    dev = torch.device("cuda")
    lib.probe_k6_empty.argtypes, lib.probe_k6_empty.restype = [ctypes.c_uint, P_], I
    attrs = {}
    for cfg in K6_CONFIGS:
        fn = getattr(lib, _k6_name(cfg) + "_attrs")
        fn.argtypes, fn.restype = [P_], I
        got = (ctypes.c_int * 3)()
        if fn(got):
            raise RuntimeError(f"K6 {cfg}: attributes not read")
        attrs[str(cfg)] = list(got)
        print(f"  K6 {cfg}: {got[0]} registers, {got[1]} bytes local, {got[2]} blocks "
              "an SM", flush=True)
    ids, ws, nd = k6_postings(dev)
    rng = np.random.default_rng(7)
    rows_out, host_rows = [], []
    for B, T, p in K6_SHAPES:
        starts, lengths = k6_slices(rng, B, T, p, dev)
        rows = B * T
        ln = lengths.long()
        bound_ms = (int(ln.sum()) * 8 + rows * 8 + rows * p * 8) / 3.35e12 * 1e3
        want = ci.slice_runs_v1(ids, ws, starts, lengths, p, nd)
        outs = [(torch.empty_like(want[0]), torch.empty_like(want[1]))
                for _ in range(K6_OUTPUTS)]

        # the same outputs with the weights' plane 1,152 bytes past the ids'
        # plane in one allocation (no power-of-two distance between them)
        skew = [(f[:rows * p], f[rows * p + 288:].view(torch.float32)) for f in
                (torch.empty(2 * rows * p + 288, dtype=torch.int32, device=dev)
                 for _ in range(K6_OUTPUTS))]
        no_lengths = torch.zeros_like(lengths)

        def raw(fn, grid=None, outputs=outs, lens=lengths, ring=K6_OUTPUTS):
            turn = itertools.count()

            def call():  # on the current stream: the capture's, in a capture
                stream = torch.cuda.current_stream().cuda_stream
                if grid is not None:
                    rc = fn(grid, stream)
                else:  # the next output: the first call writes outputs[0]
                    o = outputs[next(turn) % ring]
                    rc = fn(ids.data_ptr(), ws.data_ptr(), starts.data_ptr(),
                            lens.data_ptr(), rows, p, nd, o[0].data_ptr(),
                            o[1].data_ptr(), stream)
                if rc:
                    raise RuntimeError(f"CUDA error {rc} at launch")
            return call

        fill_turn = itertools.count()

        def fill():  # what writing the outputs alone costs: both planes zeroed
            o = outs[next(fill_turn) % K6_OUTPUTS]
            o[0].zero_(), o[1].zero_()

        def equal_to_v1(call) -> bool:
            outs[0][0].zero_(), outs[0][1].zero_()
            call()
            torch.cuda.synchronize()
            return torch.equal(outs[0][0], want[0]) and torch.equal(outs[0][1], want[1])

        for name in ("hst_slice_runs", "hst_slice_runs_v1"):
            getattr(lib, name).argtypes, getattr(lib, name).restype = sig, I
        row = {"B": B, "T": T, "p": p, "rows": rows, "bound_ms": bound_ms,
               "sentinel_rows": int((ln == 0).sum()), "full_rows": int((ln == p).sum()),
               "residues": [int(((starts % 4) == r).sum()) for r in range(4)],
               "empty_1_device_ms": graph_ms(raw(lib.probe_k6_empty, 1)),
               "empty_v1grid_device_ms": graph_ms(raw(lib.probe_k6_empty, rows)),
               "v1_device_ms": graph_ms(raw(lib.hst_slice_runs_v1)),
               "shipped_device_ms": graph_ms(raw(lib.hst_slice_runs)),
               "v1_one_output_device_ms": graph_ms(raw(lib.hst_slice_runs_v1, ring=1)),
               "shipped_one_output_device_ms": graph_ms(raw(lib.hst_slice_runs, ring=1)),
               "fill_device_ms": graph_ms(fill),
               "shipped_no_lengths_device_ms": graph_ms(raw(lib.hst_slice_runs,
                                                            lens=no_lengths)),
               "v1_skewed_planes_device_ms": graph_ms(raw(lib.hst_slice_runs_v1,
                                                          outputs=skew)),
               "shipped_skewed_planes_device_ms": graph_ms(raw(lib.hst_slice_runs,
                                                               outputs=skew)),
               "configs": []}
        if not equal_to_v1(raw(lib.hst_slice_runs)):
            raise AssertionError(f"K6 differs from the first design at {(B, T, p)}")
        # grid: a group a row (0), one wave (-1), or one wave of at most k
        # blocks an SM (k > 0: fewer rows written at once)
        for cfg, one_wave in [(c, w) for c in K6_CONFIGS for w in (-1, 0)] + [
                (c, k) for c in K6_WAVE_CAPPED for k in (1, 2, 4)]:
            if cfg[0] and p % 4:
                continue
            fn = getattr(lib, _k6_name(cfg))
            fn.argtypes, fn.restype = sig[:9] + [I, P_], I
            call = raw(lambda *a, fn=fn, w=one_wave: fn(*a[:9], w, a[9]))
            if not equal_to_v1(call):
                raise AssertionError(f"K6 {cfg} differs from the first design at "
                                     f"{(B, T, p)}")
            ms = graph_ms(call)
            one_ms = graph_ms(raw(lambda *a, fn=fn, w=one_wave: fn(*a[:9], w, a[9]),
                                  ring=1))
            grid = ("a group a row" if one_wave == 0 else "one wave" if one_wave < 0
                    else f"one wave of {one_wave} blocks an SM")
            row["configs"].append({"config": list(cfg), "grid": grid, "device_ms": ms,
                                   "one_output_device_ms": one_ms,
                                   "bit_equal_to_v1": True})
            print(f"  K6 (B, T, p)={(B, T, p)} (read, lanes a row, in flight)={cfg}, "
                  f"{grid}: device {ms:.4f} ms (one output: {one_ms:.4f}), bit-equal to "
                  "v1 True", flush=True)
        print(f"  K6 (B, T, p)={(B, T, p)}: {row['sentinel_rows']} of {rows} rows "
              f"sentinels, {row['full_rows']} full, residues {row['residues']}; v1 device "
              f"{row['v1_device_ms']:.4f} ms, shipped {row['shipped_device_ms']:.4f} (one "
              f"output: v1 {row['v1_one_output_device_ms']:.4f}, shipped "
              f"{row['shipped_one_output_device_ms']:.4f}), "
              f"empty kernel {row['empty_1_device_ms']:.4f} (1 block) / "
              f"{row['empty_v1grid_device_ms']:.4f} ({rows} blocks), both outputs "
              f"zeroed {row['fill_device_ms']:.4f}, shipped with every length 0 "
              f"{row['shipped_no_lengths_device_ms']:.4f}, with the planes 1,152 bytes "
              f"apart: v1 {row['v1_skewed_planes_device_ms']:.4f}, shipped "
              f"{row['shipped_skewed_planes_device_ms']:.4f}; bound {bound_ms:.4f} ms",
              flush=True)
        rows_out.append(row)
        if B == 256 and p <= 1024:
            host_rows.append(_k6_host(lib, ids, ws, starts, lengths, p, nd, (B, T, p)))
        del want, outs, skew
    return {"shapes": rows_out, "host": host_rows, "attributes": attrs}


def _k6_host(lib, ids, ws, starts, lengths, p, nd, shape) -> dict:
    """Host time of the shipped wrapper against the wrapper before its
    host work was cut, in turns (events less device ms, and the host clock
    a call), and the host clock of its pieces: the checks, the allocations
    (two, or one and two views), the stream lookup, the launcher's ctypes
    call with its pointers, and an empty kernel's launch; medians of
    K6_ROUNDS rounds."""
    from hybridsearch_tpu_torch.ops import cuda_build
    from hybridsearch_tpu_torch.ops import cuda_impact as ci

    rows = starts.numel()
    ids_out, ws_out = ids.new_empty((rows, p)), ws.new_empty((rows, p))
    hst = cuda_build.library().hst_slice_runs
    fns = {"before": lambda: slice_runs_first_wrapper(ids, ws, starts, lengths, p, nd),
           "after": lambda: ci.slice_runs(ids, ws, starts, lengths, p, nd)}
    pieces = {
        "checks": lambda: ci._slice_checked("slice_runs", ids, ws, starts, lengths, p, nd),
        "alloc_two": lambda: (ids.new_empty((rows, p)), ws.new_empty((rows, p))),
        "alloc_one": lambda: (lambda o: (o[0], o[1].view(torch.float32)))(
            ids.new_empty((2, rows, p))),
        "stream": lambda: torch._C._cuda_getCurrentRawStream(ids.get_device()),
        "launcher": lambda: hst(ids.data_ptr(), ws.data_ptr(), starts.data_ptr(),
                                lengths.data_ptr(), rows, p, nd, ids_out.data_ptr(),
                                ws_out.data_ptr(),
                                torch._C._cuda_getCurrentRawStream(ids.get_device())),
        "empty_launch": lambda: lib.probe_k6_empty(
            1, torch._C._cuda_getCurrentRawStream(ids.get_device()))}
    before = ci.slice_runs.launches
    dev_ms = {k: graph_ms(f) for k, f in fns.items()}
    samples = {k: [] for k in list(fns) + [k + "_clock" for k in fns] + list(pieces)}
    for _ in range(K6_ROUNDS):
        for k in ("before", "after", "after", "before"):
            samples[k].append(events_ms(fns[k], reps=10) - dev_ms[k])
            samples[k + "_clock"].append(_host_ms(fns[k], reps=50))
        for k, fn in pieces.items():
            samples[k].append(_host_ms(fn, reps=50))
    ci.slice_runs.launches = before
    out = {"shape": list(shape), "device_ms": dev_ms}
    out.update({k + "_host_ms_median": float(np.median(v)) for k, v in samples.items()})
    print(f"  K6 host (B, T, p)={shape}: events less device, median of {K6_ROUNDS} "
          f"rounds: before {out['before_host_ms_median']:.4f} ms, after "
          f"{out['after_host_ms_median']:.4f}; host clock a call: before "
          f"{out['before_clock_host_ms_median']:.4f}, after "
          f"{out['after_clock_host_ms_median']:.4f}; pieces (host clock a call): " +
          ", ".join(f"{k} {out[k + '_host_ms_median']:.4f}" for k in pieces), flush=True)
    return out


def build(work: str) -> tuple:
    """Compile the K1 configurations (with the first design) and K3 with
    and without its chunk barrier; returns the two loaded libraries."""
    from hybridsearch_tpu_torch.ops import cuda_build

    csrc = os.path.join(REPO, "hybridsearch_tpu_torch", "csrc")
    os.makedirs(work, exist_ok=True)
    k1 = [f'#include "{os.path.join(csrc, "tile_stats.cu")}"']
    for cfg in K1_CONFIGS:
        bq, tn, mb, ring = cfg
        k1.append(
            f'extern "C" int {_name(cfg)}(const void* docs, int bf, const float* qt, '
            "const float* bias, long long n_rows, int d, int b, long long n_valid, "
            "float* mx, float* mn, void* s) { return "
            f"k1::launch_dtype<{bq}, {tn}, {mb}, {ring}>(docs, bf, qt, bias, n_rows / 128, "
            "d, b, n_valid, mx, mn, static_cast<cudaStream_t>(s)); }")
    with open(os.path.join(csrc, "place_windows.cu")) as f:
        k3 = f.read()
    if K3_BARRIER not in k3:
        raise RuntimeError("place_windows.cu no longer has the chunk barrier probed here")
    k3 = k3.replace("hst_place_windows(", "probe_k3_barrier(", 1)
    # the copy without the barrier, launchers and all, in a namespace of its own
    k3 += "\nnamespace nobar {\n" + k3[k3.index("namespace {"):].replace(
        K3_BARRIER, "").replace("probe_k3_barrier(", "probe_k3_no_barrier(").replace(
        "hst_place_windows_v1(", "probe_k3_v1_unused(") + "\n}  // namespace nobar\n"
    libs = []
    for stem, text in (("k1_probes", "\n".join(k1) + "\n"), ("k3_probes", k3)):
        src, so = os.path.join(work, stem + ".cu"), os.path.join(work, stem + ".so")
        with open(src, "w") as f:
            f.write(text)
        proc = subprocess.run([cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-shared",
                               "-o", so, src], capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {src}:\n{proc.stdout}{proc.stderr}")
        libs.append(ctypes.CDLL(so))
    return tuple(libs)


def events_ms(fn, reps: int = 20) -> float:
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int = 20) -> float:
    """Device milliseconds a call: CUDA events around replays of a CUDA graph
    of ``reps`` calls, so host work (done once, at capture) is left out."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (3 * reps)


def probe_k1(lib) -> list:
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    sig = [P, I, P, P, L, I, I, L, P, P, P]
    fns = {cfg: getattr(lib, _name(cfg)) for cfg in K1_CONFIGS}
    fns["v1"] = lib.hst_tile_stats_v1
    for fn in fns.values():
        fn.argtypes, fn.restype = sig, I
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    N, D = 524_288, 384
    docs = torch.randn((N, D), generator=gen, device=dev)
    docs /= docs.norm(dim=1, keepdim=True)
    bias = torch.zeros(N, device=dev)
    bias[torch.randperm(N, generator=gen, device=dev)[: N // 100]] = float("-inf")
    stream = torch.cuda.current_stream().cuda_stream
    rows = []
    for B in K1_BATCHES:
        q = torch.randn((B, D), generator=gen, device=dev)
        q /= q.norm(dim=1, keepdim=True)
        want = [torch.empty((N // 128, B), device=dev) for _ in range(2)]

        def call(fn, q_arg, out):
            rc = fn(docs.data_ptr(), 0, q_arg.data_ptr(), bias.data_ptr(), N, D, B,
                    N - 77, out[0].data_ptr(), out[1].data_ptr(), stream)
            if rc:
                raise RuntimeError(f"CUDA error {rc} at launch")

        call(fns["v1"], q, want)
        v1_ms = events_ms(lambda: call(fns["v1"], q, want))

        def library():
            s = torch.matmul(docs, q.T).view(N // 128, 128, B)
            s.amax(dim=1), s.amin(dim=1)

        row = {"B": B, "v1_ms": v1_ms, "library_ms": events_ms(library), "configs": []}
        for cfg in K1_CONFIGS:
            bq = cfg[0]
            if not B // 2 <= bq <= 2 * max(B, 32):
                continue
            qt = torch.zeros((D, -(-B // bq) * bq), device=dev)
            qt[:, :B] = q.T
            got = [torch.empty_like(w) for w in want]
            call(fns[cfg], qt, got)
            torch.cuda.synchronize()
            same = all(torch.equal(g, w) for g, w in zip(got, want))
            ms = events_ms(lambda: call(fns[cfg], qt, got))
            row["configs"].append({"config": list(cfg), "ms": ms, "bit_equal_to_v1": same,
                                   "tflops": 2.0 * N * D * B / ms / 1e9})
            print(f"  K1 B={B} (BQ, TN, blocks/SM, ring)={cfg}: {ms:.4f} ms "
                  f"({2.0 * N * D * B / ms / 1e9:.1f} TFLOP/s), bit-equal to v1 {same}",
                  flush=True)
            if not same:
                raise AssertionError(f"K1 {cfg} differs from the first design at B={B}")
        print(f"  K1 B={B}: v1 {v1_ms:.4f} ms, cuBLAS + amax/amin "
              f"{row['library_ms']:.4f} ms", flush=True)
        rows.append(row)
    return rows


def probe_k3(lib) -> list:
    P, L, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fns = {"barrier": lib.probe_k3_barrier, "no_barrier": lib.probe_k3_no_barrier}
    for fn in fns.values():
        fn.argtypes, fn.restype = [P, P, L, L, I, P, P], I
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    R, M, TE = 128 * 128, 128 * 128 + 128, 24_576
    rows = []
    for n in (512, 4096):
        start = torch.randint(0, M, (n, TE // 1024, 1), generator=gen, device=dev)
        l = ((start + 1021 * torch.arange(1024, device=dev)) % M - 64).reshape(n, TE).int()
        w = torch.rand((n, TE), generator=gen, device=dev)
        w[:, 17_408:] = 0.0  # the seven small slots' padding
        w[:, ::3] = 0.0
        out = torch.empty((n, R), device=dev)
        row = {"rows": n}
        for turn in ("barrier", "no_barrier", "no_barrier", "barrier"):
            ms = events_ms(lambda: fns[turn](l.data_ptr(), w.data_ptr(), n, TE, R,
                                             out.data_ptr(),
                                             torch.cuda.current_stream().cuda_stream))
            row.setdefault(turn + "_ms", []).append(ms)
        print(f"  K3 {n} rows: with chunk barriers {row['barrier_ms']} ms, without "
              f"{row['no_barrier_ms']} ms", flush=True)
        rows.append(row)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", choices=("ss", "k5k7", "k7", "k6", "k5cell"),
                    help="probe the scoring body alone, K5 and K7 alone, K7 alone, "
                    "K6 alone, or K5 at the clustered cell's shapes")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_probes: no CUDA card (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    work = os.path.join(REPO, "hybridsearch_tpu_torch", "_build", "probes")
    if args.only == "k6":
        lib6, regs = build_k6(work)
        for line in regs:
            print("  " + line, flush=True)
        out = {"device": smi, "k6": probe_k6(lib6), "k6_registers": regs}
        print(smi, flush=True)
        print(json.dumps(out), flush=True)
        return 0
    if args.only == "k5cell":
        lib5, _lib7, regs = build_k5k7(work)
        out = {"device": smi, "k5_cell": probe_k5(lib5, cell=True)}
        print(smi, flush=True)
        print(json.dumps(out), flush=True)
        return 0
    if args.only in ("k5k7", "k7"):
        lib5, lib7, regs = build_k5k7(work)
        for line in regs:
            print("  " + line, flush=True)
        out = {"device": smi, "k5": probe_k5(lib5) if args.only == "k5k7" else None,
               "k7": probe_k7(lib7), "k5k7_registers": regs}
        print(smi, flush=True)
        print(json.dumps(out), flush=True)
        return 0
    lib_ss, regs = build_ss(work)
    for line in regs:
        print("  " + line, flush=True)
    out = {"device": smi, "ss": probe_ss(lib_ss), "ss_registers": regs}
    if args.only is None:
        lib_k1, lib_k3 = build(work)
        out.update(k1=probe_k1(lib_k1), k3=probe_k3(lib_k3))
    print(smi, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
