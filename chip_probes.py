#!/usr/bin/env python3
"""Design probes of kernels of the PyTorch/CUDA port, on one NVIDIA card.

    python3 chip_probes.py              # K2/K4's scoring body, K1 and K3
    python3 chip_probes.py --only ss    # the scoring body alone

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

The variants are compiled from the checkout's sources into
``hybridsearch_tpu_torch/_build/probes``. Times are CUDA events around 20
back-to-back launches. The last two lines are the card's name and power
limit and a JSON object of every number. Without a CUDA card the script
exits non-zero.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

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
SS_TILES = (512, 1024, 2048)


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
    ap.add_argument("--only", choices=("ss",), help="probe the scoring body alone")
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
