// K6: impact-run prefix slices for the pruned lexical arm.
//
// Replaces: hybridsearch_tpu/ops/pallas_impact.py pallas_slice_runs, together
// with the tail mask its caller (ops/impact.py slice_impact_runs) applies.
//
// For every (query b, term slot t) row r = b * T + t and position j < p:
//   ids_out[r, j] = j < lengths[r] ? doc_ids[starts[r] + j] : n_docs
//   ws_out[r, j]  = j < lengths[r] ? weights[starts[r] + j] : 0
// The postings carry p_max sentinel entries past their last run, so every
// slice of width p <= p_max stays in bounds; starts need no alignment here
// (the TPU kernel needed align-multiples for Mosaic's DMA tiling). Every
// design below is a copy: its output equals the plain version bit for bit.
//
// Bound: bytes. The entries each row reads up to its length (8 bytes an
// entry: id and weight), the starts and lengths, and both outputs (8 bytes
// a position): about 5.3 MB at the first rung (B = 256, T = 8, p = 256,
// where a query's 3-5 real terms leave the other slots of T = 8 as
// sentinels of length 0), 1.6 us at the 3.35 TB/s of an NVIDIA H100 80GB
// HBM3 at its 700 W limit; 67 MB of stores at p = 4,096.
//
// What holds a slice on the card, measured on an H100 on slices drawn as
// the ladder draws them (chip_probes.py --only k6; numbers in PERF.md):
//   1. The launch. An empty kernel takes about 1 us a launch on a CUDA
//      graph replay, and about 2 us at the first design's 2,048 blocks (a
//      block a row): half of its time at the first rung. Here rows of
//      p <= 256 go a warp a row: 256 blocks at the first rung.
//   2. Loads in flight. The first design has one 4-byte load a thread and
//      array in flight. Here each lane issues U loads an array back to back
//      before its stores: U = 8 at p <= 256 (32 lanes a row), 16 at
//      p <= 1,024 (64 lanes) and beyond (a block a row). Positions
//      at or past the length store the constants with no load: a row of
//      length 0 is stores only. A pass addresses its positions from one
//      pointer an array at constant offsets: 26-52 registers (a version
//      that recomputed each address took several times as many, and held
//      fewer blocks an SM).
//   3. The stores, at p = 4,096: with every length 0 the kernel writes the
//      67 MB as fast as PyTorch zeroes the two outputs; the reads, a few
//      percent of the bytes, add about a quarter to that by their latency.
//      A grid of one wave (each group walking rows g, g + G, ...) lost to
//      a group a row, which the block scheduler balances; so did one wave
//      of fewer blocks an SM; the two outputs' distance apart did not
//      matter.
// Two other ways to read a row, each stored with 16-byte stores, are in
// slice_runs_variants.cuh with the one-wave grids, for the probes: a
// lane's chunk of 4 positions read with 4-byte loads, or as aligned
// 16-byte words re-aligned across the warp with __shfl_sync. Neither beat
// the 4-byte copies at a shape of the path. The copies take any p and any
// alignment.
//
// hst_slice_runs_v1 is the first design, kept as a yardstick for the
// bit-equality checks and the before/after times; no served path launches
// it.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
slice_runs_v1_kernel(const int* __restrict__ doc_ids,
                     const float* __restrict__ weights,
                     const int* __restrict__ starts, const int* __restrict__ lengths,
                     int p, int n_docs, int* __restrict__ ids_out,
                     float* __restrict__ ws_out) {
  const long long row = blockIdx.x;
  const long long s0 = starts[row];
  const int len = lengths[row];
  int* io = ids_out + row * p;
  float* wo = ws_out + row * p;
  for (int j = threadIdx.x; j < p; j += kThreads) {
    if (j < len) {
      io[j] = doc_ids[s0 + j];
      wo[j] = weights[s0 + j];
    } else {
      io[j] = n_docs;
      wo[j] = 0.f;
    }
  }
}

namespace k6 {

struct Args {
  const int* ids;
  const float* ws;
  const int* starts;
  const int* lengths;
  long long rows;
  int p;
  int n_docs;
  int* ids_out;
  float* ws_out;
};

// How a group of kRT lanes copies one row (len already cut to [0, p]):
// lane t copies positions t, t + kRT, ..., U of them an array a pass
// (loads issued back to back, then the stores in position order). A pass
// addresses its positions from one pointer an array at constant offsets,
// which holds the registers down (four 64-bit addresses, not 4 U).
template <int kRT, int U>
struct Copy {
  static constexpr int RT = kRT;

  __device__ __forceinline__ static void row(const Args& a, long long s0, int len,
                                             int* io, float* wo, int t) {
    const int* src_i = a.ids + s0 + t;
    const float* src_w = a.ws + s0 + t;
    io += t;
    wo += t;
#pragma unroll 1  // a pass's loads in flight, not the next pass's: registers
    for (int base = t; base < a.p; base += RT * U) {
      int vi[U];
      float vw[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        vi[u] = a.n_docs;
        vw[u] = 0.f;
        if (base + u * RT < len) {
          vi[u] = src_i[u * RT];
          vw[u] = src_w[u * RT];
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (base + u * RT < a.p) {
          io[u * RT] = vi[u];
          wo[u * RT] = vw[u];
        }
      }
      src_i += RT * U;
      src_w += RT * U;
      io += RT * U;
      wo += RT * U;
    }
  }
};

// Row ``row`` of the slices by a group of Row::RT lanes (t: the lane's
// place in the group).
template <class Row>
__device__ __forceinline__ void serve_row(const Args& a, long long row, int t) {
  const long long s0 = a.starts[row];
  const int len = min(max(a.lengths[row], 0), a.p);
  Row::row(a, s0, len, a.ids_out + row * a.p, a.ws_out + row * a.p, t);
}

// A group of lanes a row.
template <class Row>
__global__ void __launch_bounds__(kThreads)
slice_runs_kernel(const Args a) {
  constexpr int kGroups = kThreads / Row::RT;
  const long long row =
      static_cast<long long>(blockIdx.x) * kGroups + threadIdx.x / Row::RT;
  if (row < a.rows) serve_row<Row>(a, row, static_cast<int>(threadIdx.x) % Row::RT);
}

template <class Row>
int launch(const Args& a, cudaStream_t s) {
  static_assert(kThreads % Row::RT == 0, "whole groups a block");
  constexpr int kGroups = kThreads / Row::RT;
  const long long grid = (a.rows + kGroups - 1) / kGroups;
  if (a.rows <= 0) return 0;
  if (grid > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  slice_runs_kernel<Row><<<static_cast<unsigned>(grid), kThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace k6

}  // namespace

// doc_ids/weights [nnz + p_max]; starts/lengths [rows] int32;
// ids_out/ws_out [rows, p]. 4-byte copies, a group a row (chosen by
// chip_probes.py --only k6 at the ladder's p = 256, 1,024 and 4,096).
extern "C" int hst_slice_runs(const int* doc_ids, const float* weights,
                              const int* starts, const int* lengths,
                              long long rows, int p, int n_docs, int* ids_out,
                              float* ws_out, void* stream) {
  using namespace k6;
  const Args a{doc_ids, weights, starts, lengths, rows, p, n_docs, ids_out, ws_out};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p <= 256) return launch<Copy<32, 8>>(a, s);
  if (p <= 1024) return launch<Copy<64, 16>>(a, s);
  return launch<Copy<256, 16>>(a, s);
}

// The first design: one 256-thread block a row.
extern "C" int hst_slice_runs_v1(const int* doc_ids, const float* weights,
                                 const int* starts, const int* lengths,
                                 long long rows, int p, int n_docs, int* ids_out,
                                 float* ws_out, void* stream) {
  if (rows <= 0) return 0;
  slice_runs_v1_kernel<<<static_cast<unsigned>(rows), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      doc_ids, weights, starts, lengths, p, n_docs, ids_out, ws_out);
  return static_cast<int>(cudaGetLastError());
}
