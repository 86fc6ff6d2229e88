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
// (the TPU kernel needed align-multiples for Mosaic's DMA tiling).
//
// Bound at the path's shapes (B = 256, T = 8..32, p = 256..4096): a pure
// copy, 8 bytes read and 8 written per entry, so it is bytes-bound: 8.4 MB
// at p = 256, T = 8, or 2.5 us at the 3.35 TB/s of an NVIDIA H100 80GB
// HBM3 at its 700 W limit. At the shallow rungs a launch, and the
// wrapper's host work, take longer than that; this kernel does nothing
// about it.
//
// Design: one 256-thread block per row; consecutive threads copy
// consecutive entries, so loads and stores coalesce whatever the start's
// alignment. Plain copies: the output equals the plain version bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
slice_runs_kernel(const int* __restrict__ doc_ids,
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

}  // namespace

// doc_ids/weights [nnz + p_max]; starts/lengths [rows] int32;
// ids_out/ws_out [rows, p].
extern "C" int hst_slice_runs(const int* doc_ids, const float* weights,
                              const int* starts, const int* lengths,
                              long long rows, int p, int n_docs, int* ids_out,
                              float* ws_out, void* stream) {
  slice_runs_kernel<<<static_cast<unsigned>(rows), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      doc_ids, weights, starts, lengths, p, n_docs, ids_out, ws_out);
  return static_cast<int>(cudaGetLastError());
}
