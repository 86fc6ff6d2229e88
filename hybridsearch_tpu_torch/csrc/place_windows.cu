// K3: resident lexical buffers from the gathered CSR windows.
//
// Replaces: hybridsearch_tpu/ops/pallas_supertile.py pallas_place_windows.
//
// out[bs, l] += w for every entry (l, w) of row bs with 0 <= l < r_len
// (r_len = super_tiles * 128; out viewed as [bs, l / 128, l % 128]); entries
// outside that range contribute nothing.
//
// Bound on the H100 at the slice's shapes (B*S = 512..4096 rows of TE =
// 10^4..10^5 entries): reading 8 bytes per entry and writing 64 KB per row,
// i.e. bytes-bound; the adds are negligible.
//
// Design: one 1024-thread block per row holds the row's [128, 128] float32
// buffer (64 KB) in dynamic shared memory, zeroes it, walks the entries in
// chunks of 1024 (one per thread) with a barrier between chunks, adds each
// nonzero weight with a shared-memory atomic, and writes the buffer once.
// Zero weights (window padding) are skipped: adding +0 changes nothing.
// The caller lays out each term slot's window in whole 1024-entry chunks,
// and a slot's window holds each doc at most once (a term's postings are
// unique per doc), so within one chunk no two nonzero adds hit one cell and
// the chunk barriers make each cell's sum run in slot order -- the order of
// the TPU kernel. If a chunk did hold two adds to one cell, the atomics keep
// the sum right and only its order would vary from run to run.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;

__global__ void __launch_bounds__(kThreads)
place_windows_kernel(const int* __restrict__ l, const float* __restrict__ w,
                     long long te, int r_len, float* __restrict__ out) {
  extern __shared__ float buf[];  // [r_len]
  const long long row = blockIdx.x;
  for (int i = threadIdx.x; i < r_len; i += kThreads) buf[i] = 0.f;
  __syncthreads();
  const int* lr = l + row * te;
  const float* wr = w + row * te;
  for (long long e0 = 0; e0 < te; e0 += kThreads) {
    const long long e = e0 + threadIdx.x;
    if (e < te) {
      const float wv = wr[e];
      const int lv = lr[e];
      if (wv != 0.f && lv >= 0 && lv < r_len) atomicAdd(&buf[lv], wv);
    }
    __syncthreads();
  }
  float* o = out + row * r_len;
  for (int i = threadIdx.x; i < r_len; i += kThreads) o[i] = buf[i];
}

}  // namespace

// l [rows, te] int32, w [rows, te] float32, out [rows, r_len] float32;
// r_len * 4 bytes must fit in one block's shared memory (227 KB).
extern "C" int hst_place_windows(const int* l, const float* w, long long rows,
                                 long long te, int r_len, float* out,
                                 void* stream) {
  const size_t smem = static_cast<size_t>(r_len) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      place_windows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  place_windows_kernel<<<static_cast<unsigned>(rows), kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(l, w, te, r_len,
                                                              out);
  return static_cast<int>(cudaGetLastError());
}
