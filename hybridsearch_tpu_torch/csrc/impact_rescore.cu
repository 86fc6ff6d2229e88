// K7: exact candidate rescore over the pruned impact-run slices.
//
// Replaces: hybridsearch_tpu/ops/pallas_impact.py pallas_onehot_rescore.
//
// out[b, c] = sum over posting entries w of row b whose id equals cand[b, c]
// of ws[b, w], for 0 <= cand[b, c] < n_docs; other candidates (sentinels,
// -1) give 0, as the TPU kernel gives them by construction. Posting ids
// outside [0, n_docs) are the slices' pads, of weight 0, and are skipped.
//
// The TPU kernel builds the [C, W] one-hot comparison for the MXU. On
// Hopper that is C * W compare-adds a query (0.54 G for a batch of 256 at
// the first rung, 34 G at the third), where the bytes bound is a few to
// tens of microseconds (3.35 TB/s, NVIDIA H100 80GB HBM3 at its 700 W
// limit). So the comparison is not ported.
//
// Design: one 1024-thread block per query holds an open-addressing hash
// table of its candidate ids (int32 key, float32 sum; n_slots a power of
// two >= 1.25 C, 8 bytes a slot in dynamic shared memory: 128 KB at
// C = 10,240). The block inserts the candidates (shared-memory CAS; equal
// ids share a slot), then walks the posting columns t = 0 .. T-1 in order
// (row b is [T, p]: column t is term slot t's slice), with a barrier
// between columns. Within one column a doc id appears at most once (a
// term's run comes from a CSR whose (term, doc) pairs are unique), so no
// slot is hit twice between two barriers: plain adds, no atomics, and each
// candidate's sum runs in column order. Every candidate slot then reads its
// id's total. The plain version adds the columns in the same order, so the
// two agree bit for bit.
//
// Bound: bytes (cand, ids and ws read once, out written once); the table
// probes stay in shared memory.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kEmpty = -1;

__device__ __forceinline__ unsigned slot_of(int id, int shift) {
  return (static_cast<unsigned>(id) * 2654435761u) >> shift;
}

__global__ void __launch_bounds__(kThreads)
impact_rescore_kernel(const int* __restrict__ cand, const int* __restrict__ ids,
                      const float* __restrict__ ws, int C, int T, int p,
                      int n_docs, int log2_slots, float* __restrict__ out) {
  extern __shared__ unsigned char smem[];
  const int n_slots = 1 << log2_slots;
  const unsigned mask = static_cast<unsigned>(n_slots - 1);
  const int shift = 32 - log2_slots;
  int* keys = reinterpret_cast<int*>(smem);
  float* sums = reinterpret_cast<float*>(smem + sizeof(int) * n_slots);
  const long long b = blockIdx.x;
  const int* cb = cand + b * C;
  const long long W = static_cast<long long>(T) * p;
  const int* ib = ids + b * W;
  const float* wb = ws + b * W;

  for (int i = threadIdx.x; i < n_slots; i += kThreads) {
    keys[i] = kEmpty;
    sums[i] = 0.f;
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += kThreads) {
    const int id = cb[c];
    if (id < 0 || id >= n_docs) continue;
    unsigned h = slot_of(id, shift);
    while (true) {
      const int prev = atomicCAS(&keys[h], kEmpty, id);
      if (prev == kEmpty || prev == id) break;
      h = (h + 1) & mask;
    }
  }
  __syncthreads();
  for (int t = 0; t < T; ++t) {
    const int* it = ib + static_cast<long long>(t) * p;
    const float* wt = wb + static_cast<long long>(t) * p;
    for (int j = threadIdx.x; j < p; j += kThreads) {
      const int id = it[j];
      const float w = wt[j];
      if (id < 0 || id >= n_docs || w == 0.f) continue;
      unsigned h = slot_of(id, shift);
      while (true) {
        const int k = keys[h];
        if (k == id) {
          sums[h] += w;
          break;
        }
        if (k == kEmpty) break;
        h = (h + 1) & mask;
      }
    }
    __syncthreads();
  }
  float* ob = out + b * C;
  for (int c = threadIdx.x; c < C; c += kThreads) {
    const int id = cb[c];
    float v = 0.f;
    if (id >= 0 && id < n_docs) {
      unsigned h = slot_of(id, shift);
      while (keys[h] != id) h = (h + 1) & mask;
      v = sums[h];
    }
    ob[c] = v;
  }
}

}  // namespace

// cand [B, C] int32, ids [B, T * p] int32, ws [B, T * p] float32,
// out [B, C] float32; 2^log2_slots >= 1.25 C slots of 8 bytes must fit in
// one block's shared memory (227 KB).
extern "C" int hst_impact_rescore(const int* cand, const int* ids,
                                  const float* ws, long long B, int C, int T,
                                  int p, int n_docs, int log2_slots, float* out,
                                  void* stream) {
  const size_t smem = (static_cast<size_t>(1) << log2_slots) * 8;
  cudaError_t err = cudaFuncSetAttribute(
      impact_rescore_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  impact_rescore_kernel<<<static_cast<unsigned>(B), kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      cand, ids, ws, C, T, p, n_docs, log2_slots, out);
  return static_cast<int>(cudaGetLastError());
}
