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
// Both designs below: one block per query holds an open-addressing hash
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
// designs and the plain version agree bit for bit.
//
// Bound: bytes (cand, ids and ws read once, out written once); the table
// probes stay in shared memory.
//
// Design (hst_impact_rescore): what bounds the first design at the
// ladder's shapes is not the device-memory round trip a column (the
// postings come from K6 a moment before and sit in L2; loading every column
// ahead of the walk, in registers or by cp.async into shared memory,
// measured slower): it is the walk's hash lookups, run between the column
// barriers while only p of the 1024 threads have an entry (p = 256 at the
// first rung). So the walk goes by groups of K * 1024 positions -- whole
// columns when a column fits (all eight at p = 256, K = 2; four at
// p = 1,024, K = 4), else parts of one: every thread first looks up the
// slots of its K positions of the group with no barrier (the lookups only
// read the table), then adds them column by column, a barrier before each
// column. A group of one column adds each entry right after its lookup, as
// the first design does. Group r + 1's loads are issued before group r's
// lookups. The candidate and the first group's loads are issued before the
// table is built, and each thread keeps its first candidate's table slot
// for the read-back. 1024 threads, at most 32 registers: two blocks an SM,
// as the first design. Measured on an H100 (PERF.md, chip_probes.py
// --only k7).
//
// hst_impact_rescore_v1 is the first design, kept as a yardstick for the
// bit-equality checks and the before/after times; no served path launches
// it: 1024 threads a query, and each column's loads issued from device
// memory only after the previous column's barrier.

#include <cuda_runtime.h>

#include <atomic>

namespace {

constexpr int kEmpty = -1;
constexpr int kSmemMax = 232448;  // dynamic shared memory a block may take

__device__ __forceinline__ unsigned slot_of(int id, int shift) {
  return (static_cast<unsigned>(id) * 2654435761u) >> shift;
}

// -- the first design, kept as the yardstick (hst_impact_rescore_v1) --------

constexpr int kV1Threads = 1024;

__global__ void __launch_bounds__(kV1Threads)
impact_rescore_v1_kernel(const int* __restrict__ cand, const int* __restrict__ ids,
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

  for (int i = threadIdx.x; i < n_slots; i += kV1Threads) {
    keys[i] = kEmpty;
    sums[i] = 0.f;
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += kV1Threads) {
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
    for (int j = threadIdx.x; j < p; j += kV1Threads) {
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
  for (int c = threadIdx.x; c < C; c += kV1Threads) {
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

// -- the design (hst_impact_rescore) ------------------------------------------


// The table slot of a candidate id, inserted if new; -1 for ids outside
// [0, n_docs).
__device__ __forceinline__ int insert(int* keys, int id, int n_docs, int shift,
                                      unsigned mask) {
  if (id < 0 || id >= n_docs) return -1;
  unsigned h = slot_of(id, shift);
  while (true) {
    const int prev = atomicCAS(&keys[h], kEmpty, id);
    if (prev == kEmpty || prev == id) return static_cast<int>(h);
    h = (h + 1) & mask;
  }
}

// The table slot holding id, or -1 when id is no candidate (the table is
// read-only once the candidates are in).
__device__ __forceinline__ int lookup(const int* keys, int id, int shift, unsigned mask) {
  unsigned h = slot_of(id, shift);
  while (true) {
    const int k = keys[h];
    if (k == id) return static_cast<int>(h);
    if (k == kEmpty) return -1;
    h = (h + 1) & mask;
  }
}

// A row's T * p entries (column t at [t * p, (t + 1) * p)) are walked in
// groups of at most K * kT positions: whole columns when a column fits
// (K * kT / p of them a group), else parts of one column. A thread takes
// the group's positions tid + k * kT (k < K): it looks up their slots with
// no barrier (the lookups only read the table), then adds them column by
// column, a barrier before each column, so each slot's sum still runs in
// column order. The loads of group r + 1 are issued before group r's
// lookups and adds (two register sets, the loop unrolled by two so no
// register is moved: a move would wait for its load).
struct Group {
  long long s0;  // first position
  int n;         // positions
  int t0, t1;    // columns [t0, t1)
  int off;       // s0 - t0 * p
};

__device__ __forceinline__ Group group_of(int r, int T, int p, int cols, int n_seg,
                                          int width) {
  Group g;
  if (n_seg == 1) {
    g.t0 = r * cols;
    g.t1 = min(T, g.t0 + cols);
    g.off = 0;
    g.n = (g.t1 - g.t0) * p;
  } else {
    g.t0 = r / n_seg;
    g.t1 = g.t0 + 1;
    g.off = (r - g.t0 * n_seg) * width;
    g.n = min(p - g.off, width);
  }
  g.s0 = static_cast<long long>(g.t0) * p + g.off;
  return g;
}

template <int kT, int K>
__device__ __forceinline__ void load_group(const int* ib, const float* wb, const Group& g,
                                           bool live, int (&id)[K], float (&w)[K]) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = threadIdx.x + k * kT;
    const bool in = live && i < g.n;
    id[k] = in ? ib[g.s0 + i] : kEmpty;
    w[k] = in ? wb[g.s0 + i] : 0.f;
  }
}

// A group of several columns: every lookup first, then the adds column by
// column. A group of one column (or part of one), with kFuse: each add
// right after its lookup, behind one barrier, as the first design walks.
template <int kT, int K, bool kFuse>
__device__ __forceinline__ void add_group(const Group& g, int p, const int (&id)[K],
                                          const float (&w)[K], const int* keys, float* sums,
                                          int n_docs, int shift, unsigned mask) {
  if (kFuse && g.t1 - g.t0 == 1) {
    __syncthreads();  // the previous column's adds are done
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (id[k] < 0 || id[k] >= n_docs || w[k] == 0.f) continue;
      const int h = lookup(keys, id[k], shift, mask);
      if (h >= 0) sums[h] += w[k];
    }
    return;
  }
  int h[K];
#pragma unroll
  for (int k = 0; k < K; ++k)
    h[k] = id[k] >= 0 && id[k] < n_docs && w[k] != 0.f ? lookup(keys, id[k], shift, mask)
                                                       : -1;
  // position i of the group lies in column t when (t - t0) * p - off <= i <
  // that + p: 32-bit offsets, no division an entry (the walk's cost is its
  // instructions)
  for (int t = g.t0, lo = -g.off; t < g.t1; ++t, lo += p) {
    __syncthreads();  // column t - 1's adds are done
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = threadIdx.x + k * kT;
      if (h[k] >= 0 && i >= lo && i < lo + p) sums[h[k]] += w[k];
    }
  }
}

template <int kT, int kMinB, int K, bool kFuse>
__global__ void __launch_bounds__(kT, kMinB)
impact_rescore_kernel(const int* __restrict__ cand, const int* __restrict__ ids,
                      const float* __restrict__ ws, int C, int T, int p, int n_docs,
                      int log2_slots, float* __restrict__ out) {
  extern __shared__ unsigned char smem[];
  const int n_slots = 1 << log2_slots;
  const unsigned mask = static_cast<unsigned>(n_slots - 1);
  const int shift = 32 - log2_slots;
  int* keys = reinterpret_cast<int*>(smem);
  float* sums = reinterpret_cast<float*>(smem + 4LL * n_slots);
  const long long b = blockIdx.x;
  const int* cb = cand + b * C;
  const long long W = static_cast<long long>(T) * p;
  const int* ib = ids + b * W;
  const float* wb = ws + b * W;
  constexpr int kWidth = K * kT;  // positions a group
  const int cols = p <= kWidth ? kWidth / p : 1;                   // whole columns a group
  const int n_seg = p <= kWidth ? 1 : (p + kWidth - 1) / kWidth;  // parts a column
  const int n_groups = p <= kWidth ? (T + cols - 1) / cols : T * n_seg;

  const int my_id = static_cast<int>(threadIdx.x) < C ? cb[threadIdx.x] : kEmpty;
  int id0[K], id1[K];
  float w0[K], w1[K];
  Group g0 = group_of(0, T, p, cols, n_seg, kWidth);
  load_group<kT, K>(ib, wb, g0, n_groups > 0, id0, w0);
  for (int i = threadIdx.x; i < n_slots; i += kT) {
    keys[i] = kEmpty;
    sums[i] = 0.f;
  }
  __syncthreads();
  const int my_slot = insert(keys, my_id, n_docs, shift, mask);
  for (int c = threadIdx.x + kT; c < C; c += kT) insert(keys, cb[c], n_docs, shift, mask);
  __syncthreads();

  for (int r = 0; r < n_groups; r += 2) {
    const Group g1 = group_of(r + 1, T, p, cols, n_seg, kWidth);
    load_group<kT, K>(ib, wb, g1, r + 1 < n_groups, id1, w1);
    add_group<kT, K, kFuse>(g0, p, id0, w0, keys, sums, n_docs, shift, mask);
    if (r + 1 >= n_groups) break;
    g0 = group_of(r + 2, T, p, cols, n_seg, kWidth);
    load_group<kT, K>(ib, wb, g0, r + 2 < n_groups, id0, w0);
    add_group<kT, K, kFuse>(g1, p, id1, w1, keys, sums, n_docs, shift, mask);
  }
  __syncthreads();
  float* ob = out + b * C;
  if (static_cast<int>(threadIdx.x) < C) ob[threadIdx.x] = my_slot >= 0 ? sums[my_slot] : 0.f;
  for (int c = threadIdx.x + kT; c < C; c += kT) {
    const int id_c = cb[c];
    float v = 0.f;
    if (id_c >= 0 && id_c < n_docs) {
      unsigned hc = slot_of(id_c, shift);
      while (keys[hc] != id_c) hc = (hc + 1) & mask;
      v = sums[hc];
    }
    ob[c] = v;
  }
}

// Lift a kernel's dynamic shared-memory limit to the block maximum, and ask
// for the largest shared-memory carveout, once a device (`done`, one a
// kernel: bit d set on device d): each launch then asks for what it uses,
// and the attribute calls leave the per-call path.
template <typename Kernel>
cudaError_t smem_limit_once(Kernel kernel, std::atomic<unsigned>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned bit = dev < 32 ? 1u << dev : 0u;
  if (bit && (done.load(std::memory_order_relaxed) & bit)) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemMax);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_relaxed);
  return err;
}

template <int kT, int kMinB, int K, bool kFuse = true>
int launch(const int* cand, const int* ids, const float* ws, long long B, int C, int T,
           int p, int n_docs, int log2_slots, float* out, cudaStream_t s) {
  static std::atomic<unsigned> limit_set{0};
  auto kernel = impact_rescore_kernel<kT, kMinB, K, kFuse>;
  const long long smem = 8LL << log2_slots;
  if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = smem_limit_once(kernel, limit_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(B), kT, static_cast<size_t>(smem), s>>>(
      cand, ids, ws, C, T, p, n_docs, log2_slots, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// cand [B, C] int32, ids [B, T * p] int32, ws [B, T * p] float32,
// out [B, C] float32. The plan (ops/cuda_impact.py rescore_plan): threads
// a block and entries a thread a group, (1024, 2) or (1024, 4);
// 2^log2_slots >= 1.25 C table slots of 8 bytes must fit in one block's
// shared memory (227 KB).
extern "C" int hst_impact_rescore(const int* cand, const int* ids, const float* ws,
                                  long long B, int C, int T, int p, int n_docs,
                                  int log2_slots, float* out, int threads, int entries,
                                  void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (threads == 1024 && entries == 2)
    return launch<1024, 2, 2>(cand, ids, ws, B, C, T, p, n_docs, log2_slots, out, s);
  if (threads == 1024 && entries == 4)
    return launch<1024, 2, 4>(cand, ids, ws, B, C, T, p, n_docs, log2_slots, out, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The first design: cand [B, C] int32, ids [B, T * p] int32, ws [B, T * p]
// float32, out [B, C] float32; 2^log2_slots >= 1.25 C slots of 8 bytes must
// fit in one block's shared memory (227 KB).
extern "C" int hst_impact_rescore_v1(const int* cand, const int* ids, const float* ws,
                                     long long B, int C, int T, int p, int n_docs,
                                     int log2_slots, float* out, void* stream) {
  const size_t smem = (static_cast<size_t>(1) << log2_slots) * 8;
  cudaError_t err = cudaFuncSetAttribute(
      impact_rescore_v1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  impact_rescore_v1_kernel<<<static_cast<unsigned>(B), kV1Threads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      cand, ids, ws, C, T, p, n_docs, log2_slots, out);
  return static_cast<int>(cudaGetLastError());
}
