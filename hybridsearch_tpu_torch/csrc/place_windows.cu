// K3: resident lexical buffers from the gathered CSR windows.
//
// Replaces: hybridsearch_tpu/ops/pallas_supertile.py pallas_place_windows.
//
// out[bs, l] += w for every entry (l, w) of row bs with 0 <= l < r_len
// (r_len = super_tiles * 128; out viewed as [bs, l / 128, l % 128]); entries
// outside that range contribute nothing.
//
// Bound on the H100 at the slice's shapes (B*S = 512..4096 rows of TE =
// 24,576 entries): reading 8 bytes per entry and writing 64 KB per row,
// i.e. bytes-bound; the adds are negligible.
//
// Sum order: entries are added in chunks of 1024 with a barrier between
// chunks. The caller lays out each term slot's window in whole 1024-entry
// chunks, and a slot's window holds each doc at most once (a term's
// postings are unique per doc), so within one chunk no two nonzero adds
// hit one cell and the chunk barriers make each cell's sum run in slot
// order -- the order of the TPU kernel. If a chunk did hold two adds to
// one cell, the atomics keep the sum right and only its order would vary
// from run to run. Zero weights (window padding) are skipped: adding +0
// changes nothing. Both designs below keep this order, so on the path's
// inputs they give the same bits.
//
// Design (hst_place_windows): one 256-thread block per row holds the row's
// float32 buffer (64 KB at 128 supertile tiles) in dynamic shared memory,
// so three rows live on an SM. A thread takes four consecutive entries of
// each chunk with one 16-byte weight load and, only where one of the four
// weights is nonzero, one 16-byte id load (a 32-byte sector of zero
// weights costs no id traffic). Loads run ahead of the adds in registers:
// weights four chunks ahead, ids two, so the loads of later chunks are in
// flight across each chunk's barrier while the current chunk's
// shared-memory atomics run. The buffer is zeroed and written out with
// 16-byte stores. Rows whose entries or buffer are not 16-byte aligned
// take the same loop with scalar accesses.
//
// hst_place_windows_v1 is the first design, kept as a yardstick for the
// bit-equality check and the before/after times; no served path launches
// it: one 1024-thread block a row, one scalar id and weight load a thread
// a chunk, the next loads issued only after the chunk's barrier.

#include <cuda_runtime.h>

namespace {

// -- the first design, kept as the yardstick (hst_place_windows_v1) ---------

constexpr int kThreads = 1024;

__global__ void __launch_bounds__(kThreads)
place_windows_v1_kernel(const int* __restrict__ l, const float* __restrict__ w,
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

// -- the redesign (hst_place_windows) ------------------------------------------

constexpr int kChunk = 1024;  // entries between two barriers
constexpr int kT = 256;       // threads of the redesign: four entries a chunk each
constexpr int kWAhead = 4;    // chunks the weights are loaded ahead of the adds
// (the ids are loaded two chunks ahead; see the rotation in the loop)

template <bool kVec>
__device__ __forceinline__ float4 load_w(const float* wr, long long te, long long e) {
  if (kVec) {  // te % 4 == 0: the four entries are all in the row or all past it
    return e < te ? __ldcs(reinterpret_cast<const float4*>(wr + e))
                  : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  return make_float4(e < te ? wr[e] : 0.f, e + 1 < te ? wr[e + 1] : 0.f,
                     e + 2 < te ? wr[e + 2] : 0.f, e + 3 < te ? wr[e + 3] : 0.f);
}

// the ids of the four entries at e, read only where a weight is nonzero
// (a zero weight's entry is skipped, so its id is never looked at)
template <bool kVec>
__device__ __forceinline__ int4 load_l(const int* lr, long long e, float4 w) {
  if (kVec) {
    if (w.x != 0.f || w.y != 0.f || w.z != 0.f || w.w != 0.f)
      return __ldcs(reinterpret_cast<const int4*>(lr + e));
    return make_int4(-1, -1, -1, -1);
  }
  return make_int4(w.x != 0.f ? lr[e] : -1, w.y != 0.f ? lr[e + 1] : -1,
                   w.z != 0.f ? lr[e + 2] : -1, w.w != 0.f ? lr[e + 3] : -1);
}

__device__ __forceinline__ void add1(float* buf, int r_len, int l, float w) {
  if (w != 0.f && static_cast<unsigned>(l) < static_cast<unsigned>(r_len))
    atomicAdd(&buf[l], w);
}

template <bool kVec>
__global__ void __launch_bounds__(kT, 3)
place_windows_kernel(const int* __restrict__ l, const float* __restrict__ w,
                     long long te, int r_len, float* __restrict__ out) {
  extern __shared__ float4 buf4[];
  float* buf = reinterpret_cast<float*>(buf4);  // [r_len]
  const long long row = blockIdx.x;
  const int* lr = l + row * te;
  const float* wr = w + row * te;
  const long long n_chunks = (te + kChunk - 1) / kChunk;
  const long long e0 = 4 * threadIdx.x;

  // weights of chunks 0..3 and ids of chunks 0..1 in flight before the zeroing
  float4 w0 = load_w<kVec>(wr, te, e0);
  float4 w1 = load_w<kVec>(wr, te, e0 + kChunk);
  float4 w2 = load_w<kVec>(wr, te, e0 + 2 * kChunk);
  float4 w3 = load_w<kVec>(wr, te, e0 + 3 * kChunk);
  int4 l0 = load_l<kVec>(lr, e0, w0);
  int4 l1 = load_l<kVec>(lr, e0 + kChunk, w1);

  float* o = out + row * r_len;
  if (kVec) {
    for (int i = threadIdx.x; i < r_len / 4; i += kT)
      buf4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  } else {
    for (int i = threadIdx.x; i < r_len; i += kT) buf[i] = 0.f;
  }
  __syncthreads();
  for (long long c = 0; c < n_chunks; ++c) {
    const long long e = e0 + c * kChunk;
    const float4 w4 = load_w<kVec>(wr, te, e + kWAhead * kChunk);
    const int4 l2 = load_l<kVec>(lr, e + 2 * kChunk, w2);
    add1(buf, r_len, l0.x, w0.x);
    add1(buf, r_len, l0.y, w0.y);
    add1(buf, r_len, l0.z, w0.z);
    add1(buf, r_len, l0.w, w0.w);
    __syncthreads();  // chunk c's adds land before chunk c + 1's
    w0 = w1, w1 = w2, w2 = w3, w3 = w4;
    l0 = l1, l1 = l2;
  }
  if (kVec) {
    for (int i = threadIdx.x; i < r_len / 4; i += kT)
      reinterpret_cast<float4*>(o)[i] = buf4[i];
  } else {
    for (int i = threadIdx.x; i < r_len; i += kT) o[i] = buf[i];
  }
}

}  // namespace

// The first design: the same arguments and outputs as hst_place_windows.
extern "C" int hst_place_windows_v1(const int* l, const float* w, long long rows,
                                    long long te, int r_len, float* out,
                                    void* stream) {
  const size_t smem = static_cast<size_t>(r_len) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      place_windows_v1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  place_windows_v1_kernel<<<static_cast<unsigned>(rows), kThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(l, w, te, r_len,
                                                                 out);
  return static_cast<int>(cudaGetLastError());
}

// l [rows, te] int32, w [rows, te] float32, out [rows, r_len] float32;
// r_len * 4 bytes must fit in one block's shared memory (227 KB).
extern "C" int hst_place_windows(const int* l, const float* w, long long rows,
                                 long long te, int r_len, float* out,
                                 void* stream) {
  const size_t smem = static_cast<size_t>(r_len) * sizeof(float);
  auto aligned = [](const void* p) { return reinterpret_cast<size_t>(p) % 16 == 0; };
  const bool vec = te % 4 == 0 && r_len % 4 == 0 && aligned(l) && aligned(w) &&
                   aligned(out);
  auto kernel = vec ? place_windows_kernel<true> : place_windows_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(rows), kT, smem, static_cast<cudaStream_t>(stream)>>>(
      l, w, te, r_len, out);
  return static_cast<int>(cudaGetLastError());
}
