// K5: resident lexical buffers read straight from the CSR windows.
//
// Replaces: hybridsearch_tpu/ops/pallas_supertile.py pallas_place_fused.
//
// For each row r (one (query, probed supertile) pair) and term slot j, the
// CSR positions p in [lo[r, j], end) with
//   end = min(hi[r, j], (lo[r, j] / 128 + slot_rows[j]) * 128),
//   slot_rows[j] = wcaps[j] / 128 + 1,
// add ws[p] at out[r, l] for l = ids[p] - base[r] when 0 <= l < r_len
// (r_len = super_tiles * 128; out viewed as [r, l / 128, l % 128]). The
// bound `end` keeps exactly the positions the two-step path stages: it
// gathers slot_rows[j] whole 128-wide CSR rows from row lo / 128
// (ops/supertile.py _resident_windows), so an overflowing window (one of
// more than wcaps[j] entries, flagged by the caller) is cut at the same
// place. Empty windows (lo == hi, probes past the position table) add
// nothing.
//
// Bound on the H100 at the slice's shapes (B*S = 512..4096 rows, T = 8
// slots of at most a few thousand entries): reading 8 bytes per window
// entry and writing 64 KB per row, i.e. bytes-bound; the adds are
// negligible. Against the two-step path (window gather + K3) it drops the
// staged [B*S, T*E] ids and weights, written once and read once in device
// memory, and the gather's launches.
//
// Design: K3's (csrc/place_windows.cu). One 512-thread block per row holds
// the row's [128, 128] float32 buffer (64 KB) in dynamic shared memory,
// zeroes it, and walks the slots in order: each slot's window is read with
// coalesced loads straight from the CSR, each nonzero weight added with a
// shared-memory atomic, and a barrier closes the slot. A term's window holds
// each doc at most once, so within a slot no two adds hit one cell, and the
// barriers make each cell's sum run in slot order -- the order K3 adds the
// staged windows in, so K5 equals window gather + K3 bit for bit. Zero
// weights are skipped, as in K3. Three blocks fit an SM's shared memory.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kRow = 128;
constexpr int kMaxSlots = 32;

struct SlotRows {
  int v[kMaxSlots];  // whole CSR rows a slot's window may span
};

__global__ void __launch_bounds__(kThreads)
place_fused_kernel(const int* __restrict__ lo, const int* __restrict__ hi,
                   const int* __restrict__ base, const int* __restrict__ ids,
                   const float* __restrict__ ws, long long n_entries,
                   int n_slots, SlotRows slot_rows, int r_len,
                   float* __restrict__ out) {
  extern __shared__ float buf[];  // [r_len]
  const long long row = blockIdx.x;
  for (int i = threadIdx.x; i < r_len; i += kThreads) buf[i] = 0.f;
  __syncthreads();
  const long long b = base[row];
  for (int j = 0; j < n_slots; ++j) {
    const long long l0 = lo[row * n_slots + j];
    long long end = (l0 / kRow + slot_rows.v[j]) * kRow;
    end = min(end, static_cast<long long>(hi[row * n_slots + j]));
    end = min(end, n_entries);
    for (long long p = l0 + threadIdx.x; p < end; p += kThreads) {
      const float wv = ws[p];
      const long long lv = ids[p] - b;
      if (wv != 0.f && lv >= 0 && lv < r_len) atomicAdd(&buf[lv], wv);
    }
    __syncthreads();
  }
  float* o = out + row * r_len;
  for (int i = threadIdx.x; i < r_len; i += kThreads) o[i] = buf[i];
}

}  // namespace

// lo, hi [rows, n_slots] int32 absolute CSR positions, base [rows] int32,
// ids [n_entries] int32 and ws [n_entries] float32 (the CSR's 128-wide rows,
// flat), slot_rows [n_slots] int32 in host memory (n_slots <= 32),
// out [rows, r_len] float32; r_len * 4 bytes must fit in one block's shared
// memory (227 KB).
extern "C" int hst_place_fused(const int* lo, const int* hi, const int* base,
                               const int* ids, const float* ws,
                               long long n_entries, long long rows, int n_slots,
                               const int* slot_rows, int r_len, float* out,
                               void* stream) {
  if (n_slots < 0 || n_slots > kMaxSlots) return static_cast<int>(cudaErrorInvalidValue);
  SlotRows sr = {};
  for (int j = 0; j < n_slots; ++j) sr.v[j] = slot_rows[j];
  const size_t smem = static_cast<size_t>(r_len) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      place_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  place_fused_kernel<<<static_cast<unsigned>(rows), kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      lo, hi, base, ids, ws, n_entries, n_slots, sr, r_len, out);
  return static_cast<int>(cudaGetLastError());
}
