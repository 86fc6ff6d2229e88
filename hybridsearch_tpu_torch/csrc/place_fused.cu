// K5: resident lexical buffers read straight from the CSR windows.
//
// Replaces: hybridsearch_tpu/ops/pallas_supertile.py pallas_place_fused.
//
// For each row r (one (query, probed supertile) pair) and term slot j, the
// CSR positions p in [lo[r, j], end) with
//   end = min(hi[r, j], (lo[r, j] / 128 + slot_rows[j]) * 128, n_entries),
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
// entry and writing 64 KB per row, i.e. bytes-bound, the store more than
// half of it; the adds are negligible. Against the two-step path (window
// gather + K3) it drops the staged [B*S, T*E] ids and weights, written once
// and read once in device memory, and the gather's launches. At the
// clustered serving path's shapes (T = 32 slots all capped at 16,384, one
// or two head-word windows of 4,900-16,000 entries a row, most slots
// empty or a few entries; chip_probes.py --only k5cell) it runs at 48-69%
// of that bound from 512 to 4,096 rows, where the staged windows + K3 take
// 17-119 ms.
//
// Sum order, in both designs below: a slot's window holds each doc at most
// once (a term's postings are unique per doc), so within a slot no two adds
// hit one cell; a barrier closes each slot, so each cell's sum runs in slot
// order -- the order K3 adds the staged windows in, so K5 equals window
// gather + K3 bit for bit, and the two designs equal each other. Zero
// weights are skipped, as in K3.
//
// Design (hst_place_fused): persistent blocks of 256 threads, two an SM,
// each walking the rows blockIdx.x, + gridDim.x, ... with one [r_len]
// float32 buffer (64 KB) in shared memory. Every slot's window is cut into
// stages of `entries` positions (2,048, from lo rounded down to 4, so the
// copies are 16-byte aligned) and the block's stages, row after row, stream
// through a ring of NS = 3 stages filled by 16-byte cp.async, two stages
// ahead of the adds: the next slot's window and the next row's first slots
// are in flight while a stage scatters, so a row pays no device-memory
// round trip a slot. Warp 0 alone walks the stage sequence (lane j holds
// slot j of the row, loaded one row ahead) and writes each stage's
// descriptor into shared memory a barrier before the block reads it. The
// barrier at the top of each stage closes the previous one, which keeps the
// slot order; since no two adds of a stage hit one cell, they are plain
// shared-memory adds, not atomics (a fifth faster, chip_probes.py). The
// adds walk only the stage's part of the window (5-9% faster at the
// serving path's shapes, where most slots' one stage holds a few entries). A
// finished row leaves by one bulk copy (TMA; kStore 1), the buffer zeroed
// once the copy has read it. On an H100 (chip_probes.py --only k5k7,
// PERF.md), on windows as skewed as the path's (a Zipf background word's
// window from a few hundred to 15,000 entries), that is 18-22% under the
// first design; the loads are hidden (the kernel without them runs about as
// fast), and the store and the adds, not overlapped, are the rest. Every
// thread's 16-byte stores zeroing as they go (kStore 0), atomics (kAtomic),
// two buffers at one block an SM (kStore 2, a row's store draining while
// the next scatters), 128, 384 or 512 threads, and a block a row instead of
// persistent blocks each measured slower; they are kept for the probe.
// Bounds may be int32 or int64 (the path's are int64), so the wrapper
// converts nothing. CSR pointers that are not 16-byte aligned take 4-byte
// copies.
//
// hst_place_fused_v1 is the first design, kept as a yardstick for the
// bit-equality checks and the before/after times; no served path launches
// it: one 512-thread block per row, zero, then each slot's window read with
// coalesced loads straight from the CSR, one load a thread in flight, a
// barrier after each slot, the buffer written out after the last slot.

#include <cuda_runtime.h>

#include <atomic>

namespace {

constexpr int kRow = 128;
constexpr int kMaxSlots = 32;
constexpr int kSmemMax = 232448;  // dynamic shared memory a block may take

struct SlotRows {
  int v[kMaxSlots];  // whole CSR rows a slot's window may span
};

// -- the first design, kept as the yardstick (hst_place_fused_v1) -----------

constexpr int kV1Threads = 512;

__global__ void __launch_bounds__(kV1Threads)
place_fused_v1_kernel(const int* __restrict__ lo, const int* __restrict__ hi,
                      const int* __restrict__ base, const int* __restrict__ ids,
                      const float* __restrict__ ws, long long n_entries,
                      int n_slots, SlotRows slot_rows, int r_len,
                      float* __restrict__ out) {
  extern __shared__ float buf[];  // [r_len]
  const long long row = blockIdx.x;
  for (int i = threadIdx.x; i < r_len; i += kV1Threads) buf[i] = 0.f;
  __syncthreads();
  const long long b = base[row];
  for (int j = 0; j < n_slots; ++j) {
    const long long l0 = lo[row * n_slots + j];
    long long end = (l0 / kRow + slot_rows.v[j]) * kRow;
    end = min(end, static_cast<long long>(hi[row * n_slots + j]));
    end = min(end, n_entries);
    for (long long p = l0 + threadIdx.x; p < end; p += kV1Threads) {
      const float wv = ws[p];
      const long long lv = ids[p] - b;
      if (wv != 0.f && lv >= 0 && lv < r_len) atomicAdd(&buf[lv], wv);
    }
    __syncthreads();
  }
  float* o = out + row * r_len;
  for (int i = threadIdx.x; i < r_len; i += kV1Threads) o[i] = buf[i];
}

// -- the design (hst_place_fused) --------------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <typename IdxT>
struct Params {
  const IdxT* lo;    // [rows, n_slots]
  const IdxT* hi;    // [rows, n_slots]
  const IdxT* base;  // [rows]
  const int* ids;    // [n_entries]
  const float* ws;   // [n_entries]
  float* out;        // [rows, r_len]
  long long n_entries, rows;
  int n_slots, r_len, entries;
};

// One slot of a row as lane j of a warp holds it: the window [lo, end), the
// first staged position a and the number of stages.
struct Window {
  long long lo, end, a;
  int ns;
};

// What a stage is: its row (rows or more: past the end), its first staged
// position, its window [lo, end) and the row's base doc id.
struct Stage {
  long long row, s0, lo, end, base;
};

// A position in a block's stage sequence: stage k of slot j of row `row`
// (row >= rows: past the end). Warp 0 runs it; lane j holds slot j of the
// row (`win`), and the next row's bounds are loaded one row ahead (nlo,
// nhi, nbase), so entering a row waits on no load.
template <typename IdxT, int kPiece>
struct Cursor {
  long long row;
  int j, k;
  Window win;
  long long base;
  IdxT nlo, nhi, nbase;

  __device__ void fetch(const Params<IdxT>& P, long long r, int lane) {
    if (r >= P.rows) return;
    nbase = P.base[r];
    if (lane < P.n_slots) {
      nlo = P.lo[r * P.n_slots + lane];
      nhi = P.hi[r * P.n_slots + lane];
    }
  }

  // `row`'s bounds were fetched ahead: take them, fetch the next row's
  __device__ void enter(const Params<IdxT>& P, const int* slot_rows, int lane) {
    win = Window{0, 0, 0, 0};
    base = static_cast<long long>(nbase);
    if (lane < P.n_slots) {
      const long long l = static_cast<long long>(nlo);
      long long end = (l / kRow + slot_rows[lane]) * kRow;
      end = min(end, static_cast<long long>(nhi));
      end = min(end, P.n_entries);
      if (end > l) {
        const long long a = kPiece == 4 ? (l & ~3LL) : l;
        const long long ea = kPiece == 4 ? ((end + 3) & ~3LL) : end;
        win = Window{l, end, a, static_cast<int>((ea - a + P.entries - 1) / P.entries)};
      }
    }
    fetch(P, row + gridDim.x, lane);
  }

  // move to the first stage at or after (row, j, k)
  __device__ void settle(const Params<IdxT>& P, const int* slot_rows, int lane) {
    while (row < P.rows) {
      if (j < P.n_slots) {
        if (k < __shfl_sync(0xffffffffu, win.ns, j)) return;
        ++j;
        k = 0;
      } else {
        row += gridDim.x;
        j = 0;
        if (row < P.rows) enter(P, slot_rows, lane);
      }
    }
  }

  __device__ void start(const Params<IdxT>& P, const int* slot_rows, int lane) {
    row = blockIdx.x;
    j = k = 0;
    fetch(P, row, lane);
    if (row < P.rows) enter(P, slot_rows, lane);
    settle(P, slot_rows, lane);
  }

  __device__ void next(const Params<IdxT>& P, const int* slot_rows, int lane) {
    ++k;
    settle(P, slot_rows, lane);
  }

  __device__ Stage describe(const Params<IdxT>& P) const {
    if (row >= P.rows) return Stage{row, 0, 0, 0, 0};
    return Stage{row,
                 __shfl_sync(0xffffffffu, win.a, j) + static_cast<long long>(k) * P.entries,
                 __shfl_sync(0xffffffffu, win.lo, j), __shfl_sync(0xffffffffu, win.end, j),
                 base};
  }
};

// Copy stage d into `stage` ([entries] ids, then [entries] weights): whole
// kPiece-entry pieces from the aligned start to the end rounded up (at most
// n_entries, a multiple of 128).
template <int kT, int kPiece, typename IdxT>
__device__ __forceinline__ void issue(const Params<IdxT>& P, const Stage& d, int* stage) {
  if (d.row >= P.rows) return;
  const long long ea = kPiece == 4 ? ((d.end + 3) & ~3LL) : d.end;
  const int np = static_cast<int>(min(static_cast<long long>(P.entries), ea - d.s0)) / kPiece;
  for (int i = threadIdx.x; i < 2 * np; i += kT) {
    const bool w = i >= np;
    const int q = (w ? i - np : i) * kPiece;
    int* dst = stage + (w ? P.entries : 0) + q;
    const void* src = w ? static_cast<const void*>(P.ws + d.s0 + q)
                        : static_cast<const void*>(P.ids + d.s0 + q);
    if (kPiece == 4) cp_async16(dst, src); else cp_async4(dst, src);
  }
}

template <int kT, bool kAtomic, typename IdxT>
__device__ __forceinline__ void scatter(const Params<IdxT>& P, const Stage& d,
                                        const int* stage, float* buf) {
  const float* sw = reinterpret_cast<const float*>(stage + P.entries);
  // only the stage's part of the window: a narrow slot's one stage holds a
  // few entries, not `entries`
  const int n = static_cast<int>(min(static_cast<long long>(P.entries), d.end - d.s0));
  for (int i = threadIdx.x; i < n; i += kT) {
    const long long p = d.s0 + i;
    if (p < d.lo) continue;
    const float wv = sw[i];
    const long long lv = stage[i] - d.base;
    if (wv != 0.f && lv >= 0 && lv < P.r_len) {
      if (kAtomic) atomicAdd(&buf[lv], wv); else buf[lv] += wv;
    }
  }
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_store(void* dst, const void* src, unsigned bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(src));
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               ::"l"(dst), "r"(s), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Write row `row`'s sums out and leave a zeroed buffer for the next row.
// kStore 0: 16-byte stores by every thread, each zeroing what it read.
// kStore 1 and 2: one bulk copy (TMA) of the buffer; the buffer the next
// row adds into is zeroed once the copy that last read it is done
// reading -- this one (1: one buffer), or the previous row's (2: two
// buffers, so this copy drains while the next row's stages scatter).
template <int kT, int kStore>
__device__ __forceinline__ void write_row(float* out, long long row, int r_len,
                                          float* bufs, int& cur) {
  float4* b4 = reinterpret_cast<float4*>(bufs + static_cast<long long>(cur) * r_len);
  if (kStore == 0) {
    float4* o = reinterpret_cast<float4*>(out + row * r_len);
    for (int i = threadIdx.x; i < r_len / 4; i += kT) {
      const float4 v = b4[i];
      b4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
      o[i] = v;
    }
    return;
  }
  fence_proxy_async();  // the adds are visible to the copy
  __syncthreads();
  if (threadIdx.x == 0) {
    bulk_store(out + row * r_len, b4, static_cast<unsigned>(r_len) * 4u);
    if (kStore == 1) bulk_wait_read<0>(); else bulk_wait_read<1>();
  }
  if (kStore == 2) {
    cur ^= 1;
    b4 = reinterpret_cast<float4*>(bufs + static_cast<long long>(cur) * r_len);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < r_len / 4; i += kT) b4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
}

template <int kT, int kMinB, int NS, int kPiece, typename IdxT, bool kAtomic = true,
          int kStore = 0>
__global__ void __launch_bounds__(kT, kMinB)
place_fused_kernel(Params<IdxT> P, SlotRows sr) {
  constexpr int kBufs = kStore == 2 ? 2 : 1;
  extern __shared__ __align__(128) unsigned char smem[];
  float* bufs = reinterpret_cast<float*>(smem);                         // [kBufs][r_len]
  int* ring = reinterpret_cast<int*>(smem + 4LL * kBufs * P.r_len);     // [NS][2][entries]
  int* slot_rows = ring + NS * 2 * P.entries;                           // [kMaxSlots]
  Stage* desc = reinterpret_cast<Stage*>(slot_rows + kMaxSlots);        // [NS + 1]
  int cur = 0;  // the buffer the current row adds into
  const int lane = threadIdx.x & 31;
  if (threadIdx.x < kMaxSlots) slot_rows[threadIdx.x] = sr.v[threadIdx.x];
  float4* all4 = reinterpret_cast<float4*>(bufs);
  for (int i = threadIdx.x; i < kBufs * P.r_len / 4; i += kT)
    all4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();

  // Warp 0 alone runs the cursor and writes each stage's descriptor into
  // desc[stage % (NS + 1)] one barrier before anyone reads it: stages 0 ..
  // NS - 1 here, stage s + NS in iteration s (into the entry stage s - 1
  // left, which no one reads again).
  Cursor<IdxT, kPiece> prod;
  if (threadIdx.x < 32) {
    prod.start(P, slot_rows, lane);
    for (int k = 0; k < NS; ++k) {
      const Stage d = prod.describe(P);
      if (lane == 0) desc[k] = d;
      prod.next(P, slot_rows, lane);
    }
  }
  __syncthreads();
  for (int s = 0; s < NS - 1; ++s) {
    issue<kT, kPiece>(P, desc[s], ring + s * 2 * P.entries);
    cp_async_commit();
  }
  long long wr = blockIdx.x;  // the next row to write out
  for (int s = 0;; ++s) {
    const Stage d = desc[s % (NS + 1)];
    const long long done = min(d.row, P.rows);  // rows before it are summed
    if (wr < done) {
      __syncthreads();
      for (; wr < done; wr += gridDim.x) write_row<kT, kStore>(P.out, wr, P.r_len, bufs, cur);
    }
    if (d.row >= P.rows) break;
    cp_async_wait<NS - 2>();  // this thread's copies of stage s are in
    __syncthreads();          // everyone's are; stage s - 1's adds are done
    issue<kT, kPiece>(P, desc[(s + NS - 1) % (NS + 1)],
                      ring + ((s + NS - 1) % NS) * 2 * P.entries);
    cp_async_commit();
    if (threadIdx.x < 32) {
      const Stage n = prod.describe(P);
      if (lane == 0) desc[(s + NS) % (NS + 1)] = n;
      prod.next(P, slot_rows, lane);
    }
    scatter<kT, kAtomic>(P, d, ring + (s % NS) * 2 * P.entries,
                         bufs + static_cast<long long>(cur) * P.r_len);
  }
  cp_async_wait<0>();
  if (kStore && threadIdx.x == 0) bulk_wait_all();
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

template <int kT, int kMinB, int NS, int kPiece, typename IdxT, bool kAtomic = true,
          int kStore = 0>
int launch(const Params<IdxT>& P, const SlotRows& sr, int grid, cudaStream_t s) {
  static std::atomic<unsigned> limit_set{0};
  auto kernel = place_fused_kernel<kT, kMinB, NS, kPiece, IdxT, kAtomic, kStore>;
  const long long smem = 4LL * (kStore == 2 ? 2 : 1) * P.r_len + 8LL * NS * P.entries +
                         4 * kMaxSlots + sizeof(Stage) * (NS + 1);
  if (smem > kSmemMax) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = smem_limit_once(kernel, limit_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kT, static_cast<size_t>(smem), s>>>(P, sr);
  return static_cast<int>(cudaGetLastError());
}

template <int kT, int kMinB, int NS, typename IdxT, int kStore>
int launch_aligned(const Params<IdxT>& P, const SlotRows& sr, int grid,
                   cudaStream_t s) {
  auto aligned = [](const void* p) { return reinterpret_cast<size_t>(p) % 16 == 0; };
  if (aligned(P.ids) && aligned(P.ws))
    return launch<kT, kMinB, NS, 4, IdxT, false, kStore>(P, sr, grid, s);
  return launch<kT, kMinB, NS, 1, IdxT, false, kStore>(P, sr, grid, s);
}

template <typename IdxT>
int launch_plan(const void* lo, const void* hi, const void* base, const int* ids,
                const float* ws, long long n_entries, long long rows, int n_slots,
                const int* slot_rows, int r_len, float* out, int threads, int stages,
                int entries, int grid, void* stream) {
  if (n_slots < 0 || n_slots > kMaxSlots || r_len % 4 || entries <= 0 || entries % 4 ||
      grid <= 0 || reinterpret_cast<size_t>(out) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  SlotRows sr = {};
  for (int j = 0; j < n_slots; ++j) sr.v[j] = slot_rows[j];
  const Params<IdxT> P{static_cast<const IdxT*>(lo), static_cast<const IdxT*>(hi),
                       static_cast<const IdxT*>(base), ids, ws, out, n_entries, rows,
                       n_slots, r_len, entries};
  if (threads != 256 || stages != 3) return static_cast<int>(cudaErrorInvalidValue);
  return launch_aligned<256, 2, 3, IdxT, 1>(P, sr, grid, static_cast<cudaStream_t>(stream));
}

}  // namespace

// lo, hi [rows, n_slots] absolute CSR positions and base [rows] supertile
// base doc ids, int64 if idx64 else int32; ids [n_entries] int32 and ws
// [n_entries] float32 (the CSR's 128-wide rows, flat); slot_rows [n_slots]
// int32 in host memory (n_slots <= 32); out [rows, r_len] float32, 16-byte
// aligned, r_len % 4 == 0. The plan (ops/cuda_supertile.py
// place_fused_plan): threads a block (256), ring stages (3), entries a
// stage (a multiple of 4) and blocks (at most rows); r_len * 4 + the ring
// must fit in one block's shared memory (227 KB).
extern "C" int hst_place_fused(const void* lo, const void* hi, const void* base,
                               int idx64, const int* ids, const float* ws,
                               long long n_entries, long long rows, int n_slots,
                               const int* slot_rows, int r_len, float* out,
                               int threads, int stages, int entries, int grid,
                               void* stream) {
  if (idx64)
    return launch_plan<long long>(lo, hi, base, ids, ws, n_entries, rows, n_slots,
                                  slot_rows, r_len, out, threads, stages, entries, grid,
                                  stream);
  return launch_plan<int>(lo, hi, base, ids, ws, n_entries, rows, n_slots, slot_rows,
                          r_len, out, threads, stages, entries, grid, stream);
}

// The first design: lo, hi [rows, n_slots] int32 absolute CSR positions,
// base [rows] int32, ids [n_entries] int32 and ws [n_entries] float32,
// slot_rows [n_slots] int32 in host memory (n_slots <= 32), out [rows, r_len]
// float32; r_len * 4 bytes must fit in one block's shared memory (227 KB).
extern "C" int hst_place_fused_v1(const int* lo, const int* hi, const int* base,
                                  const int* ids, const float* ws,
                                  long long n_entries, long long rows, int n_slots,
                                  const int* slot_rows, int r_len, float* out,
                                  void* stream) {
  if (n_slots < 0 || n_slots > kMaxSlots) return static_cast<int>(cudaErrorInvalidValue);
  SlotRows sr = {};
  for (int j = 0; j < n_slots; ++j) sr.v[j] = slot_rows[j];
  const size_t smem = static_cast<size_t>(r_len) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      place_fused_v1_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  place_fused_v1_kernel<<<static_cast<unsigned>(rows), kV1Threads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      lo, hi, base, ids, ws, n_entries, n_slots, sr, r_len, out);
  return static_cast<int>(cudaGetLastError());
}
