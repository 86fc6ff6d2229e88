// K1: per-128-row-tile statistics of docs @ q^T, for the dense stats sweep.
//
// Replaces: hybridsearch_tpu/ops/pallas_topk.py pallas_tile_stats_t.
//
// Computes, for every 128-row doc tile t and query b,
//   max[t, b] = max over rows r of tile t of  (r < n_valid ? s[r,b] + bias[r] : -inf)
//   min[t, b] = min over rows r of tile t of  (r < n_valid && bias[r] >= 0 ? s[r,b] : +inf)
// with s = docs @ q^T accumulated in float32. The [N, B] score matrix never
// reaches device memory: only the [N/128, B] statistics are written.
//
// Bound on the H100 at the slice's shapes (N = 524288, D = 384, B = 256,
// float32 docs): 2*N*D*B = 103 GFLOP of float32 FMA against 805 MB of doc
// reads, i.e. operations-bound (67 TFLOP/s float32 vs 3.35 TB/s); at
// B <= 64 the 805 MB read bounds it instead. The products must stay
// float32 FMA (no TF32, no tensor cores): the supertile certificate
// compares these tile maxima with the resident scores of K2 and is sound
// only while the two differ by summation order alone. So each score is
// one fmaf chain over depth 0..D-1 from 0.f, in both designs below, and
// the two give the same bits (max and min are exact in any order).
//
// Design (hst_tile_stats): a float32 SIMT SGEMM with the statistics as its
// epilogue. Persistent blocks (1-4 an SM, as shared memory and registers
// allow) walk the work items (128-row tile, block of BQ queries), a tile's
// query blocks next to each other, so its second query block finds the
// rows in L2 and each doc byte leaves HBM once. BQ is 32, 64, 128 or 256,
// taken from B, so a small batch does no FMAs on absent queries. A thread
// holds an 8 x TN register tile (TN = 16 at BQ = 256, else 8) and reads
// its operands depth-major from shared memory, two (docs) and TN/4
// (queries) 16-byte reads a depth: the operands of one depth are all the
// registers it needs beside the accumulators. Depth slices of 16 flow
// through a ring of kRing stages filled by cp.async, kRing - 2 slices
// ahead of the one being transposed, across item boundaries, so one
// item's epilogue overlaps the next item's loads: raw doc rows, each
// thread then transposing the pieces it copied itself into one of two
// depth-major stages (so its own wait_group suffices), and query slices
// straight from a depth-major copy that the wrapper makes (qt, zero past
// B). One barrier a slice; every shared-memory access pattern hits
// distinct banks. bf16 docs are copied raw and widened as they are
// transposed (exact, as __bfloat162float); their products with
// bf16-rounded queries are exact in float32, so accumulation is float32 as
// for float32 docs. At BQ = 256 the block's operand reads take about three
// quarters of the SM's shared-memory throughput at the full FMA rate, which
// with the transposes is what bounds it.
//
// hst_tile_stats_v1 is the first design, kept as a yardstick for the
// bit-equality check and the before/after times; no served path launches
// it: one 256-thread block per (tile, 128 queries), depth 16 staged
// through transposed shared memory by plain loads, two barriers a slice.

#include <climits>

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>

namespace {

constexpr int kTile = 128;    // doc rows per tile

// -- the first design, kept as the yardstick (hst_tile_stats_v1) ------------

constexpr int kQ = 128;       // queries per block
constexpr int kK = 16;        // depth per shared-memory stage
constexpr int kThreads = 256;

template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
tile_stats_v1_kernel(const void* __restrict__ docs_v, const float* __restrict__ q,
                  const float* __restrict__ bias, int d, int b, long long n_valid,
                  float* __restrict__ out_max, float* __restrict__ out_min) {
  __shared__ __align__(16) float a_s[kK][kTile];  // docs, [depth][row]
  __shared__ __align__(16) float b_s[kK][kQ];     // queries, [depth][query]
  __shared__ float red_max[16][kQ];
  __shared__ float red_min[16][kQ];

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // query group: queries tx*8 .. tx*8+7
  const int ty = tid / 16;  // row group: rows ty*8 .. ty*8+7
  const long long row0 = static_cast<long long>(blockIdx.x) * kTile;
  const int col0 = blockIdx.y * kQ;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < d; k0 += kK) {
    if (kBf16) {
      // 128 rows x 16 bf16 = 256 chunks of 8 bf16 (16 bytes): one each
      const __nv_bfloat16* docs = static_cast<const __nv_bfloat16*>(docs_v);
      const int r = tid / 2, c = (tid % 2) * 8;
      const uint4 raw =
          *reinterpret_cast<const uint4*>(docs + (row0 + r) * d + k0 + c);
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
      for (int i = 0; i < 8; ++i) a_s[c + i][r] = __bfloat162float(e[i]);
    } else {
      // 128 rows x 16 floats = 512 float4: two each
      const float* docs = static_cast<const float*>(docs_v);
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const int idx = tid + p * kThreads;
        const int r = idx / 4, c = (idx % 4) * 4;
        const float4 v =
            *reinterpret_cast<const float4*>(docs + (row0 + r) * d + k0 + c);
        a_s[c][r] = v.x;
        a_s[c + 1][r] = v.y;
        a_s[c + 2][r] = v.z;
        a_s[c + 3][r] = v.w;
      }
    }
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int idx = tid + p * kThreads;
      const int r = idx / 4, c = (idx % 4) * 4;
      const int qb = col0 + r;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (qb < b)
        v = *reinterpret_cast<const float4*>(
            q + static_cast<long long>(qb) * d + k0 + c);
      b_s[c][r] = v.x;
      b_s[c + 1][r] = v.y;
      b_s[c + 2][r] = v.z;
      b_s[c + 3][r] = v.w;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      float av[8], bv[8];
      *reinterpret_cast<float4*>(&av[0]) =
          *reinterpret_cast<const float4*>(&a_s[k][ty * 8]);
      *reinterpret_cast<float4*>(&av[4]) =
          *reinterpret_cast<const float4*>(&a_s[k][ty * 8 + 4]);
      *reinterpret_cast<float4*>(&bv[0]) =
          *reinterpret_cast<const float4*>(&b_s[k][tx * 8]);
      *reinterpret_cast<float4*>(&bv[4]) =
          *reinterpret_cast<const float4*>(&b_s[k][tx * 8 + 4]);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  float tmax[8], tmin[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    tmax[j] = -CUDART_INF_F;
    tmin[j] = CUDART_INF_F;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long r = row0 + ty * 8 + i;
    const bool valid = r < n_valid;
    const float bb = bias != nullptr ? bias[r] : 0.f;
    const bool alive = valid && bb >= 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      tmax[j] = fmaxf(tmax[j], valid ? acc[i][j] + bb : -CUDART_INF_F);
      if (alive) tmin[j] = fminf(tmin[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    red_max[ty][tx * 8 + j] = tmax[j];
    red_min[ty][tx * 8 + j] = tmin[j];
  }
  __syncthreads();
  if (tid < kQ) {
    const int col = col0 + tid;
    float m = -CUDART_INF_F, mn = CUDART_INF_F;
#pragma unroll
    for (int t = 0; t < 16; ++t) {
      m = fmaxf(m, red_max[t][tid]);
      mn = fminf(mn, red_min[t][tid]);
    }
    if (col < b) {
      const long long o = static_cast<long long>(blockIdx.x) * b + col;
      out_max[o] = m;
      if (out_min != nullptr) out_min[o] = mn;
    }
  }
}

}  // namespace

// docs [n_rows, d] (float32, or bf16 when docs_bf16), q [b, d] float32,
// bias [n_rows] float32 or null; n_rows % 128 == 0, d % 16 == 0.
// out_max (and out_min unless null) [n_rows / 128, b] float32.
extern "C" int hst_tile_stats_v1(const void* docs, int docs_bf16, const float* q,
                                 const float* bias, long long n_rows, int d, int b,
                                 long long n_valid, float* out_max, float* out_min,
                                 void* stream) {
  const dim3 grid(static_cast<unsigned>(n_rows / kTile),
                  static_cast<unsigned>((b + kQ - 1) / kQ));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (docs_bf16)
    tile_stats_v1_kernel<true><<<grid, kThreads, 0, s>>>(docs, q, bias, d, b, n_valid,
                                                         out_max, out_min);
  else
    tile_stats_v1_kernel<false><<<grid, kThreads, 0, s>>>(docs, q, bias, d, b, n_valid,
                                                          out_max, out_min);
  return static_cast<int>(cudaGetLastError());
}

// -- the redesign (hst_tile_stats) ---------------------------------------------

namespace k1 {

constexpr int kK = 16;              // depth a stage
constexpr int kAPitch = kTile + 4;  // floats a depth row of the depth-major doc stage

// BQ queries a block; TN queries a thread (its register tile is 8 x TN:
// rows ty*4 + 0..3 and 64 + ty*4 + 0..3, queries tx*4 + 4*(BQ/TN)*m + 0..3);
// kMinB blocks an SM, which caps the registers a thread may take; kRing
// stages in the copy ring (kRing - 2 ahead of the stage being transposed)
template <int BQ, int TN, int kMinB, int kRing, bool kBf16>
struct Cfg {
  static constexpr int kQG = BQ / TN;        // query groups (tx)
  static constexpr int kThreads = 16 * kQG;  // x 16 row groups (ty)
  static constexpr int kRawPitch = kBf16 ? 48 : 80;  // bytes a doc row of a raw stage
  static constexpr int kRawBytes = kTile * kRawPitch;
  static constexpr int kBPitch = BQ + 4;     // floats a depth row of a query stage
  static constexpr int kQBytes = kK * kBPitch * 4;
  static constexpr int kABytes = kK * kAPitch * 4;
  // raw doc ring, query ring, two depth-major doc stages, the epilogue's red
  static constexpr int kSmem =
      kRing * (kRawBytes + kQBytes) + 2 * kABytes + 2 * 16 * BQ * 4;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The raw doc stage's 16-byte pieces: float32, 512 pieces of four depths,
// a warp taking 16 rows x 2 quads (two lanes a 32-byte sector); bf16, 256
// pieces of eight depths, a warp taking 32 rows. Each thread copies its
// pieces and later transposes the same pieces, so its own wait_group is
// all the transpose waits for. Both the raw reads and the depth-major
// stores hit distinct banks.
template <bool kBf16>
__device__ __forceinline__ void piece(int c, int& r, int& part) {
  const int w = c / 32, l = c % 32;
  if (kBf16) {
    r = (w % 4) * 32 + l;
    part = w / 4;
  } else {
    r = (w % 8) * 16 + l % 16;
    part = 2 * (w / 8) + l / 16;
  }
}

template <int BQ, int TN, int kMinB, int kRing, bool kBf16>
__global__ void __launch_bounds__(Cfg<BQ, TN, kMinB, kRing, kBf16>::kThreads, kMinB)
tile_stats_kernel(const void* __restrict__ docs_v, const float* __restrict__ qt,
                  const float* __restrict__ bias, int n_tiles, int d, int b, int b_pad,
                  long long n_valid, float* __restrict__ out_max,
                  float* __restrict__ out_min) {
  using C = Cfg<BQ, TN, kMinB, kRing, kBf16>;
  constexpr int T = C::kThreads;
  constexpr int kPer = kTile * kK / (kBf16 ? 8 : 4) / T;  // doc pieces a thread
  constexpr int kQPer = BQ * kK / 4 / T;                   // query pieces a thread
  static_assert(kPer * T == kTile * kK / (kBf16 ? 8 : 4), "doc pieces");
  static_assert(kRing >= 3, "the ring runs at least one stage ahead");
  extern __shared__ float4 smem4[];
  unsigned char* raw = reinterpret_cast<unsigned char*>(smem4);   // [kRing] raw docs
  unsigned char* qring = raw + kRing * C::kRawBytes;              // [kRing] queries
  float* astage = reinterpret_cast<float*>(qring + kRing * C::kQBytes);  // [2]
  float* red_max = astage + 2 * kK * kAPitch;                     // [16][BQ]
  float* red_min = red_max + 16 * BQ;

  const int tid = threadIdx.x;
  const int tx = tid % C::kQG, ty = tid / C::kQG;
  const int n_k = d / kK;
  const int n_qb = b_pad / BQ;
  const int n_items = n_tiles * n_qb;
  const int my_items = n_items > static_cast<int>(blockIdx.x)
                           ? (n_items - 1 - static_cast<int>(blockIdx.x)) / gridDim.x + 1
                           : 0;
  const int n_stages = my_items * n_k;

  // The producer walks this block's items (blockIdx.x, + gridDim.x, ...)
  // and their depth slices, kRing - 1 stages ahead of the FMAs: raw doc
  // rows and the depth-major query slice (qt [d, b_pad]) by cp.async.
  int ld_item = static_cast<int>(blockIdx.x) - static_cast<int>(gridDim.x);
  int ld_k = n_k, ld_slot = 0;
  const unsigned char* ld_a = nullptr;  // the item's doc tile
  const float* ld_q = nullptr;          // the item's first query column
  auto issue = [&]() {
    if (ld_k == n_k) {
      ld_item += gridDim.x;
      ld_k = 0;
      const int tile = ld_item / n_qb, qb = ld_item - tile * n_qb;
      ld_a = static_cast<const unsigned char*>(docs_v) +
             static_cast<long long>(tile) * kTile * d * (kBf16 ? 2 : 4);
      ld_q = qt + qb * BQ;
    }
    unsigned char* rs = raw + ld_slot * C::kRawBytes;
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      int r, part;
      piece<kBf16>(tid + p * T, r, part);
      cp_async16(rs + r * C::kRawPitch + part * 16,
                 ld_a + (static_cast<long long>(r) * d + ld_k * kK) * (kBf16 ? 2 : 4) +
                     part * 16);
    }
    float* qs = reinterpret_cast<float*>(qring + ld_slot * C::kQBytes);
#pragma unroll
    for (int p = 0; p < kQPer; ++p) {
      const int c = tid + p * T;
      const int kk = c / (BQ / 4), col = (c % (BQ / 4)) * 4;
      cp_async16(qs + kk * C::kBPitch + col,
                 ld_q + static_cast<long long>(ld_k * kK + kk) * b_pad + col);
    }
    ++ld_k;
    ld_slot = ld_slot == kRing - 1 ? 0 : ld_slot + 1;
  };
  // this thread's raw pieces of ring slot `slot` into depth-major stage `buf`
  auto transpose = [&](int slot, int buf) {
    const unsigned char* rs = raw + slot * C::kRawBytes;
    float* as = astage + buf * kK * kAPitch;
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      int r, part;
      piece<kBf16>(tid + p * T, r, part);
      const uint4 v = *reinterpret_cast<const uint4*>(rs + r * C::kRawPitch + part * 16);
      if (kBf16) {  // widen: exact, as __bfloat162float
        const unsigned u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          as[(part * 8 + 2 * e) * kAPitch + r] = __uint_as_float(u[e] << 16);
          as[(part * 8 + 2 * e + 1) * kAPitch + r] = __uint_as_float(u[e] & 0xffff0000u);
        }
      } else {
        as[(part * 4 + 0) * kAPitch + r] = __uint_as_float(v.x);
        as[(part * 4 + 1) * kAPitch + r] = __uint_as_float(v.y);
        as[(part * 4 + 2) * kAPitch + r] = __uint_as_float(v.z);
        as[(part * 4 + 3) * kAPitch + r] = __uint_as_float(v.w);
      }
    }
  };

  float acc[8][TN];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  // prologue: stages 0 .. kRing-2 in flight, stage 0 transposed, stage 1 in
#pragma unroll
  for (int g = 0; g < kRing - 1; ++g) {
    if (g < n_stages) issue();
    cp_async_commit();
  }
  cp_async_wait<kRing - 2>();
  if (n_stages > 0) transpose(0, 0);
  cp_async_wait<kRing - 3>();
  __syncthreads();

  int item = blockIdx.x, k = 0, slot = 0;  // the consumer's place
  for (int s = 0; s < n_stages; ++s) {
    if (s + kRing - 1 < n_stages) issue();  // into the slot stage s - 1 left
    cp_async_commit();

    const float* as = astage + (s & 1) * kK * kAPitch;
    const float* qs = reinterpret_cast<const float*>(qring + slot * C::kQBytes);
#pragma unroll
    for (int kk = 0; kk < kK; ++kk) {
      float av[8], bv[TN];
      *reinterpret_cast<float4*>(&av[0]) =
          *reinterpret_cast<const float4*>(as + kk * kAPitch + ty * 4);
      *reinterpret_cast<float4*>(&av[4]) =
          *reinterpret_cast<const float4*>(as + kk * kAPitch + 64 + ty * 4);
#pragma unroll
      for (int m = 0; m < TN / 4; ++m)
        *reinterpret_cast<float4*>(&bv[4 * m]) = *reinterpret_cast<const float4*>(
            qs + kk * C::kBPitch + tx * 4 + 4 * C::kQG * m);
      // one fmaf a depth: each score is one chain over depth 0..d-1
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    slot = slot == kRing - 1 ? 0 : slot + 1;
    if (s + 1 < n_stages) transpose(slot, (s + 1) & 1);  // landed: waited below
    cp_async_wait<kRing - 3>();  // stage s + 2 is in (this thread's copies)

    if (++k == n_k) {  // the item's last slice: its epilogue
      const int tile = item / n_qb, qb = item - tile * n_qb;
      item += gridDim.x;
      k = 0;
      float tmax[TN], tmin[TN];
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        tmax[j] = -CUDART_INF_F;
        tmin[j] = CUDART_INF_F;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const long long r =
            static_cast<long long>(tile) * kTile + (i / 4) * 64 + ty * 4 + i % 4;
        const bool valid = r < n_valid;
        const float bb = bias != nullptr ? bias[r] : 0.f;
        const bool alive = valid && bb >= 0.f;
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          tmax[j] = fmaxf(tmax[j], valid ? acc[i][j] + bb : -CUDART_INF_F);
          if (alive) tmin[j] = fminf(tmin[j], acc[i][j]);
          acc[i][j] = 0.f;
        }
      }
      // red is read back before any thread passes this stage's last barrier
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int col = tx * 4 + 4 * C::kQG * (j / 4) + j % 4;
        red_max[ty * BQ + col] = tmax[j];
        red_min[ty * BQ + col] = tmin[j];
      }
      __syncthreads();
      if (tid < BQ) {
        const int col = qb * BQ + tid;
        float m = -CUDART_INF_F, mn = CUDART_INF_F;
#pragma unroll
        for (int t = 0; t < 16; ++t) {
          m = fmaxf(m, red_max[t * BQ + tid]);
          mn = fminf(mn, red_min[t * BQ + tid]);
        }
        if (col < b) {
          const long long o = static_cast<long long>(tile) * b + col;
          out_max[o] = m;
          if (out_min != nullptr) out_min[o] = mn;
        }
      }
    }
    __syncthreads();  // stage s + 1 is transposed and its queries are in
  }
  cp_async_wait<0>();
}

template <int BQ, int TN, int kMinB, int kRing, bool kBf16>
int launch(const void* docs, const float* qt, const float* bias, long long n_tiles, int d,
           int b, long long n_valid, float* out_max, float* out_min, cudaStream_t s) {
  using C = Cfg<BQ, TN, kMinB, kRing, kBf16>;
  auto kernel = tile_stats_kernel<BQ, TN, kMinB, kRing, kBf16>;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               C::kSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, C::kThreads,
                                                        C::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int n_qb = (b + BQ - 1) / BQ;
  const long long n_items = n_tiles * n_qb;
  if (n_items > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  long long grid = static_cast<long long>(per_sm) * sms;
  // a whole number of tiles a wave, so a tile's query blocks run together
  if (grid >= n_qb) grid -= grid % n_qb;
  if (grid > n_items) grid = n_items;
  kernel<<<static_cast<unsigned>(grid), C::kThreads, C::kSmem, s>>>(
      docs, qt, bias, static_cast<int>(n_tiles), d, b, n_qb * BQ, n_valid, out_max,
      out_min);
  return static_cast<int>(cudaGetLastError());
}

template <int BQ, int TN, int kMinB, int kRing>
int launch_dtype(const void* docs, int docs_bf16, const float* qt, const float* bias,
                 long long n_tiles, int d, int b, long long n_valid, float* out_max,
                 float* out_min, cudaStream_t s) {
  return docs_bf16 ? launch<BQ, TN, kMinB, kRing, true>(docs, qt, bias, n_tiles, d, b,
                                                        n_valid, out_max, out_min, s)
                   : launch<BQ, TN, kMinB, kRing, false>(docs, qt, bias, n_tiles, d, b,
                                                         n_valid, out_max, out_min, s);
}

}  // namespace k1

// The redesign: the same arguments and outputs as hst_tile_stats_v1, but
// the queries come depth-major, qt [d, ceil(b / bq) * bq] float32 with
// zero columns past b; bq is the query-block width (32, 64, 128 or 256;
// the wrapper picks it from b). d % 16 == 0; docs 16-byte aligned.
extern "C" int hst_tile_stats(const void* docs, int docs_bf16, const float* qt,
                              const float* bias, long long n_rows, int d, int b,
                              long long n_valid, float* out_max, float* out_min,
                              int bq, void* stream) {
  const long long n_tiles = n_rows / kTile;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_tiles == 0 || b == 0) return 0;
  // (BQ, TN, blocks an SM, ring stages): the fastest of the variants timed
  // on an H100 at 524,288 x 384 float32 docs and B = BQ
  switch (bq) {
    case 32:
      return k1::launch_dtype<32, 8, 4, 3>(docs, docs_bf16, qt, bias, n_tiles, d, b,
                                           n_valid, out_max, out_min, s);
    case 64:
      return k1::launch_dtype<64, 8, 3, 3>(docs, docs_bf16, qt, bias, n_tiles, d, b,
                                           n_valid, out_max, out_min, s);
    case 128:
      return k1::launch_dtype<128, 8, 2, 4>(docs, docs_bf16, qt, bias, n_tiles, d, b,
                                            n_valid, out_max, out_min, s);
    case 256:
      return k1::launch_dtype<256, 16, 1, 4>(docs, docs_bf16, qt, bias, n_tiles, d, b,
                                             n_valid, out_max, out_min, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
