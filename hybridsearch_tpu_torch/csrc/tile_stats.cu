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
// reads, i.e. operations-bound (67 TFLOP/s float32 vs 3.35 TB/s). The
// products must stay float32 FMA (no TF32, no tensor cores): the supertile
// certificate compares these tile maxima with the resident scores of K2 and
// is sound only while the two differ by summation order alone.
//
// Design: a register-tiled SGEMM. Each 256-thread block owns one 128-row
// tile and 128 queries; each thread accumulates an 8x8 register tile over
// depth slices of 16 staged through shared memory (docs and queries stored
// transposed so the inner loop reads two float4 of each). The epilogue
// reduces max/min over the thread's 8 rows, then over the 16 thread rows
// through shared memory, and writes one value per (tile, query). bf16 docs
// are widened to float32 on load; their products with bf16-rounded queries
// are exact in float32, so accumulation is float32 as for float32 docs.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math_constants.h>

namespace {

constexpr int kTile = 128;    // doc rows per tile (one block)
constexpr int kQ = 128;       // queries per block
constexpr int kK = 16;        // depth per shared-memory stage
constexpr int kThreads = 256;

template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
tile_stats_kernel(const void* __restrict__ docs_v, const float* __restrict__ q,
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
extern "C" int hst_tile_stats(const void* docs, int docs_bf16, const float* q,
                              const float* bias, long long n_rows, int d, int b,
                              long long n_valid, float* out_max, float* out_min,
                              void* stream) {
  const dim3 grid(static_cast<unsigned>(n_rows / kTile),
                  static_cast<unsigned>((b + kQ - 1) / kQ));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (docs_bf16)
    tile_stats_kernel<true><<<grid, kThreads, 0, s>>>(docs, q, bias, d, b, n_valid,
                                                      out_max, out_min);
  else
    tile_stats_kernel<false><<<grid, kThreads, 0, s>>>(docs, q, bias, d, b, n_valid,
                                                       out_max, out_min);
  return static_cast<int>(cudaGetLastError());
}
