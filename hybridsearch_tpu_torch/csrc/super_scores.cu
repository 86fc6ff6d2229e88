// K2 and K4: raw dot scores of every doc row in each query's probed
// supertiles.
//
// Replaces: hybridsearch_tpu/ops/pallas_supertile.py pallas_super_scores (K2)
// and pallas_super_scores_dedup (K4).
//
// K2: out[b, s*sd + c*ch + i] = dot(q[b], docs[min(sup[b,s]*(sd/ch) + c, last)*ch + i])
// for every probed supertile s of query b, chunk c < sd/ch and row i < ch,
// where last = N/ch - 1: chunk indices past the end clamp to the last chunk
// (capacity-padded supertiles), exactly as the TPU kernel. The caller applies
// bias and validity.
//
// K4: out[p, c*ch + i] = dot(qp[p], docs[min(tid[p]*(sd/ch) + c, last)*ch + i])
// for P (query, probe) pairs that the caller sorted by supertile id
// (ops/supertile.py dedup_pairs) with their query rows gathered (qp); the
// caller unpermutes the [P, sd] result to K2's [B, S*sd] layout.
//
// Bound on the H100 at the slice's shapes (B = 256, S = 2..16, sd = 16384,
// D = 384, float32): a read of the rows of the union of probed supertiles
// (at most the 805 MB corpus) plus the [B, S*sd] output (34 MB at S = 2,
// 268 MB at S = 16), against 2*B*S*sd*D = 6.4 GFLOP at S = 2 and 51.5 GFLOP
// at S = 16 of float32 FMA: bytes-bound at small S, operations-bound at the
// deepest rung. The products stay float32 FMA, as in K1 (tile_stats.cu): the
// certificate compares the two and is sound only while they differ by
// summation order alone.
//
// Design: the queries of a batch that probe the same supertile share its
// rows, so the rows are read once per group of queries, not once per query.
// Both kernels score a group with one grouped register-tiled SGEMM body
// (score_rows): each 256-thread block owns 256 rows of one supertile and up
// to 32 pairs; each thread accumulates an 8-row x 4-pair register tile over
// depth slices of 16 staged through shared memory (docs transposed so the
// inner loop reads two float4 of rows and one of pairs). A pair's sum runs
// over depth in one fixed order whatever group or slot it lands in, so K2
// and K4 give the same bits for a pair, and neither depends on the order in
// which pairs were grouped. bf16 docs are widened on load; their products
// with bf16-rounded queries are exact in float32, matching K1.
//
// Who groups the pairs is what differs. K2 takes the batch's [B, S] probe
// table as it is: a one-block pre-pass counting-sorts the B*S pairs by
// supertile inside the launch (shared-memory atomics, one thread laying out
// the groups) and cuts each supertile's pairs into groups of 32. K4 takes
// pairs the caller already sorted (a stable argsort of B*S keys and a
// gather of their query rows, outside the kernel) and needs no pre-pass:
// block x reads the 32 sorted pairs x*32 .. x*32+31 and scores each run of
// equal ids among them in turn, so a run that crosses a 32-boundary is split
// there. Blocks of the same rows are launched next to each other in both,
// so a supertile's groups reread its rows from L2.
//
// Left to gain: K2 already reads a supertile's rows once per 32 pairs, so
// the caller's sort saves only K2's one-block pre-pass, and the fixed
// 32-pair windows cost more than that: a block scores the 2-3 runs of its
// window one after another, where K2 gives each run its own blocks. On an
// H100 SXM (700 W) at B = 256 on 524,288 x 384 float32 docs, K4 took 18%
// (S = 16) to 50% (S = 2) longer than K2 (PERF.md). A group table aligned
// to the runs (one block scanning the sorted ids) would bring K4 to K2's
// passes; writing each pair's rows to its query-major place would drop the
// caller's unpermute.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kRows = 256;    // supertile rows per block
constexpr int kPairs = 32;    // (query, probe) pairs per group
constexpr int kK = 16;        // depth per shared-memory stage
constexpr int kThreads = 256;
constexpr int kGroupThreads = 1024;

// Supertile ids below 0 read chunk 0 throughout and ids of tk or more the
// last chunk throughout, so they group under -1 and tk.
__device__ __forceinline__ int key_of(int sup, int tk) {
  return sup < 0 ? -1 : (sup > tk ? tk : sup);
}

// sup [n_pairs] -> order [n_pairs] (pair ids grouped by key), and per group
// its start in order, its length (0 for unused groups) and its key.
__global__ void __launch_bounds__(kGroupThreads)
group_pairs_kernel(const int* __restrict__ sup, int n_pairs, int tk,
                   int* __restrict__ order, int* __restrict__ g_start,
                   int* __restrict__ g_len, int* __restrict__ g_key, int g_max) {
  extern __shared__ int cnt[];  // [n_keys] counts, then [n_keys] cursors
  const int n_keys = tk + 2;
  int* cur = cnt + n_keys;
  __shared__ int n_groups;
  for (int k = threadIdx.x; k < n_keys; k += kGroupThreads) cnt[k] = 0;
  __syncthreads();
  for (int p = threadIdx.x; p < n_pairs; p += kGroupThreads)
    atomicAdd(&cnt[key_of(sup[p], tk) + 1], 1);
  __syncthreads();
  if (threadIdx.x == 0) {
    int off = 0, g = 0;
    for (int k = 0; k < n_keys; ++k) {
      cur[k] = off;
      for (int j = 0; j < cnt[k]; j += kPairs, ++g) {
        g_start[g] = off + j;
        g_len[g] = min(kPairs, cnt[k] - j);
        g_key[g] = k - 1;
      }
      off += cnt[k];
    }
    n_groups = g;
  }
  __syncthreads();
  for (int g = n_groups + threadIdx.x; g < g_max; g += kGroupThreads) g_len[g] = 0;
  for (int p = threadIdx.x; p < n_pairs; p += kGroupThreads)
    order[atomicAdd(&cur[key_of(sup[p], tk) + 1], 1)] = p;
}

// Scores rows row0 .. row0+255 (the block's rows of one supertile, its
// first row local0 inside the supertile) against the pairs in pair_s (-1 =
// empty slot): pair p reads query row q + (p / q_div) * d and writes
// out + p * sd + local0. The caller fills pair_s and synchronises first.
template <bool kBf16>
__device__ __forceinline__ void score_rows(
    const void* __restrict__ docs_v, const float* __restrict__ q,
    const int* pair_s, int q_div, int d, int sd, int local0, long long row0,
    float (*a_s)[kRows], float (*b_s)[kPairs], float* __restrict__ out) {
  const int tid = threadIdx.x;
  const int tx = tid % 8;  // pair group: slots tx*4 .. tx*4+3
  const int ty = tid / 8;  // row group: rows ty*8 .. ty*8+7

  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < d; k0 += kK) {
    if (kBf16) {
      // 256 rows x 16 bf16 = 512 chunks of 8 bf16 (16 bytes): two each
      const __nv_bfloat16* docs = static_cast<const __nv_bfloat16*>(docs_v);
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const int e = tid + p * kThreads;
        const int r = e / 2, c = (e % 2) * 8;
        const uint4 raw =
            *reinterpret_cast<const uint4*>(docs + (row0 + r) * d + k0 + c);
        const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
        for (int i = 0; i < 8; ++i) a_s[c + i][r] = __bfloat162float(h[i]);
      }
    } else {
      // 256 rows x 16 floats = 1024 float4: four each
      const float* docs = static_cast<const float*>(docs_v);
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const int e = tid + p * kThreads;
        const int r = e / 4, c = (e % 4) * 4;
        const float4 v =
            *reinterpret_cast<const float4*>(docs + (row0 + r) * d + k0 + c);
        a_s[c][r] = v.x;
        a_s[c + 1][r] = v.y;
        a_s[c + 2][r] = v.z;
        a_s[c + 3][r] = v.w;
      }
    }
    if (tid < kPairs * kK / 4) {
      // 32 pairs x 16 floats = 128 float4
      const int slot = tid / 4, c = (tid % 4) * 4;
      const int p = pair_s[slot];
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (p >= 0)
        v = *reinterpret_cast<const float4*>(
            q + static_cast<long long>(p / q_div) * d + k0 + c);
      b_s[c][slot] = v.x;
      b_s[c + 1][slot] = v.y;
      b_s[c + 2][slot] = v.z;
      b_s[c + 3][slot] = v.w;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kK; ++k) {
      float av[8], bv[4];
      *reinterpret_cast<float4*>(&av[0]) =
          *reinterpret_cast<const float4*>(&a_s[k][ty * 8]);
      *reinterpret_cast<float4*>(&av[4]) =
          *reinterpret_cast<const float4*>(&a_s[k][ty * 8 + 4]);
      *reinterpret_cast<float4*>(&bv[0]) =
          *reinterpret_cast<const float4*>(&b_s[k][tx * 4]);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int p = pair_s[tx * 4 + j];
    if (p < 0) continue;
    float* o = out + static_cast<long long>(p) * sd + local0 + ty * 8;
    *reinterpret_cast<float4*>(o) =
        make_float4(acc[0][j], acc[1][j], acc[2][j], acc[3][j]);
    *reinterpret_cast<float4*>(o + 4) =
        make_float4(acc[4][j], acc[5][j], acc[6][j], acc[7][j]);
  }
}

// First doc row of the block's 256 rows of supertile key: chunk indices
// below 0 or past the last chunk clamp into [0, last_chunk].
__device__ __forceinline__ long long first_row(int key, int sd, int ch, int local0,
                                               long long last_chunk) {
  long long idx = static_cast<long long>(key) * (sd / ch) + local0 / ch;
  idx = idx < 0 ? 0 : (idx > last_chunk ? last_chunk : idx);
  return idx * ch + local0 % ch;
}

template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
super_scores_kernel(const void* __restrict__ docs_v, const float* __restrict__ q,
                    const int* __restrict__ order, const int* __restrict__ g_start,
                    const int* __restrict__ g_len, const int* __restrict__ g_key,
                    int n_probe, int d, int sd, int ch, long long last_chunk,
                    float* __restrict__ out) {
  const int g = blockIdx.x;
  const int len = g_len[g];
  if (len == 0) return;
  __shared__ __align__(16) float a_s[kK][kRows];   // docs, [depth][row]
  __shared__ __align__(16) float b_s[kK][kPairs];  // queries, [depth][pair]
  __shared__ int pair_s[kPairs];
  const int local0 = blockIdx.y * kRows;  // first row inside the supertile
  if (threadIdx.x < kPairs)
    pair_s[threadIdx.x] = threadIdx.x < len ? order[g_start[g] + threadIdx.x] : -1;
  __syncthreads();
  // pair p = b * n_probe + s owns out[b, s*sd : (s+1)*sd] = out + p*sd
  score_rows<kBf16>(docs_v, q, pair_s, n_probe, d, sd, local0,
                    first_row(g_key[g], sd, ch, local0, last_chunk), a_s, b_s, out);
}

template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
super_scores_dedup_kernel(const void* __restrict__ docs_v,
                          const float* __restrict__ qp, const int* __restrict__ tid,
                          int n_pairs, int tk, int d, int sd, int ch,
                          long long last_chunk, float* __restrict__ out) {
  __shared__ __align__(16) float a_s[kK][kRows];
  __shared__ __align__(16) float b_s[kK][kPairs];
  __shared__ int pair_s[kPairs];
  __shared__ int key_s[kPairs];
  const int p0 = blockIdx.x * kPairs;
  const int len = min(kPairs, n_pairs - p0);
  const int local0 = blockIdx.y * kRows;
  if (threadIdx.x < kPairs && threadIdx.x < len)
    key_s[threadIdx.x] = key_of(tid[p0 + threadIdx.x], tk);
  __syncthreads();
  // one pass of the SGEMM body per run of equal keys among the 32 pairs
  for (int s0 = 0; s0 < len;) {
    const int key = key_s[s0];
    int s1 = s0 + 1;
    while (s1 < len && key_s[s1] == key) ++s1;
    if (threadIdx.x < kPairs)
      pair_s[threadIdx.x] =
          threadIdx.x >= s0 && threadIdx.x < s1 ? p0 + threadIdx.x : -1;
    __syncthreads();
    // pair p owns out[p, :] = out + p*sd
    score_rows<kBf16>(docs_v, qp, pair_s, 1, d, sd, local0,
                      first_row(key, sd, ch, local0, last_chunk), a_s, b_s, out);
    __syncthreads();  // the epilogue's reads of pair_s before the next run
    s0 = s1;
  }
}

}  // namespace

// docs [n_rows, d] (float32, or bf16 when docs_bf16), q [b, d] float32,
// sup [b, n_probe] int32, work int32 of n_pairs + 3 * g_max ints (n_pairs =
// b * n_probe, g_max = ceil(n_pairs / 32) + tk + 2, tk = ceil(n_rows / sd));
// d % 16 == 0, sd % ch == 0, ch % 256 == 0, n_rows % ch == 0,
// tk + 2 <= 6144. out [b, n_probe * sd] float32.
extern "C" int hst_super_scores(const void* docs, int docs_bf16, const float* q,
                                const int* sup, long long n_rows, int d, int b,
                                int n_probe, int sd, int ch, int* work,
                                float* out, void* stream) {
  const int nch = sd / ch;
  const long long n_chunks = n_rows / ch;
  const int tk = static_cast<int>((n_chunks + nch - 1) / nch);
  const long long n_pairs = static_cast<long long>(b) * n_probe;
  const long long g_max = (n_pairs + kPairs - 1) / kPairs + tk + 2;
  int* order = work;
  int* g_start = order + n_pairs;
  int* g_len = g_start + g_max;
  int* g_key = g_len + g_max;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = static_cast<size_t>(2 * (tk + 2)) * sizeof(int);
  group_pairs_kernel<<<1, kGroupThreads, smem, s>>>(
      sup, static_cast<int>(n_pairs), tk, order, g_start, g_len, g_key,
      static_cast<int>(g_max));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(g_max), static_cast<unsigned>(sd / kRows));
  if (docs_bf16)
    super_scores_kernel<true><<<grid, kThreads, 0, s>>>(
        docs, q, order, g_start, g_len, g_key, n_probe, d, sd, ch, n_chunks - 1, out);
  else
    super_scores_kernel<false><<<grid, kThreads, 0, s>>>(
        docs, q, order, g_start, g_len, g_key, n_probe, d, sd, ch, n_chunks - 1, out);
  return static_cast<int>(cudaGetLastError());
}

// docs as for hst_super_scores, qp [n_pairs, d] float32 (query row of each
// pair), tid [n_pairs] int32 supertile ids (sorted ascending for one read
// of a supertile's rows per 32 pairs; any order gives the same values).
// out [n_pairs, sd] float32.
extern "C" int hst_super_scores_dedup(const void* docs, int docs_bf16,
                                      const float* qp, const int* tid,
                                      long long n_rows, int d, int n_pairs,
                                      int sd, int ch, float* out, void* stream) {
  const int nch = sd / ch;
  const long long n_chunks = n_rows / ch;
  const int tk = static_cast<int>((n_chunks + nch - 1) / nch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>((n_pairs + kPairs - 1) / kPairs),
                  static_cast<unsigned>(sd / kRows));
  if (docs_bf16)
    super_scores_dedup_kernel<true><<<grid, kThreads, 0, s>>>(
        docs, qp, tid, n_pairs, tk, d, sd, ch, n_chunks - 1, out);
  else
    super_scores_dedup_kernel<false><<<grid, kThreads, 0, s>>>(
        docs, qp, tid, n_pairs, tk, d, sd, ch, n_chunks - 1, out);
  return static_cast<int>(cudaGetLastError());
}
