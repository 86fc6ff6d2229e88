// K2 and K4: raw dot scores of every doc row in each query's probed
// units (supertiles, or single 128-row tiles).
//
// Replaces: hybridsearch_tpu/ops/pallas_supertile.py pallas_super_scores (K2)
// and pallas_super_scores_dedup (K4); K4 at sd = ch = 128 also serves pass 3
// of the dense top-k (ops/dense.py gather_tile_scores), which the JAX
// package computes with jnp.take + einsum.
//
// K2: out[b, s*sd + c*ch + i] = dot(q[b], docs[min(sup[b,s]*(sd/ch) + c, last)*ch + i])
// for every probed unit s of query b, chunk c < sd/ch and row i < ch, where
// last = N/ch - 1: chunk indices below 0 or past the end clamp into
// [0, last] (capacity-padded supertiles), exactly as the TPU kernel. The
// caller applies bias and validity.
//
// K4: out[dst[p], c*ch + i] = dot(q[qid[p]], docs[min(tid[p]*(sd/ch) + c, last)*ch + i])
// for P pairs the wrapper sorted by unit id (ops/cuda_supertile.py
// sort_pairs): each pair reads its query row by index and writes its rows
// straight to their query-major place, so with dst = b*S + s the [P, sd]
// output is K2's [B, S*sd] layout and needs no unpermute.
//
// Bound on the H100 at the slice's shapes (B = 256, D = 384, float32): a
// read of the rows of the union of probed units (at most the 805 MB corpus)
// plus the output (B*S*sd*4 bytes: 34 MB at S = 2, 268 MB at S = 16 and at
// pass 3's 2,048 tiles a query), against 2*B*S*sd*D FLOP (6.4 GFLOP at
// S = 2, 51.5 at S = 16) of float32 FMA: bytes-bound at small S,
// operations-bound at the deepest rung. The products stay float32 FMA, one
// fmaf chain a score over depth 0..D-1 from 0.f, as in K1 (tile_stats.cu):
// the certificate compares the two and is sound only while they differ by
// summation order alone. So no TF32, no tensor core, no split-K, and every
// design below gives the same bits for a pair, whatever group or slot it
// lands in.
//
// Design (score_kernel, shared by K2 and K4): the pairs that probe one
// unit share its rows, so a block serves one (group, RB-row block): a group
// is at most PW pairs of one unit, cut from the run of its key in sorted
// order (no group straddles two runs). The rows of the block stream through
// a ring of kRing stages of 16 depths filled by cp.async (raw doc rows, and
// the group's query rows read by index), kRing - 2 stages ahead of the
// FMAs; each thread transposes the pieces it copied itself into one of two
// depth-major stages after its own wait_group (K1's scheme, so no extra
// barrier), widening bf16 exactly as __bfloat162float. A thread holds an
// 8-row x TN-pair register tile (TN = 8): its operands of one depth are two
// 16-byte reads of rows and two of pairs. A warp whose pairs are all past
// the group's length skips the FMAs (a group of 10 pairs keeps one warp of
// a 128-pair block busy). On an H100 (700 W) the body reaches 54% of the
// float32 bound when every group is full and 45% on random probes at
// S = 16, where runs of about the mean length leave groups half empty; a
// 16-wide pair tile, 256 rows a block at PW = 128, and cutting runs into
// equal groups instead of full ones plus a remainder measured at most 1%
// faster (chip_probes.py, PERF.md). RB is 128 or 256 (a template parameter; sd = ch =
// 128, one tile, is a valid shape) and PW 32, 64 or 128, picked per launch
// from the mean pairs a unit (the wrapper's pair_width: the narrowest width
// that holds twice the mean, so most runs fit one group), as K1 picks its
// query block. Blocks of one unit's groups are launched side by side, so a
// unit's second group rereads its rows from L2.
//
// Who builds the group table is what differs. K2 takes the [B, S] probe
// table as it is: a one-block pre-pass counting-sorts the B*S pairs by unit
// inside the launch (shared-memory atomics for at most 6,144 keys, one
// thread laying out the groups). K4 takes pairs its wrapper sorted (one
// stable sort of the B*S keys) and builds the table with one thread a pair,
// no scan: the group that starts at sorted position i (every PW-th position
// of a run, found by two binary searches for the run's ends) goes to slot
// i / PW + key + 1, which grows strictly along the sorted order, so the
// slots are distinct and below ceil(P / PW) + n_keys, the grid's size; the
// surplus blocks read a length of 0 and return. No host sync sizes the
// grid.
//
// hst_super_scores_v1 / hst_super_scores_dedup_v1 are the first designs,
// kept as yardsticks for the bit-equality checks and the before/after
// times; no served path launches them. Both are a 256-thread block of 256
// rows x 32 pairs, an 8-row x 4-pair tile, depth 16 staged by plain loads
// with two barriers a slice; v1's K4 scores the runs inside fixed 32-pair
// windows one after another and writes [P, sd] in sorted order, which its
// caller unpermuted.

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
extern "C" int hst_super_scores_v1(const void* docs, int docs_bf16, const float* q,
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
extern "C" int hst_super_scores_dedup_v1(const void* docs, int docs_bf16,
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

// -- the redesign (hst_super_scores, hst_super_scores_dedup) ------------------

namespace ss {

constexpr int kK = 16;              // depth a stage
constexpr int kPrepThreads = 1024;  // K2's pre-pass block

// RB rows and PW pairs a block, TN pairs a thread (its register tile is
// 8 x TN: rows ty*4 + 0..3 and RB/2 + ty*4 + 0..3, pairs tx*TN + 0..TN-1),
// kMinB blocks an SM (caps the registers a thread may take), kRing stages in
// the copy ring
template <int RB, int PW, int TN, int kMinB, int kRing, bool kBf16>
struct Cfg {
  static constexpr int kRG = RB / 8;          // row groups (ty)
  static constexpr int kQG = PW / TN;         // pair groups (tx)
  static constexpr int kThreads = kRG * kQG;
  static constexpr int kRawPitch = kBf16 ? 48 : 80;  // bytes a doc row of a raw stage
  static constexpr int kRawBytes = RB * kRawPitch;
  static constexpr int kQRawBytes = PW * kK * 4;     // [4 parts][PW pairs] x 16 bytes
  static constexpr int kAPitch = RB + 4;      // floats a depth row of a doc stage
  static constexpr int kBPitch = PW + 4;      // floats a depth row of a pair stage
  static constexpr int kABytes = kK * kAPitch * 4;
  static constexpr int kBBytes = kK * kBPitch * 4;
  static constexpr int kSmem =
      kRing * (kRawBytes + kQRawBytes) + 2 * (kABytes + kBBytes);
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

// The raw doc stage's 16-byte pieces, as in K1 (tile_stats.cu) for RB rows:
// float32, RB*4 pieces of four depths, a warp taking 16 rows x 2 quads;
// bf16, RB*2 pieces of eight depths, a warp taking 32 rows. Each thread
// transposes the pieces it copied, so its own wait_group is all the
// transpose waits for.
template <int RB, bool kBf16>
__device__ __forceinline__ void piece(int c, int& r, int& part) {
  const int w = c / 32, l = c % 32;
  if (kBf16) {
    constexpr int n = RB / 32;
    r = (w % n) * 32 + l;
    part = w / n;
  } else {
    constexpr int n = RB / 16;
    r = (w % n) * 16 + l % 16;
    part = 2 * (w / n) + l / 16;
  }
}

// Block (g, y) scores rows y*RB .. y*RB + RB-1 of unit g_key[g] against the
// group's g_len[g] pairs from sorted position g_start[g]: pair j reads query
// row qid[g_start + j] and writes out + dst[g_start + j] * sd + y*RB.
template <int RB, int PW, int TN, int kMinB, int kRing, bool kBf16>
__global__ void __launch_bounds__(Cfg<RB, PW, TN, kMinB, kRing, kBf16>::kThreads, kMinB)
score_kernel(const void* __restrict__ docs_v, const float* __restrict__ q,
             const int* __restrict__ qid, const int* __restrict__ dst,
             const int* __restrict__ g_start, const int* __restrict__ g_len,
             const int* __restrict__ g_key, int d, int sd, int ch,
             long long last_chunk, float* __restrict__ out) {
  using C = Cfg<RB, PW, TN, kMinB, kRing, kBf16>;
  constexpr int T = C::kThreads;
  constexpr int kPer = RB * kK / (kBf16 ? 8 : 4) / T;  // doc pieces a thread
  constexpr int kQPer = PW * 4 / T;                     // query pieces a thread
  static_assert(kPer * T == RB * kK / (kBf16 ? 8 : 4), "doc pieces");
  static_assert(kQPer * T == PW * 4, "query pieces");
  static_assert(T % 32 == 0 && kRing >= 3 && TN % 4 == 0, "shape");
  const int g = blockIdx.x;
  const int len = g_len[g];
  if (len == 0) return;  // a surplus slot of the table
  extern __shared__ float4 smem4[];
  unsigned char* raw = reinterpret_cast<unsigned char*>(smem4);   // [kRing] docs
  unsigned char* qraw = raw + kRing * C::kRawBytes;               // [kRing] queries
  float* astage = reinterpret_cast<float*>(qraw + kRing * C::kQRawBytes);  // [2]
  float* bstage = astage + 2 * kK * C::kAPitch;                   // [2]
  __shared__ int s_q[PW], s_dst[PW];

  const int tid = threadIdx.x;
  const int tx = tid / C::kRG, ty = tid % C::kRG;
  // the warp's first pair: past the group's length, the warp skips the FMAs
  const bool idle = ((tid & ~31) / C::kRG) * TN >= len;
  const int start = g_start[g];
  if (tid < PW && tid < len) {
    s_q[tid] = qid[start + tid];
    s_dst[tid] = dst[start + tid];
  }
  const int local0 = blockIdx.y * RB;  // first row inside the unit
  long long idx = static_cast<long long>(g_key[g]) * (sd / ch) + local0 / ch;
  idx = idx < 0 ? 0 : (idx > last_chunk ? last_chunk : idx);
  const unsigned char* rows = static_cast<const unsigned char*>(docs_v) +
                              (idx * ch + local0 % ch) * d * (kBf16 ? 2 : 4);
  const int n_k = d / kK;
  __syncthreads();  // s_q

  auto issue = [&](int st) {
    const int slot = st % kRing;
    unsigned char* rs = raw + slot * C::kRawBytes;
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      int r, part;
      piece<RB, kBf16>(tid + p * T, r, part);
      cp_async16(rs + r * C::kRawPitch + part * 16,
                 rows + (static_cast<long long>(r) * d + st * kK) * (kBf16 ? 2 : 4) +
                     part * 16);
    }
    unsigned char* qs = qraw + slot * C::kQRawBytes;
#pragma unroll
    for (int p = 0; p < kQPer; ++p) {
      const int c = tid + p * T;
      const int pair = c % PW, part = c / PW;
      if (pair < len)
        cp_async16(qs + (part * PW + pair) * 16,
                   q + static_cast<long long>(s_q[pair]) * d + st * kK + part * 4);
    }
  };
  // this thread's raw pieces of stage st into depth-major stage buf
  auto transpose = [&](int st, int buf) {
    const int slot = st % kRing;
    const unsigned char* rs = raw + slot * C::kRawBytes;
    float* as = astage + buf * kK * C::kAPitch;
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      int r, part;
      piece<RB, kBf16>(tid + p * T, r, part);
      const uint4 v = *reinterpret_cast<const uint4*>(rs + r * C::kRawPitch + part * 16);
      if (kBf16) {  // widen: exact, as __bfloat162float
        const unsigned u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          as[(part * 8 + 2 * e) * C::kAPitch + r] = __uint_as_float(u[e] << 16);
          as[(part * 8 + 2 * e + 1) * C::kAPitch + r] =
              __uint_as_float(u[e] & 0xffff0000u);
        }
      } else {
        as[(part * 4 + 0) * C::kAPitch + r] = __uint_as_float(v.x);
        as[(part * 4 + 1) * C::kAPitch + r] = __uint_as_float(v.y);
        as[(part * 4 + 2) * C::kAPitch + r] = __uint_as_float(v.z);
        as[(part * 4 + 3) * C::kAPitch + r] = __uint_as_float(v.w);
      }
    }
    const unsigned char* qs = qraw + slot * C::kQRawBytes;
    float* bs = bstage + buf * kK * C::kBPitch;
#pragma unroll
    for (int p = 0; p < kQPer; ++p) {
      const int c = tid + p * T;
      const int pair = c % PW, part = c / PW;
      if (pair < len) {
        const float4 v = *reinterpret_cast<const float4*>(qs + (part * PW + pair) * 16);
        bs[(part * 4 + 0) * C::kBPitch + pair] = v.x;
        bs[(part * 4 + 1) * C::kBPitch + pair] = v.y;
        bs[(part * 4 + 2) * C::kBPitch + pair] = v.z;
        bs[(part * 4 + 3) * C::kBPitch + pair] = v.w;
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
  for (int st = 0; st < kRing - 1; ++st) {
    if (st < n_k) issue(st);
    cp_async_commit();
  }
  cp_async_wait<kRing - 2>();
  transpose(0, 0);
  cp_async_wait<kRing - 3>();
  __syncthreads();

  for (int s = 0; s < n_k; ++s) {
    if (s + kRing - 1 < n_k) issue(s + kRing - 1);  // into the slot stage s - 1 left
    cp_async_commit();
    if (!idle) {
      const float* as = astage + (s & 1) * kK * C::kAPitch;
      const float* bs = bstage + (s & 1) * kK * C::kBPitch;
#pragma unroll
      for (int kk = 0; kk < kK; ++kk) {
        float av[8], bv[TN];
        *reinterpret_cast<float4*>(&av[0]) =
            *reinterpret_cast<const float4*>(as + kk * C::kAPitch + ty * 4);
        *reinterpret_cast<float4*>(&av[4]) =
            *reinterpret_cast<const float4*>(as + kk * C::kAPitch + RB / 2 + ty * 4);
#pragma unroll
        for (int m = 0; m < TN / 4; ++m)
          *reinterpret_cast<float4*>(&bv[4 * m]) = *reinterpret_cast<const float4*>(
              bs + kk * C::kBPitch + tx * TN + 4 * m);
        // one fmaf a depth: each score is one chain over depth 0..d-1
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
    if (s + 1 < n_k) transpose(s + 1, (s + 1) & 1);  // landed: waited below
    cp_async_wait<kRing - 3>();  // stage s + 2 is in (this thread's copies)
    __syncthreads();             // stage s + 1 is transposed
  }
  cp_async_wait<0>();

  if (idle) return;
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int slot = tx * TN + j;
    if (slot >= len) continue;
    float* o = out + static_cast<long long>(s_dst[slot]) * sd + local0;
    *reinterpret_cast<float4*>(o + ty * 4) =
        make_float4(acc[0][j], acc[1][j], acc[2][j], acc[3][j]);
    *reinterpret_cast<float4*>(o + RB / 2 + ty * 4) =
        make_float4(acc[4][j], acc[5][j], acc[6][j], acc[7][j]);
  }
}

// Ids below 0 read chunk 0 throughout and ids of tk or more the last chunk
// throughout, so they group under -1 and tk.
__device__ __forceinline__ int key_of(int id, int tk) {
  return id < 0 ? -1 : (id > tk ? tk : id);
}

// K2's pre-pass: sup [n_pairs] (pair p = b * n_probe + s) -> per sorted
// position the pair's query (qid) and destination (dst), and the group
// table (g_start, g_len, g_key; g_len = 0 past the last group). Pairs of one
// key are cut into groups of `group`.
__global__ void __launch_bounds__(kPrepThreads)
k2_prepass_kernel(const int* __restrict__ sup, int n_pairs, int n_probe, int tk,
                  int group, int* __restrict__ qid, int* __restrict__ dst,
                  int* __restrict__ g_start, int* __restrict__ g_len,
                  int* __restrict__ g_key, int g_max) {
  extern __shared__ int cnt[];  // [n_keys] counts, then [n_keys] cursors
  const int n_keys = tk + 2;
  int* cur = cnt + n_keys;
  __shared__ int n_groups;
  for (int k = threadIdx.x; k < n_keys; k += kPrepThreads) cnt[k] = 0;
  __syncthreads();
  for (int p = threadIdx.x; p < n_pairs; p += kPrepThreads)
    atomicAdd(&cnt[key_of(sup[p], tk) + 1], 1);
  __syncthreads();
  if (threadIdx.x == 0) {
    int off = 0, g = 0;
    for (int k = 0; k < n_keys; ++k) {
      cur[k] = off;
      for (int j = 0; j < cnt[k]; j += group, ++g) {
        g_start[g] = off + j;
        g_len[g] = min(group, cnt[k] - j);
        g_key[g] = k - 1;
      }
      off += cnt[k];
    }
    n_groups = g;
  }
  __syncthreads();
  for (int g = n_groups + threadIdx.x; g < g_max; g += kPrepThreads) g_len[g] = 0;
  for (int p = threadIdx.x; p < n_pairs; p += kPrepThreads) {
    const int at = atomicAdd(&cur[key_of(sup[p], tk) + 1], 1);
    qid[at] = p / n_probe;
    dst[at] = p;
  }
}

// K4's group table from ids sorted ascending: one thread a sorted position.
// A group starts at every `group`-th position of a run of equal keys; the
// group at position i goes to slot i / group + key + 1 (distinct, below
// ceil(n_pairs / group) + tk + 2). The caller zeroes g_len first.
__global__ void group_table_kernel(const int* __restrict__ ids, int n_pairs, int tk,
                                   int group, int* __restrict__ g_start,
                                   int* __restrict__ g_len, int* __restrict__ g_key) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_pairs) return;
  const int key = key_of(ids[i], tk);
  int lo = 0, hi = i;  // the run's first position: the first with key_of >= key
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (key_of(ids[mid], tk) < key) lo = mid + 1; else hi = mid;
  }
  if ((i - lo) % group) return;
  int end_lo = i + 1, end_hi = n_pairs;  // one past the run's last position
  while (end_lo < end_hi) {
    const int mid = (end_lo + end_hi) / 2;
    if (key_of(ids[mid], tk) <= key) end_lo = mid + 1; else end_hi = mid;
  }
  const int slot = i / group + key + 1;
  g_start[slot] = i;
  g_len[slot] = min(group, end_lo - i);
  g_key[slot] = key;
}

template <int RB, int PW, int TN, int kMinB, int kRing, bool kBf16>
int launch(const void* docs, const float* q, const int* qid, const int* dst,
           const int* g_start, const int* g_len, const int* g_key, long long g_max,
           int d, int sd, int ch, long long last_chunk, float* out, cudaStream_t s) {
  using C = Cfg<RB, PW, TN, kMinB, kRing, kBf16>;
  auto kernel = score_kernel<RB, PW, TN, kMinB, kRing, kBf16>;
  if (ch % RB || sd % ch || d % kK || g_max > 0x7fffffffLL || sd / RB > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(g_max), static_cast<unsigned>(sd / RB));
  kernel<<<grid, C::kThreads, C::kSmem, s>>>(docs, q, qid, dst, g_start, g_len, g_key,
                                             d, sd, ch, last_chunk, out);
  return static_cast<int>(cudaGetLastError());
}

// (RB, PW, TN, blocks an SM, ring stages) for pair width pw: the fastest of
// the configurations timed on an H100 (chip_probes.py) on the main path's
// group tables; 256 rows a block at pw = 32 where ch allows
template <bool kBf16>
int launch_pw(int pw, const void* docs, const float* q, const int* qid, const int* dst,
              const int* g_start, const int* g_len, const int* g_key, long long g_max,
              int d, int sd, int ch, long long last_chunk, float* out, cudaStream_t s) {
  switch (pw) {
    case 32:
      if (ch % 256 == 0)
        return launch<256, 32, 8, 2, 3, kBf16>(docs, q, qid, dst, g_start, g_len, g_key,
                                               g_max, d, sd, ch, last_chunk, out, s);
      return launch<128, 32, 8, 3, 3, kBf16>(docs, q, qid, dst, g_start, g_len, g_key,
                                             g_max, d, sd, ch, last_chunk, out, s);
    case 64:
      return launch<128, 64, 8, 3, 3, kBf16>(docs, q, qid, dst, g_start, g_len, g_key,
                                             g_max, d, sd, ch, last_chunk, out, s);
    case 128:
      return launch<128, 128, 8, 2, 4, kBf16>(docs, q, qid, dst, g_start, g_len, g_key,
                                              g_max, d, sd, ch, last_chunk, out, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

int score(int docs_bf16, int pw, const void* docs, const float* q, const int* qid,
          const int* dst, const int* g_start, const int* g_len, const int* g_key,
          long long g_max, int d, int sd, int ch, long long last_chunk, float* out,
          cudaStream_t s) {
  return docs_bf16 ? launch_pw<true>(pw, docs, q, qid, dst, g_start, g_len, g_key, g_max,
                                     d, sd, ch, last_chunk, out, s)
                   : launch_pw<false>(pw, docs, q, qid, dst, g_start, g_len, g_key,
                                      g_max, d, sd, ch, last_chunk, out, s);
}

// units of sd rows in n_rows rows, the last one partial
inline int units(long long n_rows, int sd, int ch) {
  const long long nch = sd / ch, n_chunks = n_rows / ch;
  return static_cast<int>((n_chunks + nch - 1) / nch);
}

}  // namespace ss

// K2. docs [n_rows, d] (float32, or bf16 when docs_bf16), q [b, d] float32,
// sup [b, n_probe] int32; work int32 of 2 * n_pairs + 3 * g_max (n_pairs =
// b * n_probe, g_max = ceil(n_pairs / pw) + tk + 2, tk = ceil(n_rows / sd));
// d % 16 == 0, sd % ch == 0, ch % 128 == 0, n_rows % ch == 0, tk + 2 <= 6144,
// pw in {32, 64, 128}. out [b, n_probe * sd] float32.
extern "C" int hst_super_scores(const void* docs, int docs_bf16, const float* q,
                                const int* sup, long long n_rows, int d, int b,
                                int n_probe, int sd, int ch, int pw, int* work,
                                float* out, void* stream) {
  const int tk = ss::units(n_rows, sd, ch);
  const long long n_pairs = static_cast<long long>(b) * n_probe;
  if (n_pairs == 0) return 0;
  if (pw <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long g_max = (n_pairs + pw - 1) / pw + tk + 2;
  int* qid = work;
  int* dst = qid + n_pairs;
  int* g_start = dst + n_pairs;
  int* g_len = g_start + g_max;
  int* g_key = g_len + g_max;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = static_cast<size_t>(2 * (tk + 2)) * sizeof(int);
  ss::k2_prepass_kernel<<<1, ss::kPrepThreads, smem, s>>>(
      sup, static_cast<int>(n_pairs), n_probe, tk, pw, qid, dst, g_start, g_len, g_key,
      static_cast<int>(g_max));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return ss::score(docs_bf16, pw, docs, q, qid, dst, g_start, g_len, g_key, g_max, d, sd,
                   ch, n_rows / ch - 1, out, s);
}

// K4's group table: tid [n_pairs] int32 ids sorted ascending, units = tk;
// work int32 of 3 * g_max (g_max = ceil(n_pairs / group) + tk + 2) receives
// g_start, g_len and g_key, g_len 0 at unused slots.
extern "C" int hst_group_table(const int* tid, int n_pairs, int tk, int group, int* work,
                               void* stream) {
  if (group <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long g_max = (static_cast<long long>(n_pairs) + group - 1) / group + tk + 2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = cudaMemsetAsync(work + g_max, 0, g_max * sizeof(int), s);
  if (err != cudaSuccess || n_pairs == 0) return static_cast<int>(err);
  constexpr int kT = 256;
  ss::group_table_kernel<<<(n_pairs + kT - 1) / kT, kT, 0, s>>>(
      tid, n_pairs, tk, group, work, work + g_max, work + 2 * g_max);
  return static_cast<int>(cudaGetLastError());
}

// K4. docs as for hst_super_scores, q [b, d] float32; tid [n_pairs] int32
// unit ids sorted ascending, qid [n_pairs] each pair's query row, dst
// [n_pairs] each pair's output row (a permutation of 0 .. n_pairs-1);
// work int32 of 3 * g_max (g_max = ceil(n_pairs / pw) + tk + 2). out
// [n_pairs, sd] float32: row dst[p] holds pair p's scores.
extern "C" int hst_super_scores_dedup(const void* docs, int docs_bf16, const float* q,
                                      const int* tid, const int* qid, const int* dst,
                                      int n_pairs, long long n_rows, int d, int sd,
                                      int ch, int pw, int* work, float* out,
                                      void* stream) {
  if (n_pairs == 0) return 0;
  if (pw <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int tk = ss::units(n_rows, sd, ch);
  const long long g_max = (static_cast<long long>(n_pairs) + pw - 1) / pw + tk + 2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int err = hst_group_table(tid, n_pairs, tk, pw, work, s);
  if (err != 0) return err;
  return ss::score(docs_bf16, pw, docs, q, qid, dst, work, work + g_max, work + 2 * g_max,
                   g_max, d, sd, ch, n_rows / ch - 1, out, s);
}
