// K6 design variants that the shipped launcher does not take, timed by
// chip_probes.py --only k6 beside the copies of slice_runs.cu (which the
// probe's source includes first); no library build includes this file.
//
//   Ld4<RT, U>:  lane t owns chunks of 4 positions, 4 (t + RT u'), U of
//                them an array at once, read with 4-byte loads and stored
//                with 16-byte stores (p % 4 == 0, outputs 16-byte aligned).
//   Shfl<RT, U>: a warp takes a segment of 128 positions at once: each lane
//                loads the aligned 16-byte word of its chunk (where one of
//                its positions lies below the row's length), takes the next
//                lane's by __shfl_sync (lane 31 the word lane 0 loads past
//                the segment), re-aligns by the start's residue mod 4 and
//                stores 16 bytes. RT is a multiple of 32; the postings,
//                like the outputs, must be 16-byte aligned. A word's first
//                entry lies in bounds; its last may lie past the tensor's
//                end when the postings' size is not a multiple of 4, inside
//                the same 16-byte block of the allocation.
//   launch_wave<Row>: at most one wave of blocks (what the card holds at
//                once, or fewer blocks an SM); a group serves rows g, g + G,
//                ..., loading the next row's start and length while it
//                copies this one.

#include <atomic>

namespace {
namespace k6 {

constexpr unsigned kFull = 0xffffffffu;

template <int kRT, int U>
struct Ld4 {
  static constexpr int RT = kRT;

  __device__ __forceinline__ static void row(const Args& a, long long s0, int len, int* io, float* wo,
                             int t) {
    const int* src_i = a.ids + s0;
    const float* src_w = a.ws + s0;
#pragma unroll 1  // a pass's loads in flight, not the next pass's: registers
    for (int base = 0; base < a.p; base += RT * U * 4) {
      int4 vi[U];
      float4 vw[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = base + (u * RT + t) * 4;
        int e[4];
        float w[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          e[k] = a.n_docs;
          w[k] = 0.f;
          if (j + k < len) {
            e[k] = src_i[j + k];
            w[k] = src_w[j + k];
          }
        }
        vi[u] = make_int4(e[0], e[1], e[2], e[3]);
        vw[u] = make_float4(w[0], w[1], w[2], w[3]);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = base + (u * RT + t) * 4;
        if (j < a.p) {
          *reinterpret_cast<int4*>(io + j) = vi[u];
          *reinterpret_cast<float4*>(wo + j) = vw[u];
        }
      }
    }
  }
};

// The four entries from position r of the 8 in (lo, hi): r is the start's
// residue mod 4, the same for every lane of the warp.
template <typename V>
__device__ __forceinline__ V realign(const V& lo, const V& hi, int r) {
  switch (r) {
    case 0: return lo;
    case 1: return V{lo.y, lo.z, lo.w, hi.x};
    case 2: return V{lo.z, lo.w, hi.x, hi.y};
    default: return V{lo.w, hi.x, hi.y, hi.z};
  }
}

template <typename V>
__device__ __forceinline__ V shfl_next(const V& mine, const V& extra, int lane) {
  // lane l receives lane l + 1's word; lane 31 receives lane 0's extra
  // word (the one past the warp's 128 positions)
  const V give = lane == 0 ? extra : mine;
  const int src = (lane + 1) & 31;
  V out;
  out.x = __shfl_sync(kFull, give.x, src);
  out.y = __shfl_sync(kFull, give.y, src);
  out.z = __shfl_sync(kFull, give.z, src);
  out.w = __shfl_sync(kFull, give.w, src);
  return out;
}

// Lane l of a warp owns the chunk of positions 4l .. 4l+3 of segment seg;
// its source starts at aligned word c = (s0 - r) / 4 + 32 seg + l (the
// word of position 4l, less r) and runs r entries into word c + 1.
template <int kRT, int U>
struct Shfl {
  static constexpr int RT = kRT;
  static_assert(kRT % 32 == 0, "whole warps a row");

  __device__ __forceinline__ static void row(const Args& a, long long s0, int len, int* io, float* wo,
                             int t) {
    constexpr int kWarps = RT / 32;
    const int lane = t & 31, warp = t >> 5;
    const int r = static_cast<int>(s0 & 3);
    const int4* src_i = reinterpret_cast<const int4*>(a.ids + (s0 - r));
    const float4* src_w = reinterpret_cast<const float4*>(a.ws + (s0 - r));
    const int4 fill_i = make_int4(a.n_docs, a.n_docs, a.n_docs, a.n_docs);
    const float4 fill_w = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 1  // a pass's loads in flight, not the next pass's: registers
    for (int base = 0; base < a.p; base += RT * U * 4) {
      int4 wi[U], xi[U];
      float4 ww[U], xw[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int seg = base / 128 + u * kWarps + warp;
        const int c = seg * 32 + lane;
        wi[u] = fill_i;
        ww[u] = fill_w;
        xi[u] = fill_i;
        xw[u] = fill_w;
        // word c holds positions 4c - r .. 4c - r + 3 of the row
        if (len > 0 && 4 * c - r < len) {
          wi[u] = src_i[c];
          ww[u] = src_w[c];
        }
        // lane 0 also reads the word past the segment, for lane 31
        if (lane == 0 && r != 0 && 4 * (c + 32) - r < len) {
          xi[u] = src_i[c + 32];
          xw[u] = src_w[c + 32];
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int j = (base / 128 + u * kWarps + warp) * 128 + 4 * lane;
        int4 oi = wi[u];
        float4 ow = ww[u];
        if (r != 0) {
          oi = realign(wi[u], shfl_next(wi[u], xi[u], lane), r);
          ow = realign(ww[u], shfl_next(ww[u], xw[u], lane), r);
        }
        if (j + 4 > len) {
          oi = int4{j < len ? oi.x : a.n_docs, j + 1 < len ? oi.y : a.n_docs,
                    j + 2 < len ? oi.z : a.n_docs, j + 3 < len ? oi.w : a.n_docs};
          ow = float4{j < len ? ow.x : 0.f, j + 1 < len ? ow.y : 0.f,
                      j + 2 < len ? ow.z : 0.f, j + 3 < len ? ow.w : 0.f};
        }
        if (j < a.p) {
          *reinterpret_cast<int4*>(io + j) = oi;
          *reinterpret_cast<float4*>(wo + j) = ow;
        }
      }
    }
  }
};

// One wave: group g of G serves rows g, g + G, ... (whole groups return
// together, so whole warps when RT >= 32).
template <class Row>
__global__ void __launch_bounds__(kThreads) wave_kernel(const Args a) {
  constexpr int kGroups = kThreads / Row::RT;
  const int t = static_cast<int>(threadIdx.x) % Row::RT;
  const long long stride = static_cast<long long>(gridDim.x) * kGroups;
  long long row = static_cast<long long>(blockIdx.x) * kGroups + threadIdx.x / Row::RT;
  if (row >= a.rows) return;
  long long s0 = a.starts[row];
  int len = a.lengths[row];
  while (true) {
    const long long next = row + stride;
    long long s_next = 0;
    int len_next = 0;
    if (next < a.rows) {
      s_next = a.starts[next];
      len_next = a.lengths[next];
    }
    Row::row(a, s0, min(max(len, 0), a.p), a.ids_out + row * a.p, a.ws_out + row * a.p,
             t);
    if (next >= a.rows) break;
    row = next;
    s0 = s_next;
    len = len_next;
  }
}

// Blocks of wave_kernel<Row> the card holds at once an SM and SMs, found
// once; 0 and the error in *err when the card cannot be asked.
template <class Row>
int wave_blocks(int* sms_out, cudaError_t* err) {
  static std::atomic<int> cached_per_sm{0}, cached_sms{0};
  int per_sm = cached_per_sm.load(std::memory_order_relaxed);
  int sms = cached_sms.load(std::memory_order_relaxed);
  if (per_sm > 0 && sms > 0) {
    *sms_out = sms;
    return per_sm;
  }
  int dev = 0;
  *err = cudaGetDevice(&dev);
  if (*err == cudaSuccess)
    *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (*err == cudaSuccess)
    *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, wave_kernel<Row>,
                                                         kThreads, 0);
  if (*err != cudaSuccess) return 0;
  if (per_sm <= 0 || sms <= 0) {
    *err = cudaErrorInvalidConfiguration;
    return 0;
  }
  cached_per_sm.store(per_sm, std::memory_order_relaxed);
  cached_sms.store(sms, std::memory_order_relaxed);
  *sms_out = sms;
  return per_sm;
}

// One wave of wave_kernel<Row>, at most ``per_sm_cap`` blocks an SM when
// it is positive (fewer rows written at once).
template <class Row>
int launch_wave(const Args& a, int per_sm_cap, cudaStream_t s) {
  if (a.rows <= 0) return 0;
  cudaError_t err = cudaSuccess;
  int sms = 0;
  int per_sm = wave_blocks<Row>(&sms, &err);
  if (per_sm <= 0) return static_cast<int>(err);
  if (per_sm_cap > 0 && per_sm_cap < per_sm) per_sm = per_sm_cap;
  constexpr int kGroups = kThreads / Row::RT;
  const long long need = (a.rows + kGroups - 1) / kGroups;
  const long long wave = static_cast<long long>(sms) * per_sm;
  wave_kernel<Row><<<static_cast<unsigned>(need < wave ? need : wave), kThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace k6
}  // namespace
