// Two-tier (hot ring + paged cold buffer) single-query decode attention
// for Hopper (sm_90a), split across the SMs.
//
// Replaces: src/repro/kernels/tiered_decode.py::tiered_decode_attention_fwd
// (Pallas body _tiered_kernel), the TPU kernel every decode step of every
// full-attention layer runs through TieredKVCache.attend.
//
// What it computes, per batch row b and query head h (kv head h / G):
//   out = softmax(q . k / sqrt(D)) v over the valid keys of both tiers,
//   merged in one fp32 online softmax.  Hot ring slot j is valid iff
//   (newest - j) mod W < hot_len; cold position t is valid iff t < cold_len.
//   A row with no valid key gives 0.
//
// What bounds it on the H100: bytes.  Each K/V row is used by G query heads
// for 2*G*D flops while it moves 2*D*sizeof(T) bytes, i.e. about 4 flops a
// byte at G = 4 in bf16, far below the ~295 the card needs to be compute
// bound.  The least time is (K/V bytes of the valid keys + q + out) over
// 3.35 TB/s.
//
// What the design does about it:
//   * the valid keys are numbered 0 .. n_keys - 1: cold positions
//     [0, cold_len), then the hot_len valid ring slots oldest first (they are
//     one contiguous arc of the ring).  Invalid slots have no number, so
//     nothing ever loads them, and the C - cold_len unused cold rows are a
//     stride, not a loop bound;
//   * pass 1 runs a grid of (B * KV, n_split, tiles) blocks; block (bk, i, t)
//     folds the contiguous key range [i * n / n_split, (i + 1) * n / n_split)
//     for the query heads of head tile t of kv head bk, and the n_split
//     blocks of a row fill the SMs that one block per row left idle.  n_split
//     is chosen by the wrapper (kernels/tiered_decode.py) so that all blocks
//     fit one wave (two blocks an SM up to GT = 4 heads a tile);
//   * any group G = H / KV: the G query heads of a kv head are cut into
//     tiles = ceil(G / GT) tiles of GT heads, GT from a few instantiations
//     (1, 2, 4, 6, 8), so that a lane's q and accumulator slices, GT x 16
//     bytes each, stay in registers.  The heads of the last tile past G are
//     padding (at most one up to G = 8): they repeat the tile's last head,
//     with no branch in the key loop, and nothing is stored for them.  A kv
//     row is read once per tile; all blocks
//     of a launch are resident in one wave, so the tiles of one (row, split)
//     stream the same rows at the same time and all but the first find them
//     in L2;
//   * loads are 16 bytes a lane: a bf16 row of D = 128 is half a warp, so
//     one load instruction covers two keys.  A row wider than a warp's 32
//     loads (fp32 at D = 256) gives each lane NV = 2 slices of it, 512 bytes
//     apart, so neighbouring lanes still read neighbouring bytes.  Each lane
//     issues the K and V rows of U keys before it uses any of them (U NV = 4
//     up to GT = 4, 2 above): 128 bytes a lane, 32 KB a block in flight;
//   * each block writes its partial softmax (m, l, acc[GT][D]) to fp32
//     scratch, and pass 2 (one block per (b, kv head)) merges the n_split
//     partials of each of its G query heads; a partial with m = -inf (a split
//     with no key) adds nothing.  With one split pass 1 writes the output
//     itself and pass 2 is not launched;
//   * hot_len, cold_len and newest are plain arguments (the host knows them
//     each step), so nothing is read before the first K/V load.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <atomic>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // warps per pass-1 block
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// The EPL = 16 / sizeof(T) elements of one 16-byte load, as floats, to x[0, EPL).
template <typename T, int EPL>
__device__ __forceinline__ void unpack(const uint4& raw, float* x) {
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < EPL; ++i) x[i] = to_f(e[i]);
}

// Sum over the LPK lanes of one key's lane group (aligned, LPK a power of 2).
template <int LPK>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = LPK / 2; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Key number k of the valid-key order -> its K or V row: cold position k, or
// the (k - cold_len)-th oldest valid ring slot.
__device__ __forceinline__ const char* key_row(int k, int cold_len, int hot_len, int newest, int W,
                                               const char* cold, const char* hot, size_t row_bytes) {
  if (k < cold_len) return cold + (size_t)k * row_bytes;
  int slot = (newest - hot_len + 1 + (k - cold_len)) % W;
  if (slot < 0) slot += W;
  return hot + (size_t)slot * row_bytes;
}

// How a row of D elements of T lies on a warp: EPL elements a 16-byte load,
// LPK lanes a key, NV loads a lane, EL = NV * EPL elements a lane.
template <typename T, int D>
struct RowLayout {
  static constexpr int EPL = 16 / sizeof(T);
  static constexpr int LPK = D / EPL < 32 ? D / EPL : 32;
  static constexpr int NV = D / (EPL * LPK);
  static constexpr int EL = NV * EPL;
  static_assert(LPK >= 1 && 32 % LPK == 0 && NV * EPL * LPK == D, "row must tile a warp");
};

// Pass-1 shared memory: per warp, m and l of each head, then acc[GT][D].
template <int D, int GT>
constexpr size_t partial_smem_bytes() {
  return (size_t)kWarps * GT * (D + 2) * sizeof(float);
}

// Pass 1: block (bk, split, t) folds its key range for the heads of tile t of
// kv head bk.  Two blocks an SM up to GT = 4 (at most 128 registers
// a thread), one above (its GT x 16-byte q and accumulator slices take ~216);
// the wrapper's split planner counts the same (kernels/tiered_decode.py::
// blocks_per_sm).
template <typename T, int D, int GT>
__global__ void __launch_bounds__(kWarps * 32, GT <= 4 ? 2 : 1)
tiered_partial_kernel(const T* __restrict__ q, const T* __restrict__ hot_k,
                      const T* __restrict__ hot_v, const T* __restrict__ cold_k,
                      const T* __restrict__ cold_v, T* __restrict__ out,
                      float* __restrict__ part_ml, float* __restrict__ part_acc, int G, int W,
                      int C, int hot_len, int cold_len, int newest, float scale_log2) {
  using L = RowLayout<T, D>;
  constexpr int EPL = L::EPL, LPK = L::LPK, NV = L::NV, EL = L::EL;
  constexpr int KPW = 32 / LPK;              // keys per warp load
  constexpr int NS = kWarps * KPW;           // key streams per block
  constexpr int U = (GT <= 4 ? 4 : 2) / NV > 0 ? (GT <= 4 ? 4 : 2) / NV : 1;  // keys a stream issues ahead
  constexpr int SLICE = LPK * EPL;           // elements between a lane's slices
  const int bk = blockIdx.x, h0 = blockIdx.z * GT;
  const int nh = min(GT, G - h0);            // heads of this tile; the rest are padding
  const int split = blockIdx.y, n_split = gridDim.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int stream = warp * KPW + lane / LPK;  // this lane's key stream
  const int col = (lane % LPK) * EPL;          // first element of this lane's first slice

  const int n_keys = hot_len + cold_len;
  const int k0 = (int)((long long)split * n_keys / n_split);
  const int k1 = (int)((long long)(split + 1) * n_keys / n_split);

  float qr[GT][EL];
#pragma unroll
  for (int h = 0; h < GT; ++h) {
    const T* qh = q + ((size_t)bk * G + h0 + min(h, nh - 1)) * D + col;  // a padded head repeats the last
#pragma unroll
    for (int j = 0; j < NV; ++j) unpack<T, EPL>(*reinterpret_cast<const uint4*>(qh + j * SLICE), &qr[h][j * EPL]);
#pragma unroll
    for (int e = 0; e < EL; ++e) qr[h][e] *= scale_log2;  // scores in the log2 domain
  }
  float m[GT], l[GT], acc[GT][EL];
#pragma unroll
  for (int h = 0; h < GT; ++h) {
    m[h] = -INFINITY;
    l[h] = 0.f;
#pragma unroll
    for (int e = 0; e < EL; ++e) acc[h][e] = 0.f;
  }

  const size_t row_bytes = (size_t)D * sizeof(T);
  const char* ck = reinterpret_cast<const char*>(cold_k + (size_t)bk * C * D) + col * sizeof(T);
  const char* cv = reinterpret_cast<const char*>(cold_v + (size_t)bk * C * D) + col * sizeof(T);
  const char* hk = reinterpret_cast<const char*>(hot_k + (size_t)bk * W * D) + col * sizeof(T);
  const char* hv = reinterpret_cast<const char*>(hot_v + (size_t)bk * W * D) + col * sizeof(T);

  // The loop runs per warp (its streams shuffle together); a stream's keys
  // past k1 are missing: a valid row stands in for their loads, and their
  // scores are -inf.
  for (int wbase = k0 + warp * KPW; wbase < k1; wbase += NS * U) {
    const int base = wbase + stream % KPW;
    uint4 kraw[U][NV], vraw[U][NV];
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {  // all 2 U NV loads issued before any is used
      const int k = base + u * NS;
      ok[u] = k < k1;
      const int kk = ok[u] ? k : wbase;
      const char* kp = key_row(kk, cold_len, hot_len, newest, W, ck, hk, row_bytes);
      const char* vp = key_row(kk, cold_len, hot_len, newest, W, cv, hv, row_bytes);
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        kraw[u][j] = *reinterpret_cast<const uint4*>(kp + j * SLICE * sizeof(T));
        vraw[u][j] = *reinterpret_cast<const uint4*>(vp + j * SLICE * sizeof(T));
      }
    }
    float s[U][GT];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kx[EL];
#pragma unroll
      for (int j = 0; j < NV; ++j) unpack<T, EPL>(kraw[u][j], &kx[j * EPL]);
#pragma unroll
      for (int h = 0; h < GT; ++h) {
        float p = 0.f;
#pragma unroll
        for (int e = 0; e < EL; ++e) p += qr[h][e] * kx[e];
        p = group_sum<LPK>(p);  // every lane of the warp shuffles
        s[u][h] = ok[u] ? p : -INFINITY;
      }
    }
    float vx[U][EL];
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int j = 0; j < NV; ++j) unpack<T, EPL>(vraw[u][j], &vx[u][j * EPL]);
#pragma unroll
    for (int h = 0; h < GT; ++h) {
      float mt = s[0][h];
#pragma unroll
      for (int u = 1; u < U; ++u) mt = fmaxf(mt, s[u][h]);
      const float m_new = fmaxf(m[h], mt);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;  // no key yet: no NaN
      const float alpha = exp2f(m[h] - m_use);  // 0 while m[h] is -inf
      float lsum = 0.f;
#pragma unroll
      for (int e = 0; e < EL; ++e) acc[h][e] *= alpha;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float p = exp2f(s[u][h] - m_use);  // 0 for a missing key
        lsum += p;
#pragma unroll
        for (int e = 0; e < EL; ++e) acc[h][e] += p * vx[u][e];
      }
      l[h] = alpha * l[h] + lsum;
      m[h] = m_new;
    }
  }

  // Merge the KPW streams of this warp (lanes LPK apart hold the same columns).
#pragma unroll
  for (int o = LPK; o < 32; o <<= 1) {
#pragma unroll
    for (int h = 0; h < GT; ++h) {
      const float m_o = __shfl_xor_sync(0xffffffffu, m[h], o);
      const float l_o = __shfl_xor_sync(0xffffffffu, l[h], o);
      const float M = fmaxf(m[h], m_o);
      const float c = M == -INFINITY ? 0.f : exp2f(m[h] - M);
      const float c_o = M == -INFINITY ? 0.f : exp2f(m_o - M);
#pragma unroll
      for (int e = 0; e < EL; ++e)
        acc[h][e] = c * acc[h][e] + c_o * __shfl_xor_sync(0xffffffffu, acc[h][e], o);
      l[h] = c * l[h] + c_o * l_o;
      m[h] = M;
    }
  }

  // Then the warps, through shared memory.
  extern __shared__ float smem[];
  float* s_m = smem;                      // [kWarps][GT]
  float* s_l = smem + kWarps * GT;        // [kWarps][GT]
  float* s_acc = smem + 2 * kWarps * GT;  // [kWarps][GT][D]
  if (lane < LPK) {
#pragma unroll
    for (int h = 0; h < GT; ++h) {
      if (h >= nh) continue;
      if (lane == 0) {
        s_m[warp * GT + h] = m[h];
        s_l[warp * GT + h] = l[h];
      }
#pragma unroll
      for (int j = 0; j < NV; ++j)
#pragma unroll
        for (int e = 0; e < EPL; ++e) s_acc[(warp * GT + h) * D + col + j * SLICE + e] = acc[h][j * EPL + e];
    }
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < nh * D; idx += blockDim.x) {
    const int h = idx / D, d = idx % D;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, s_m[w * GT + h]);
    float Lsum = 0.f, O = 0.f;
    if (M != -INFINITY) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float c = exp2f(s_m[w * GT + h] - M);  // 0 for a warp that saw no key
        Lsum += c * s_l[w * GT + h];
        O += c * s_acc[(w * GT + h) * D + d];
      }
    }
    const size_t row = (size_t)bk * G + h0 + h;
    if (n_split == 1) {
      out[row * D + d] = from_f<T>(Lsum == 0.f ? 0.f : O / Lsum);
    } else {
      const size_t p = row * n_split + split;
      part_acc[p * D + d] = O;
      if (d == 0) {
        part_ml[2 * p] = M;
        part_ml[2 * p + 1] = Lsum;
      }
    }
  }
}

// Pass 2: merge the n_split partials of each (b, query head) row.
template <typename T, int D>
__global__ void __launch_bounds__(256)
tiered_merge_kernel(const float* __restrict__ part_ml, const float* __restrict__ part_acc,
                    T* __restrict__ out, int rows_per_block, int n_split) {
  for (int idx = threadIdx.x; idx < rows_per_block * D; idx += blockDim.x) {
    const size_t row = (size_t)blockIdx.x * rows_per_block + idx / D;
    const int d = idx % D;
    const float* ml = part_ml + row * n_split * 2;
    float M = -INFINITY;
    for (int i = 0; i < n_split; ++i) M = fmaxf(M, ml[2 * i]);
    float L = 0.f, O = 0.f;
    if (M != -INFINITY) {
      for (int i = 0; i < n_split; ++i) {
        const float c = exp2f(ml[2 * i] - M);  // 0 for a split with no key
        L += c * ml[2 * i + 1];
        O += c * part_acc[(row * n_split + i) * D + d];
      }
    }
    out[row * D + d] = from_f<T>(L == 0.f ? 0.f : O / L);
  }
}

template <typename T, int D, int GT>
cudaError_t launch_tile(const void* q, const void* hk, const void* hv, const void* ck,
                        const void* cv, void* out, float* part_ml, float* part_acc, int B, int KV,
                        int G, int W, int C, int hot_len, int cold_len, int newest, int n_split,
                        cudaStream_t stream) {
  const float scale_log2 = (float)(1.0 / sqrt((double)D)) * kLog2e;
  constexpr size_t smem = partial_smem_bytes<D, GT>();
  auto kernel = tiered_partial_kernel<T, D, GT>;
  if (smem > 48 * 1024) {  // above 48 KB only as opted-in dynamic shared memory, once a device
    static std::atomic<unsigned long long> opted_in{0};  // bit i: device i
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    const unsigned long long bit = 1ull << (dev & 63);
    if (!(opted_in.load(std::memory_order_relaxed) & bit)) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return err;
      opted_in.fetch_or(bit, std::memory_order_relaxed);
    }
  }
  const int tiles = (G + GT - 1) / GT;
  kernel<<<dim3(B * KV, n_split, tiles), kWarps * 32, smem, stream>>>(
      (const T*)q, (const T*)hk, (const T*)hv, (const T*)ck, (const T*)cv, (T*)out, part_ml, part_acc, G, W,
      C, hot_len, cold_len, newest, scale_log2);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_g(int G, int GT, const void* q, const void* hk, const void* hv, const void* ck,
                     const void* cv, void* out, float* part_ml, float* part_acc, int B, int KV,
                     int W, int C, int hot_len, int cold_len, int newest, int n_split,
                     cudaStream_t stream) {
  cudaError_t err;
  switch (GT) {
#define TD_TILE(GG)                                                                                \
  case GG:                                                                                         \
    err = launch_tile<T, D, GG>(q, hk, hv, ck, cv, out, part_ml, part_acc, B, KV, G, W, C, hot_len, \
                                cold_len, newest, n_split, stream);                                \
    break;
    TD_TILE(1)
    TD_TILE(2)
    TD_TILE(4)
    TD_TILE(6)
    TD_TILE(8)
#undef TD_TILE
    default:
      return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess || n_split == 1) return err;
  tiered_merge_kernel<T, D><<<B * KV, 256, 0, stream>>>(part_ml, part_acc, (T*)out, G, n_split);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int D, int G, int GT, const void* q, const void* hk, const void* hv,
                     const void* ck, const void* cv, void* out, float* ml, float* acc, int B,
                     int KV, int W, int C, int hot_len, int cold_len, int newest, int n_split,
                     cudaStream_t stream) {
  switch (D) {
#define TD_D(DD)                                                                                 \
  case DD:                                                                                       \
    return launch_g<T, DD>(G, GT, q, hk, hv, ck, cv, out, ml, acc, B, KV, W, C, hot_len, cold_len, \
                           newest, n_split, stream);
    TD_D(16)
    TD_D(32)
    TD_D(64)
    TD_D(128)
    TD_D(256)
#undef TD_D
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  head_tile: GT, the query heads a
// pass-1 block takes (1, 2, 4, 6 or 8; the wrapper's head_tile).  scratch:
// n_split > 1 needs B * H * n_split * (D + 2) floats (the partials); unused
// at n_split = 1.  Launches pass 1 and, when n_split > 1, pass 2 on one
// stream; returns cudaGetLastError() after them (cudaErrorInvalidValue for a
// D, head tile, dtype or split count it was not built for).
extern "C" int tiered_decode_launch(const void* q, const void* hot_k, const void* hot_v,
                                    const void* cold_k, const void* cold_v, void* out,
                                    void* scratch, int B, int H, int KV, int W, int C, int D,
                                    int hot_len, int cold_len, int newest, int n_split, int head_tile,
                                    int dtype, void* stream) {
  if (KV <= 0 || H % KV || n_split < 1 || n_split > 65535 || (n_split > 1 && !scratch))
    return (int)cudaErrorInvalidValue;
  const int G = H / KV;
  float* ml = (float*)scratch;
  float* acc = ml ? ml + (size_t)B * H * n_split * 2 : nullptr;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)launch_d<float>(D, G, head_tile, q, hot_k, hot_v, cold_k, cold_v, out, ml, acc, B, KV, W, C,
                                hot_len, cold_len, newest, n_split, s);
  if (dtype == 1)
    return (int)launch_d<__nv_bfloat16>(D, G, head_tile, q, hot_k, hot_v, cold_k, cold_v, out, ml, acc, B,
                                        KV, W, C, hot_len, cold_len, newest, n_split, s);
  return (int)cudaErrorInvalidValue;
}
