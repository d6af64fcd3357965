// Two-tier (hot ring + paged cold buffer) single-query decode attention
// for Hopper (sm_90a).
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
//   * one block per (b, kv head) serves all G query heads of that kv head,
//     so every K/V row is read from device memory once (the TPU kernel ran
//     one program per query head and broadcast q over 8 sublanes; neither
//     carries over);
//   * each warp takes kKT keys at a time and issues their loads together,
//     lane l holding elements [l*EPL, (l+1)*EPL) of a row, so a warp reads
//     whole rows contiguously;
//   * invalid hot slots are never loaded, and the cold loop stops at
//     cold_len: the buffer's capacity C is a stride, not a loop bound;
//   * hot_len, cold_len and newest are plain arguments (the host knows them
//     each step), so nothing is read before the first K/V load.
// Known limit, left to a later change: with B * KV blocks (32 for qwen3-8b
// at batch 4) most of the 132 SMs idle; splitting the cold range across
// blocks (split-K) with a second merge pass is the fix.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int kWarps = 8;  // warps per block
constexpr int kKT = 4;     // keys per warp iteration

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Running state of one warp for G query heads: max m, sum l, and this
// lane's EPL elements of the G accumulators.
template <int G, int EPL>
struct State {
  float m[G], l[G], acc[G][EPL];
};

// Fold up to kKT keys (rows row[0..n) of K and V, all valid) into st.
template <typename T, int D, int G, int EPL>
__device__ __forceinline__ void fold_keys(State<G, EPL>& st, const float (&q)[G][EPL],
                                          const T* const* krow, const T* const* vrow,
                                          int n, int lane, float scale) {
  const bool active = lane * EPL < D;
  float kv[kKT][EPL];
#pragma unroll
  for (int t = 0; t < kKT; ++t)
#pragma unroll
    for (int e = 0; e < EPL; ++e)
      kv[t][e] = (t < n && active) ? to_f(krow[t][lane * EPL + e]) : 0.f;
  float s[kKT][G];
#pragma unroll
  for (int t = 0; t < kKT; ++t)
#pragma unroll
    for (int h = 0; h < G; ++h) {
      float p = 0.f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) p += q[h][e] * kv[t][e];
      s[t][h] = warp_sum(p) * scale;
    }
  // V rows: loaded after the scores so the K loads above are not delayed.
#pragma unroll
  for (int t = 0; t < kKT; ++t)
#pragma unroll
    for (int e = 0; e < EPL; ++e)
      kv[t][e] = (t < n && active) ? to_f(vrow[t][lane * EPL + e]) : 0.f;
#pragma unroll
  for (int h = 0; h < G; ++h) {
    float mt = -INFINITY;
#pragma unroll
    for (int t = 0; t < kKT; ++t)
      if (t < n) mt = fmaxf(mt, s[t][h]);
    const float m_new = fmaxf(st.m[h], mt);
    const float alpha = (st.m[h] == -INFINITY) ? 0.f : expf(st.m[h] - m_new);
    float lsum = 0.f;
    float pv[EPL];
#pragma unroll
    for (int e = 0; e < EPL; ++e) pv[e] = 0.f;
#pragma unroll
    for (int t = 0; t < kKT; ++t) {
      const float p = (t < n) ? expf(s[t][h] - m_new) : 0.f;  // explicit zero
      lsum += p;
#pragma unroll
      for (int e = 0; e < EPL; ++e) pv[e] += p * kv[t][e];
    }
    st.l[h] = alpha * st.l[h] + lsum;
#pragma unroll
    for (int e = 0; e < EPL; ++e) st.acc[h][e] = alpha * st.acc[h][e] + pv[e];
    st.m[h] = m_new;
  }
}

template <typename T, int D, int G>
__global__ void __launch_bounds__(kWarps * 32)
tiered_decode_kernel(const T* __restrict__ q, const T* __restrict__ hot_k,
                     const T* __restrict__ hot_v, const T* __restrict__ cold_k,
                     const T* __restrict__ cold_v, T* __restrict__ out, int KV, int W, int C,
                     int hot_len, int cold_len, int newest, float scale) {
  constexpr int EPL = (D + 31) / 32;
  const int bk = blockIdx.x;  // b * KV + kv head
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool active = lane * EPL < D;

  // q rows of the G heads sharing this kv head: (B, H, 1, D) with H = KV * G.
  float qr[G][EPL];
#pragma unroll
  for (int h = 0; h < G; ++h)
#pragma unroll
    for (int e = 0; e < EPL; ++e)
      qr[h][e] = active ? to_f(q[((size_t)bk * G + h) * D + lane * EPL + e]) : 0.f;

  State<G, EPL> st;
#pragma unroll
  for (int h = 0; h < G; ++h) {
    st.m[h] = -INFINITY;
    st.l[h] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) st.acc[h][e] = 0.f;
  }

  // Hot ring: warp w takes slots [i, i + kKT) for i = w*kKT, w*kKT + kWarps*kKT, ...
  const T* hk = hot_k + (size_t)bk * W * D;
  const T* hv = hot_v + (size_t)bk * W * D;
  for (int i = warp * kKT; i < W; i += kWarps * kKT) {
    const T* kr[kKT] = {hk, hk, hk, hk};
    const T* vr[kKT] = {hv, hv, hv, hv};
    int n = 0;
#pragma unroll
    for (int t = 0; t < kKT; ++t) {
      const int j = i + t;
      if (j < W) {
        const int age = ((newest - j) % W + W) % W;
        if (age < hot_len) {  // invalid slots are never loaded
          kr[n] = hk + (size_t)j * D;
          vr[n] = hv + (size_t)j * D;
          ++n;
        }
      }
    }
    if (n) fold_keys<T, D, G, EPL>(st, qr, kr, vr, n, lane, scale);
  }

  // Cold pages: positions [0, cold_len) of a (C, D) buffer per (b, kv head).
  const T* ck = cold_k + (size_t)bk * C * D;
  const T* cv = cold_v + (size_t)bk * C * D;
  for (int i = warp * kKT; i < cold_len; i += kWarps * kKT) {
    const T* kr[kKT];
    const T* vr[kKT];
    const int n = min(kKT, cold_len - i);
#pragma unroll
    for (int t = 0; t < kKT; ++t) {
      const int j = i + min(t, n - 1);
      kr[t] = ck + (size_t)j * D;
      vr[t] = cv + (size_t)j * D;
    }
    fold_keys<T, D, G, EPL>(st, qr, kr, vr, n, lane, scale);
  }

  // Merge the warps' partial softmaxes through shared memory.
  __shared__ float s_m[kWarps][G], s_l[kWarps][G];
  __shared__ float s_acc[kWarps][G][EPL * 32];
  if (lane == 0) {
#pragma unroll
    for (int h = 0; h < G; ++h) {
      s_m[warp][h] = st.m[h];
      s_l[warp][h] = st.l[h];
    }
  }
#pragma unroll
  for (int h = 0; h < G; ++h)
#pragma unroll
    for (int e = 0; e < EPL; ++e) s_acc[warp][h][lane * EPL + e] = st.acc[h][e];
  __syncthreads();

  for (int idx = threadIdx.x; idx < G * D; idx += blockDim.x) {
    const int h = idx / D, d = idx % D;
    float M = -INFINITY;
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, s_m[w][h]);
    float L = 0.f, O = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      if (s_m[w][h] == -INFINITY) continue;  // this warp saw no valid key
      const float c = expf(s_m[w][h] - M);
      L += c * s_l[w][h];
      O += c * s_acc[w][h][d];
    }
    out[((size_t)bk * G + h) * D + d] = from_f<T>(L == 0.f ? 0.f : O / L);
  }
}

template <typename T, int D>
cudaError_t launch_g(int G, const void* q, const void* hk, const void* hv, const void* ck,
                     const void* cv, void* out, int B, int KV, int W, int C, int hot_len,
                     int cold_len, int newest, cudaStream_t stream) {
  const float scale = (float)(1.0 / sqrt((double)D));
  dim3 grid(B * KV), block(kWarps * 32);
#define TD_CASE(GG)                                                                       \
  case GG:                                                                                \
    tiered_decode_kernel<T, D, GG><<<grid, block, 0, stream>>>(                           \
        (const T*)q, (const T*)hk, (const T*)hv, (const T*)ck, (const T*)cv, (T*)out, KV, \
        W, C, hot_len, cold_len, newest, scale);                                          \
    break;
  switch (G) {
    TD_CASE(1)
    TD_CASE(2)
    TD_CASE(4)
    TD_CASE(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef TD_CASE
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int D, int G, const void* q, const void* hk, const void* hv,
                     const void* ck, const void* cv, void* out, int B, int KV, int W, int C,
                     int hot_len, int cold_len, int newest, cudaStream_t stream) {
  switch (D) {
    case 16: return launch_g<T, 16>(G, q, hk, hv, ck, cv, out, B, KV, W, C, hot_len, cold_len, newest, stream);
    case 32: return launch_g<T, 32>(G, q, hk, hv, ck, cv, out, B, KV, W, C, hot_len, cold_len, newest, stream);
    case 64: return launch_g<T, 64>(G, q, hk, hv, ck, cv, out, B, KV, W, C, hot_len, cold_len, newest, stream);
    case 128: return launch_g<T, 128>(G, q, hk, hv, ck, cv, out, B, KV, W, C, hot_len, cold_len, newest, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for a D, G or dtype it was not built for).
extern "C" int tiered_decode_launch(const void* q, const void* hot_k, const void* hot_v,
                                    const void* cold_k, const void* cold_v, void* out, int B,
                                    int H, int KV, int W, int C, int D, int hot_len,
                                    int cold_len, int newest, int dtype, void* stream) {
  if (KV <= 0 || H % KV) return (int)cudaErrorInvalidValue;
  const int G = H / KV;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)launch_d<float>(D, G, q, hot_k, hot_v, cold_k, cold_v, out, B, KV, W, C,
                                hot_len, cold_len, newest, s);
  if (dtype == 1)
    return (int)launch_d<__nv_bfloat16>(D, G, q, hot_k, hot_v, cold_k, cold_v, out, B, KV, W,
                                        C, hot_len, cold_len, newest, s);
  return (int)cudaErrorInvalidValue;
}
