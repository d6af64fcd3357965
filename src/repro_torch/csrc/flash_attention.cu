// Tiled attention forward (flash attention) for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention_fwd
// (Pallas body _flash_kernel), which prefill runs in every layer when
// cfg.attn_impl == "flash".
//
// What it computes: out = softmax(mask(cap(q . k / sqrt(D)))) v with GQA
// (query head h reads kv head h / (H/KV)), causal masking right-aligned when
// T > S (query row i sits at position i + T - S), an optional sliding window
// (key position > query position - window) and an optional logit softcap
// c * tanh(s / c).  A row with no valid key (causal with T < S) gives the
// mean of v over all T keys, as the reference's softmax of T equal -1e30
// scores does: a rare finalize branch.  Forward only.
//
// What bounds it on the H100: operations.  Causal prefill at S = T = 1024,
// D = 128 does about 2 * 2 * S * T / 2 * D flops per head against 4 * S * D
// bytes in and out, hundreds of flops a byte.  The least time is the flops
// of the unmasked score and PV products over the card's peak for the input
// type (989 TFLOP/s bf16, 67 TFLOP/s fp32 outside the tensor cores).
//
// What the design does about it (a first, simple kernel):
//   * one block per (b, h, tile of 32 query rows); the key loop runs inside
//     the block with the online softmax state (m, l, acc) in fp32 registers,
//     so the (S, T) score matrix never touches device memory;
//   * K and V tiles of 32 keys are staged through shared memory once per
//     block and reused by all 32 query rows; the K tile's rows are padded to
//     D + 1 floats so lane j reading key j hits distinct banks;
//   * key tiles that causality or the window masks out entirely are never
//     loaded: the loop runs over [first needed tile, last needed tile];
//   * ragged S and T edges are masked in the kernel, nothing is padded.
// The products run on the CUDA cores in fp32, so the kernel sits far below
// the tensor-core bound; wgmma with TMA-fed tiles is the later step.  At
// D = 256 (recurrentgemma's local attention) the tiles take 98,432 bytes of
// dynamic shared memory and each lane holds 8 x 8 output accumulators.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int kWarps = 4;            // warps per block
constexpr int kRows = 8;             // query rows per warp
constexpr int kBQ = kWarps * kRows;  // query rows per block
constexpr int kBK = 32;              // keys per tile: one per lane

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

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)kBQ * D + (size_t)kBK * (D + 1) + (size_t)kBK * D);
}

template <typename T, int D>
__global__ void __launch_bounds__(kWarps * 32)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ out, int H, int KV, int S, int Tk, int causal, int window,
                 float softcap, float scale) {
  constexpr int EPL = (D + 31) / 32;  // output elements per lane: d = lane + 32 * e
  extern __shared__ float smem[];
  float* Qs = smem;                  // [kBQ][D]
  float* Ks = Qs + kBQ * D;          // [kBK][D + 1]
  float* Vs = Ks + kBK * (D + 1);    // [kBK][D]

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int kvh = h / (H / KV);
  const int q0 = blockIdx.x * kBQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int offset = Tk - S;  // right-aligned causality when T > S

  const T* qb = q + ((size_t)bh * S) * D;
  const T* kb = k + ((size_t)(b * KV + kvh) * Tk) * D;
  const T* vb = v + ((size_t)(b * KV + kvh) * Tk) * D;

  for (int idx = threadIdx.x; idx < kBQ * D; idx += blockDim.x) {
    const int r = idx / D, d = idx % D;
    Qs[idx] = (q0 + r < S) ? to_f(qb[(size_t)(q0 + r) * D + d]) : 0.f;
  }

  // Key range this query tile can see; whole tiles outside it are skipped.
  const int q_first = q0 + offset;
  const int q_last = min(q0 + kBQ, S) - 1 + offset;
  const int k_end = causal ? min(Tk, q_last + 1) : Tk;
  const int k_begin = window > 0 ? max(0, q_first - window + 1) : 0;

  float m[kRows], l[kRows], acc[kRows][EPL];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[r][e] = 0.f;
  }

  for (int k0 = (k_begin / kBK) * kBK; k0 < k_end; k0 += kBK) {
    __syncthreads();  // previous tile fully consumed (and Qs written, first time)
    for (int idx = threadIdx.x; idx < kBK * D; idx += blockDim.x) {
      const int j = idx / D, d = idx % D;
      const bool in = k0 + j < Tk;
      Ks[j * (D + 1) + d] = in ? to_f(kb[(size_t)(k0 + j) * D + d]) : 0.f;
      Vs[j * D + d] = in ? to_f(vb[(size_t)(k0 + j) * D + d]) : 0.f;
    }
    __syncthreads();

    // Scores: lane j holds key k0 + j against this warp's kRows rows.
    float s[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = 0.f;
    const float* krow = Ks + lane * (D + 1);
    const float* qrow = Qs + (warp * kRows) * D;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float kd = krow[d];
#pragma unroll
      for (int r = 0; r < kRows; ++r) s[r] += qrow[r * D + d] * kd;
    }

    const int kpos = k0 + lane;
    float p[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      p[r] = 0.f;
      const int row = q0 + warp * kRows + r;
      const int qpos = row + offset;
      float sc = s[r] * scale;
      if (softcap > 0.f) sc = softcap * tanhf(sc / softcap);
      bool valid = row < S && kpos < Tk;
      if (causal) valid = valid && kpos <= qpos;
      if (window > 0) valid = valid && kpos > qpos - window;
      const float mt = warp_max(valid ? sc : -INFINITY);
      if (mt == -INFINITY) continue;  // warp-uniform: no valid key in this tile
      const float m_new = fmaxf(m[r], mt);
      const float alpha = (m[r] == -INFINITY) ? 0.f : expf(m[r] - m_new);
      p[r] = valid ? expf(sc - m_new) : 0.f;  // explicit zero for masked keys
      l[r] = alpha * l[r] + warp_sum(p[r]);
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[r][e] *= alpha;
      m[r] = m_new;
    }

    // acc[r][d] += sum_j p[r][j] * V[j][d]; p[r][j] sits in lane j.
#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float vv[EPL];
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        const int d = lane + 32 * e;
        vv[e] = d < D ? Vs[j * D + d] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float pj = __shfl_sync(0xffffffffu, p[r], j);
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[r][e] += pj * vv[e];
      }
    }
  }

  // Rows that saw no valid key (l == 0, warp-uniform): their acc is still 0;
  // sum v over all T keys into it, so that the division below gives the mean.
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (q0 + warp * kRows + r >= S || l[r] != 0.f || Tk == 0) continue;
    for (int t = 0; t < Tk; ++t) {
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        const int d = lane + 32 * e;
        if (d < D) acc[r][e] += to_f(vb[(size_t)t * D + d]);
      }
    }
    l[r] = (float)Tk;
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = q0 + warp * kRows + r;
    if (row >= S) continue;
    const float inv = l[r] == 0.f ? 0.f : 1.f / l[r];  // l == 0 only when T == 0
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      const int d = lane + 32 * e;
      if (d < D) out[((size_t)bh * S + row) * D + d] = from_f<T>(acc[r][e] * inv);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int B, int H, int KV,
                   int S, int Tk, int causal, int window, float softcap, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const float scale = (float)(1.0 / sqrt((double)D));
  dim3 grid((S + kBQ - 1) / kBQ, B * H), block(kWarps * 32);
  flash_fwd_kernel<T, D><<<grid, block, smem, stream>>>((const T*)q, (const T*)k, (const T*)v,
                                                        (T*)out, H, KV, S, Tk, causal, window,
                                                        softcap, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int D, const void* q, const void* k, const void* v, void* out, int B, int H,
                     int KV, int S, int Tk, int causal, int window, float softcap,
                     cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, out, B, H, KV, S, Tk, causal, window, softcap, stream);
    case 32: return launch<T, 32>(q, k, v, out, B, H, KV, S, Tk, causal, window, softcap, stream);
    case 64: return launch<T, 64>(q, k, v, out, B, H, KV, S, Tk, causal, window, softcap, stream);
    case 128: return launch<T, 128>(q, k, v, out, B, H, KV, S, Tk, causal, window, softcap, stream);
    case 256: return launch<T, 256>(q, k, v, out, B, H, KV, S, Tk, causal, window, softcap, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for a D or dtype it was not built for).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                                      int B, int H, int KV, int S, int T, int D, int causal,
                                      int window, float softcap, int dtype, void* stream) {
  if (KV <= 0 || H % KV || S <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return (int)launch_d<float>(D, q, k, v, out, B, H, KV, S, T, causal, window, softcap, s);
  if (dtype == 1)
    return (int)launch_d<__nv_bfloat16>(D, q, k, v, out, B, H, KV, S, T, causal, window, softcap, s);
  return (int)cudaErrorInvalidValue;
}
