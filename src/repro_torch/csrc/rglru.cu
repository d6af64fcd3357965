// Gated linear recurrence (the RG-LRU core) for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/rglru.py::rglru_scan_fwd (Pallas body
// _rglru_kernel), which computes the recurrence of the RG-LRU block
// (src/repro/nn/recurrent.py::rglru_scan); prefill of every RG-LRU layer
// runs it.
//
// What it computes: h_t = a_t * h_{t-1} + x_t along S of (B, S, W) inputs,
// from h_{-1} = 0 (the caller folds a carry into x_0), with an fp32 carry;
// the output takes the inputs' dtype (fp32 or bf16).
//
// What bounds it on the H100: bytes.  Two reads and one write of B*S*W
// elements against 2 flops each: at B=4, S=W=4096 in fp32 that is 805 MB,
// 0.24 ms at 3.35 TB/s.
//
// What the design does about it (a first, simple kernel): one thread per
// (b, w) channel walks S.  A warp's loads of a[t] and x[t] are contiguous
// in w, so they coalesce into 128-byte lines, and they do not depend on h:
// each thread loads kUnroll steps of both before it runs their dependent
// FMAs, which keeps kUnroll * 2 loads in flight per thread.  Nothing is
// padded: the ragged W edge is masked, the ragged S tail runs step by step.
// B*W = 16,384 threads at the serving shape leave the card short of loads
// in flight; an S-split three-phase scan is the later step.  The TPU
// kernel's Hillis-Steele tile and its pad-with-zeros trick do not carry over.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int kThreads = 128;
constexpr int kUnroll = 16;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rglru_scan_kernel(const T* __restrict__ a, const T* __restrict__ x, T* __restrict__ out, int S, int W) {
  const int w = blockIdx.x * kThreads + threadIdx.x;
  if (w >= W) return;
  const size_t base = (size_t)blockIdx.y * S * W + w;
  const T* ap = a + base;
  const T* xp = x + base;
  T* op = out + base;
  float h = 0.f;
  int t = 0;
  for (; t + kUnroll <= S; t += kUnroll) {
    float av[kUnroll], xv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      av[u] = to_f(ap[(size_t)(t + u) * W]);
      xv[u] = to_f(xp[(size_t)(t + u) * W]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      h = fmaf(av[u], h, xv[u]);
      op[(size_t)(t + u) * W] = from_f<T>(h);
    }
  }
  for (; t < S; ++t) {
    h = fmaf(to_f(ap[(size_t)t * W]), h, to_f(xp[(size_t)t * W]));
    op[(size_t)t * W] = from_f<T>(h);
  }
}

template <typename T>
cudaError_t launch(const void* a, const void* x, void* out, int B, int S, int W, cudaStream_t stream) {
  dim3 grid((W + kThreads - 1) / kThreads, B), block(kThreads);
  rglru_scan_kernel<T><<<grid, block, 0, stream>>>((const T*)a, (const T*)x, (T*)out, S, W);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (a, x and out share it).  Returns
// cudaGetLastError() after the launch.
extern "C" int rglru_scan_launch(const void* a, const void* x, void* out, int B, int S, int W,
                                 int dtype, void* stream) {
  if (B <= 0 || S <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return (int)launch<float>(a, x, out, B, S, W, s);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(a, x, out, B, S, W, s);
  return (int)cudaErrorInvalidValue;
}
