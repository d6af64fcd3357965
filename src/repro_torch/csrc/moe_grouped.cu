// The held experts' product of an expert share, for Hopper (sm_90a).
//
// Replaces: no Pallas kernel.  The JAX package computes MoE as a
// capacity-padded einsum over every expert's slots
// (src/repro/nn/layers.py::moe_apply); the port's expert share
// (src/repro_torch/nn/layers.py::moe_share_apply) computes only the
// assignments routed to the experts a device holds, and this is its product.
//
// What it computes: the share's assignments come sorted by expert, each
// expert's run padded to a tile of BM rows (nn/layers.py::route_share), with
// a tile -> local expert table on the device.  For padded row r of a tile of
// expert e, whose assignment rows[r] is token t = rows[r] / top_k:
//   y[r] = gate[r] * (silu(x_t Wg_e) * (x_t Wu_e)) Wd_e
// with fp32 sums, the intermediate (R, f) rounded to the operands' dtype
// (kernels/ref.py::moe_grouped_ref does the same).  A padding row
// (rows[r] >= T * top_k) reads zeros and has gate 0; a tile whose table entry
// is n_held (past the last used tile) exits at once, leaving its rows
// unwritten: no assignment maps to them.
//
// What bounds it on the H100: at decode, bytes.  Each held expert with a row
// reads its three d x f matrices once (96 MB at d = f = 4096 in bf16, 8
// experts in 0.23 ms at 3.35 TB/s) for one or two rows.  A 4096-token
// prefill chunk gives ~256 rows an expert, near the ridge.
//
// What the design does about it (vLLM's fused_moe, in two launches):
//  * gate_up: a block takes one tile's BM rows and BN columns of the expert
//    width, gathers the tile's token rows of x, and multiplies them by Wg and
//    by Wu over d (one A tile serves both), then stores silu(g) * u;
//  * down: a block takes the tile's BM intermediate rows and BN columns of d,
//    multiplies them by Wd over f, and scales each row by its gate.
// Operand tiles go from global to shared memory by cp.async in a ring of
// STAGES tiles (16-byte copies, zero-filled past the edges and on padding
// rows), so each block keeps STAGES - 1 tiles of weights in flight: decode's
// blocks do almost no arithmetic and are paced by those loads.  bf16 and fp16
// multiply on the tensor cores through WMMA 16x16x16 fragments with fp32
// accumulators; fp32 multiplies in full fp32 on the CUDA cores (no TF32), as
// its plain twin does.  The grid covers every tile that could be used, sized
// from the assignment count: no launch waits for the host to read a count.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <type_traits>

namespace {

using namespace nvcuda;

template <typename T, int BM>
struct Cfg {
  static constexpr bool kTensor = sizeof(T) == 2;
  static constexpr int BN = 64;                      // output columns a block
  static constexpr int BK = kTensor ? 64 : 32;       // depth a pipeline stage
  static constexpr int VEC = 16 / (int)sizeof(T);    // elements a 16-byte copy
  static constexpr int LDA = BK + VEC;               // shared rows padded by 16 bytes
  static constexpr int LDB = BN + VEC;
  static constexpr int LDC = BN + 4;                 // the fp32 epilogue tile
  static constexpr int THREADS = BM == 16 ? 128 : 256;
  static constexpr int STAGES = !kTensor ? 2 : (BM == 16 ? 4 : 3);
  // Two 128-row blocks an SM (registers capped at 128): twice the loads in
  // flight of one, 14% less time a 4096-token chunk on the H100.
  static constexpr int MIN_BLOCKS = BM == 128 ? 2 : 1;
  static constexpr int WARPS_N = BM == 16 ? 4 : 2;   // warps over BN; the rest over BM
  static constexpr int WARPS_M = THREADS / 32 / WARPS_N;
  static constexpr int FM = BM / (16 * WARPS_M);     // 16x16 fragments a warp, down and across
  static constexpr int FN = BN / (16 * WARPS_N);
};

template <typename T, int BM, int NB>
constexpr size_t smem_bytes() {
  using C = Cfg<T, BM>;
  size_t ring = (size_t)C::STAGES * (BM * C::LDA + NB * C::BK * C::LDB) * sizeof(T);
  size_t epilogue = (size_t)NB * BM * C::LDC * sizeof(float);
  return ring > epilogue ? ring : epilogue;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  int n = full ? 16 : 0;  // 0: the 16 bytes are zero-filled, nothing is read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) { return __float2bfloat16(x); }
template <> __device__ __forceinline__ __half from_f<__half>(float x) { return __float2half(x); }

// The block's NB products of a (BM x BK) A tile by (BK x BN) B tiles on the
// tensor cores: warp (wm, wn) holds FM x FN fragments of each.
template <typename T, int BM, int NB>
struct TensorMma {
  using C = Cfg<T, BM>;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NB][C::FM][C::FN];
  int wm, wn;

  __device__ TensorMma() {
    const int warp = threadIdx.x / 32;
    wm = warp / C::WARPS_N;
    wn = warp % C::WARPS_N;
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int i = 0; i < C::FM; ++i)
#pragma unroll
        for (int j = 0; j < C::FN; ++j) wmma::fill_fragment(acc[b][i][j], 0.f);
  }

  __device__ __forceinline__ void step(const T* As, const T* Bs) {
#pragma unroll
    for (int kk = 0; kk < C::BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a[C::FM];
#pragma unroll
      for (int i = 0; i < C::FM; ++i)
        wmma::load_matrix_sync(a[i], As + ((wm * C::FM + i) * 16) * C::LDA + kk, C::LDA);
#pragma unroll
      for (int b = 0; b < NB; ++b)
#pragma unroll
        for (int j = 0; j < C::FN; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> w;
          wmma::load_matrix_sync(w, Bs + (b * C::BK + kk) * C::LDB + (wn * C::FN + j) * 16, C::LDB);
#pragma unroll
          for (int i = 0; i < C::FM; ++i) wmma::mma_sync(acc[b][i][j], a[i], w, acc[b][i][j]);
        }
    }
  }

  __device__ __forceinline__ void store(float* Cs) {
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int i = 0; i < C::FM; ++i)
#pragma unroll
        for (int j = 0; j < C::FN; ++j)
          wmma::store_matrix_sync(Cs + (b * BM + (wm * C::FM + i) * 16) * C::LDC + (wn * C::FN + j) * 16,
                                  acc[b][i][j], C::LDC, wmma::mem_row_major);
  }
};

// The same in fp32 on the CUDA cores: thread (tm, tn) holds rows tm + i * TR
// and columns tn + 16 j of each product.
template <int BM, int NB>
struct ScalarMma {
  using C = Cfg<float, BM>;
  static constexpr int TR = C::THREADS / 16, RM = BM / TR, CN = C::BN / 16;
  float acc[NB][RM][CN];
  int tm, tn;

  __device__ ScalarMma() : tm(threadIdx.x / 16), tn(threadIdx.x % 16) {
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) acc[b][i][j] = 0.f;
  }

  __device__ __forceinline__ void step(const float* As, const float* Bs) {
#pragma unroll 4
    for (int k = 0; k < C::BK; ++k) {
      float a[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i) a[i] = As[(tm + i * TR) * C::LDA + k];
#pragma unroll
      for (int b = 0; b < NB; ++b)
#pragma unroll
        for (int j = 0; j < CN; ++j) {
          const float w = Bs[(b * C::BK + k) * C::LDB + tn + 16 * j];
#pragma unroll
          for (int i = 0; i < RM; ++i) acc[b][i][j] = fmaf(a[i], w, acc[b][i][j]);
        }
    }
  }

  __device__ __forceinline__ void store(float* Cs) {
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < CN; ++j) Cs[(b * BM + tm + i * TR) * C::LDC + tn + 16 * j] = acc[b][i][j];
  }
};

// One block of either launch.  GATE_UP: A is x's rows gathered through
// rows (K = d), B the pair Wg, Wu (N = f), out the intermediate h.  Else: A
// is h's tile rows (K = f), B is Wd (N = d), out y, scaled by gate.
template <typename T, int BM, bool GATE_UP>
__device__ __forceinline__ void grouped_block(const T* __restrict__ a_src, const T* __restrict__ w0,
                                              const T* __restrict__ w1, const long long* __restrict__ rows,
                                              const int* __restrict__ tile_expert, const float* __restrict__ gate,
                                              T* __restrict__ out, long long n_assign, int top_k, int K, int N,
                                              int n_held) {
  using C = Cfg<T, BM>;
  constexpr int NB = GATE_UP ? 2 : 1;
  constexpr int STAGE = BM * C::LDA + NB * C::BK * C::LDB;
  using Mma = typename std::conditional<C::kTensor, TensorMma<T, BM, NB>, ScalarMma<BM, NB>>::type;

  const int e = tile_expert[blockIdx.x];
  if (e >= n_held) return;  // past the last used tile
  const long long r0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * C::BN;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  __shared__ long long src_row[BM];  // the A row each tile row reads; -1: zeros
  for (int m = threadIdx.x; m < BM; m += C::THREADS) {
    if (GATE_UP) {
      const long long r = rows[r0 + m];
      src_row[m] = r < n_assign ? r / top_k : -1;
    } else {
      src_row[m] = r0 + m;
    }
  }
  __syncthreads();
  const size_t w_off = (size_t)e * K * N;
  const T* b0 = w0 + w_off;
  const T* b1 = GATE_UP ? w1 + w_off : b0;

  auto load_stage = [&](int stage, int k0) {
    T* As = smem + stage * STAGE;
    T* Bs = As + BM * C::LDA;
    constexpr int A_ROW = C::BK / C::VEC, B_ROW = C::BN / C::VEC;
    for (int c = threadIdx.x; c < BM * A_ROW; c += C::THREADS) {
      const int m = c / A_ROW, kc = (c % A_ROW) * C::VEC;
      const long long sr = src_row[m];
      const bool in = sr >= 0 && k0 + kc < K;
      cp_async16(As + m * C::LDA + kc, in ? a_src + sr * K + k0 + kc : a_src, in);
    }
    for (int c = threadIdx.x; c < C::BK * B_ROW; c += C::THREADS) {
      const int k = c / B_ROW, nc = (c % B_ROW) * C::VEC;
      const bool in = k0 + k < K && n0 + nc < N;
      const size_t off = in ? (size_t)(k0 + k) * N + n0 + nc : 0;
      cp_async16(Bs + k * C::LDB + nc, b0 + off, in);
      if (GATE_UP) cp_async16(Bs + (C::BK + k) * C::LDB + nc, b1 + off, in);
    }
  };

  Mma mma;
  const int n_k = (K + C::BK - 1) / C::BK;
#pragma unroll
  for (int s = 0; s < C::STAGES - 1; ++s) {
    if (s < n_k) load_stage(s, s * C::BK);
    cp_async_commit();
  }
  for (int kt = 0; kt < n_k; ++kt) {
    cp_async_wait<C::STAGES - 2>();  // stage kt has landed (this thread's copies)
    __syncthreads();                 // ... everyone's, and stage kt - 1 is free
    const int next = kt + C::STAGES - 1;
    if (next < n_k) load_stage(next % C::STAGES, next * C::BK);
    cp_async_commit();
    const T* As = smem + (kt % C::STAGES) * STAGE;
    mma.step(As, As + BM * C::LDA);
  }
  cp_async_wait<0>();
  __syncthreads();

  float* Cs = reinterpret_cast<float*>(smem_raw);  // the ring is spent: reuse it
  mma.store(Cs);
  __syncthreads();
  for (int idx = threadIdx.x; idx < BM * C::BN; idx += C::THREADS) {
    const int m = idx / C::BN, n = idx % C::BN;
    if (n0 + n >= N) continue;
    float v = Cs[m * C::LDC + n];
    if (GATE_UP) {
      v = v / (1.f + expf(-v)) * Cs[(BM + m) * C::LDC + n];
    } else {
      v *= gate[r0 + m];
    }
    out[(r0 + m) * N + n0 + n] = from_f<T>(v);
  }
}

template <typename T, int BM>
__global__ void __launch_bounds__(Cfg<T, BM>::THREADS, Cfg<T, BM>::MIN_BLOCKS)
moe_gate_up_kernel(const T* __restrict__ x, const T* __restrict__ wg, const T* __restrict__ wu,
                   const long long* __restrict__ rows, const int* __restrict__ tile_expert, T* __restrict__ h,
                   long long n_assign, int top_k, int d, int f, int n_held) {
  grouped_block<T, BM, true>(x, wg, wu, rows, tile_expert, nullptr, h, n_assign, top_k, d, f, n_held);
}

template <typename T, int BM>
__global__ void __launch_bounds__(Cfg<T, BM>::THREADS, Cfg<T, BM>::MIN_BLOCKS)
moe_down_kernel(const T* __restrict__ h, const T* __restrict__ wd, const int* __restrict__ tile_expert,
                const float* __restrict__ gate, T* __restrict__ y, int d, int f, int n_held) {
  grouped_block<T, BM, false>(h, wd, nullptr, nullptr, tile_expert, gate, y, 0, 1, f, d, n_held);
}

template <typename T, int BM>
cudaError_t launch(const void* x, const void* wg, const void* wu, const void* wd, const void* rows,
                   const void* tile_expert, const void* gate, void* h, void* y, int tokens, int d, int f,
                   int n_held, int top_k, int n_tiles, cudaStream_t stream) {
  using C = Cfg<T, BM>;
  constexpr size_t smem_up = smem_bytes<T, BM, 2>(), smem_down = smem_bytes<T, BM, 1>();
  static bool sized = false;  // the opt-in above 48 KB of shared memory, once a kernel
  if (!sized) {
    cudaError_t err = cudaFuncSetAttribute(moe_gate_up_kernel<T, BM>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_up);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(moe_down_kernel<T, BM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem_down);
    if (err != cudaSuccess) return err;
    sized = true;
  }
  const dim3 block(C::THREADS);
  const dim3 grid_up(n_tiles, (f + C::BN - 1) / C::BN), grid_down(n_tiles, (d + C::BN - 1) / C::BN);
  moe_gate_up_kernel<T, BM><<<grid_up, block, smem_up, stream>>>(
      (const T*)x, (const T*)wg, (const T*)wu, (const long long*)rows, (const int*)tile_expert, (T*)h,
      (long long)tokens * top_k, top_k, d, f, n_held);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  moe_down_kernel<T, BM><<<grid_down, block, smem_down, stream>>>(
      (const T*)h, (const T*)wd, (const int*)tile_expert, (const float*)gate, (T*)y, d, f, n_held);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_tile(int tile, const void* x, const void* wg, const void* wu, const void* wd, const void* rows,
                        const void* tile_expert, const void* gate, void* h, void* y, int tokens, int d, int f,
                        int n_held, int top_k, int n_tiles, cudaStream_t s) {
  if (tile == 16) return launch<T, 16>(x, wg, wu, wd, rows, tile_expert, gate, h, y, tokens, d, f, n_held, top_k, n_tiles, s);
  if (tile == 128) return launch<T, 128>(x, wg, wu, wd, rows, tile_expert, gate, h, y, tokens, d, f, n_held, top_k, n_tiles, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// x (tokens, d); wg, wu (n_held, d, f); wd (n_held, f, d); rows (n_tiles *
// tile,) int64; tile_expert (n_tiles,) int32; gate (n_tiles * tile,) fp32;
// h (n_tiles * tile, f) and y (n_tiles * tile, d) outputs; all contiguous, d
// and f multiples of 8.  tile: 16 or 128.  dtype: 0 = float32, 1 =
// bfloat16, 2 = float16.  Launches gate_up then down on the stream; returns
// cudaGetLastError() after them.
extern "C" int moe_grouped_launch(const void* x, const void* wg, const void* wu, const void* wd, const void* rows,
                                  const void* tile_expert, const void* gate, void* h, void* y, int tokens, int d,
                                  int f, int n_held, int top_k, int n_tiles, int tile, int dtype, void* stream) {
  if (tokens <= 0 || d <= 0 || f <= 0 || n_held <= 0 || top_k <= 0 || n_tiles <= 0 || d % 8 || f % 8)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return (int)launch_tile<float>(tile, x, wg, wu, wd, rows, tile_expert, gate, h, y, tokens, d, f, n_held, top_k, n_tiles, s);
  if (dtype == 1) return (int)launch_tile<__nv_bfloat16>(tile, x, wg, wu, wd, rows, tile_expert, gate, h, y, tokens, d, f, n_held, top_k, n_tiles, s);
  if (dtype == 2) return (int)launch_tile<__half>(tile, x, wg, wu, wd, rows, tile_expert, gate, h, y, tokens, d, f, n_held, top_k, n_tiles, s);
  return (int)cudaErrorInvalidValue;
}
