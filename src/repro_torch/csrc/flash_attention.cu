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
// type (989 TFLOP/s bf16 on the tensor cores, 67 TFLOP/s fp32 outside them).
//
// Two kernels; kernels/flash_attention.py::flash_path picks one from
// (dtype, D) alone, and a launch that fails raises (no retry on the other):
//
// 1. flash_wgmma_kernel, bf16 at D in {64, 128, 256} (both main-path shapes:
//    qwen3 D = 128, recurrentgemma D = 256), on the tensor cores:
//    * one block per (b, h, tile of 128 query rows), tiles launched longest
//      first (causal tiles at the end of S see the most keys).  Two
//      warpgroups own 64 query rows each.  There is no producer warpgroup:
//      with a third warpgroup (or a lone producer warp) ptxas held every
//      thread to 65536 / 384 = 168 registers whatever setmaxnreg asked, and
//      D = 256 (a 64 x 256 fp32 O accumulator is 128 registers a thread)
//      spilled 820-888 bytes; with 256 threads each may hold 255;
//    * Q is loaded once by TMA; K and V tiles of BN keys (128, or 64 at
//      D = 256) come through a 2-stage ring by TMA with 128-byte swizzle,
//      full/empty mbarriers signalling arrival and release.  Thread 0 issues
//      the copies: once both warpgroups have released tile i, it loads tile
//      i + 2 into the same stage, so the copy overlaps the products of tile
//      i + 1.  The tensor maps are 3-D
//      over (D, rows, B * heads): a ragged S or T edge is zero-filled and
//      never reads the next head's rows.  A row of D values is D / 64
//      swizzle atoms of 128 bytes, each its own TMA box and column block;
//    * S = Q K^T by wgmma m64nBNk16 with both operands in shared memory
//      (K-major), fp32 accumulators; the online softmax runs on the
//      accumulator fragments (row max and sum over a quad by shuffles, exp2
//      in fp32); P is cast to bf16 in registers, whose layout is already
//      wgmma's A fragment, and O += P V by wgmma m64nDk16 with A in
//      registers and V as the B operand in its D-contiguous (MN-major)
//      layout, transpose bit set;
//    * key tiles fully outside causal or window reach are never loaded;
//      diagonal, window-edge and ragged tiles are masked elementwise;
//    * shared memory: D = 128: Q 32 KB + 2 x (K + V) 128 KB; D = 256: Q 64 KB
//      + 2 x (K + V of 64 keys) 128 KB; D = 64: 80 KB.
// 2. flash_fwd_kernel, fp32 (which must hold 2e-5: TF32 cannot, and the
//    Pallas kernel computes fp32 in fp32) and bf16 at D in {16, 32}, on the
//    CUDA cores:
//    * one block per (b, h, tile of 32 query rows); the key loop runs inside
//      the block with the online softmax state (m, l, acc) in fp32
//      registers, so the (S, T) score matrix never touches device memory;
//    * K and V tiles of 32 keys are staged through shared memory once per
//      block and reused by all 32 query rows; the K tile's rows are padded
//      to D + 1 floats so lane j reading key j hits distinct banks;
//    * key tiles that causality or the window masks out entirely are never
//      loaded; ragged S and T edges are masked in the kernel.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

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
                   int S, int Tk, int causal, int window, float softcap, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((S + kBQ - 1) / kBQ, B * H), block(kWarps * 32);
  flash_fwd_kernel<T, D><<<grid, block, smem, stream>>>((const T*)q, (const T*)k, (const T*)v,
                                                        (T*)out, H, KV, S, Tk, causal, window,
                                                        softcap, scale);
  return cudaGetLastError();
}

// fp32 at every D; bf16 only at D = 16 and 32 (it takes the tensor cores above).
template <typename T>
cudaError_t launch_d(int D, const void* q, const void* k, const void* v, void* out, int B, int H,
                     int KV, int S, int Tk, int causal, int window, float softcap, float scale,
                     cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, out, B, H, KV, S, Tk, causal, window, softcap, scale, stream);
    case 32: return launch<T, 32>(q, k, v, out, B, H, KV, S, Tk, causal, window, softcap, scale, stream);
  }
  if constexpr (std::is_same<T, float>::value) {
    switch (D) {
      case 64: return launch<T, 64>(q, k, v, out, B, H, KV, S, Tk, causal, window, softcap, scale, stream);
      case 128: return launch<T, 128>(q, k, v, out, B, H, KV, S, Tk, causal, window, softcap, scale, stream);
      case 256: return launch<T, 256>(q, k, v, out, B, H, KV, S, Tk, causal, window, softcap, scale, stream);
    }
  }
  return cudaErrorInvalidValue;
}


// ------------------------------------------------------------------------
// Tensor-core kernel (bf16, D in {64, 128, 256})
// ------------------------------------------------------------------------

namespace tc {

constexpr int kBM = 128;                  // query rows per block
constexpr int kWarpgroups = 2;            // 64 query rows each
constexpr int kThreads = 128 * kWarpgroups;
constexpr int kStages = 2;                // K/V ring depth
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct Cfg {
  static constexpr int BN = D == 256 ? 64 : 128;  // keys per tile
  static constexpr int CB = D / 64;               // 128-byte column blocks of a row
  static constexpr int Q_BYTES = kBM * D * 2;
  static constexpr int KV_BYTES = BN * D * 2;     // one K (or V) tile
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + kStages * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + kStages * KV_BYTES;
  static constexpr int SMEM = BAR_OFF + 64 + 1024;  // barriers, and slack to align to 1024
  static_assert(SMEM <= 232448, "shared memory of one block");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait for the phase of parity `parity` to complete.  A wait that never
// ends is a bug; the bounded spin turns it into a trap (a launch error the
// wrapper raises) instead of a hung card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t spins = 0;; ++spins) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spins == (1u << 24)) __trap();
  }
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor for a tile written by TMA with 128-byte
// swizzle: start address, leading and stride byte offsets (16-byte units),
// layout type 1 (128B swizzle).  K-major: the stride byte offset is the
// 1024 bytes between 8-row groups, the leading one is unused (1).  MN-major
// (V): the leading byte offset steps between 64-wide column blocks along N,
// the stride byte offset between 8-key groups along K.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr >> 4) & 0x3FFF) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmma.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D(64 x N, fp32) (+)= A(64 x 16) B(16 x N): A and B in shared memory, K-major.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da, uint64_t db, int scale_d);
// D(64 x N, fp32) += A(64 x 16, bf16 registers) B(16 x N): B in shared memory, MN-major.
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db,
                                         int scale_d);

template <> __device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <> __device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <> __device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <> __device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <> __device__ __forceinline__ void wgmma_rs<256>(float (&d)[128], const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}


template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
                   const __grid_constant__ CUtensorMap v_map, const __nv_bfloat16* __restrict__ v,
                   __nv_bfloat16* __restrict__ out, int H, int KV, int S, int Tk, int causal,
                   int window, float softcap, float scale) {
  using C = Cfg<D>;
  constexpr int BN = C::BN;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;  // 128B swizzle wants 1024
  const uint32_t bar_q = base + C::BAR_OFF;
  const uint32_t bar_full = bar_q + 8;                  // [kStages]
  const uint32_t bar_empty = bar_full + 8 * kStages;    // [kStages]

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int kv_row = b * KV + h / (H / KV);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBM;  // longest tiles first
  const int offset = Tk - S;                          // right-aligned causality when T > S

  // Key tiles this query tile can see; whole tiles outside are never loaded.
  const int q_first = q0 + offset;
  const int q_last = min(q0 + kBM, S) - 1 + offset;
  const int k_end = causal ? min(Tk, q_last + 1) : Tk;
  const int k_begin = window > 0 ? max(0, q_first - window + 1) : 0;
  const int t_begin = k_begin / BN;
  const int n_tiles = k_end > k_begin ? (k_end + BN - 1) / BN - t_begin : 0;

  // Thread 0 issues every copy: K and V of tile i into stage i % kStages.
  auto load_tile = [&](int i) {
    const int s = i % kStages;
    mbar_expect_tx(bar_full + 8 * s, 2 * C::KV_BYTES);
    const int k0 = (t_begin + i) * BN;
    const uint32_t ks = base + C::K_OFF + s * C::KV_BYTES;
    const uint32_t vs = base + C::V_OFF + s * C::KV_BYTES;
#pragma unroll
    for (int c = 0; c < C::CB; ++c) {
      tma_load_3d(ks + c * BN * 128, &k_map, bar_full + 8 * s, c * 64, k0, kv_row);
      tma_load_3d(vs + c * BN * 128, &v_map, bar_full + 8 * s, c * 64, k0, kv_row);
    }
  };
  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, kThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(bar_q, C::Q_BYTES);
#pragma unroll
    for (int c = 0; c < C::CB; ++c) tma_load_3d(base + c * kBM * 128, &q_map, bar_q, c * 64, q0, bh);
    for (int i = 0; i < kStages && i < n_tiles; ++i) load_tile(i);
  }
  __syncthreads();

  {
    const int cw = threadIdx.x / 128;
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int row0 = q0 + 64 * cw + 16 * warp + lane / 4;  // fragment rows row0, row0 + 8
    const int qpos0 = row0 + offset, qpos1 = qpos0 + 8;
    const int wg_qmin = q0 + 64 * cw + offset;
    const int wg_qmax = min(q0 + 64 * cw + 63, S - 1) + offset;
    const float inv_cap = softcap > 0.f ? 1.f / softcap : 0.f;
    const float scale_log2 = scale * kLog2e;  // scores in the log2 domain
    const uint32_t q_base = base + cw * 64 * 128;

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;  // log2 domain
    mbar_wait(bar_q, 0);

    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % kStages;
      mbar_wait(bar_full + 8 * s, (i / kStages) & 1);
      const uint32_t ks = base + C::K_OFF + s * C::KV_BYTES;
      const uint32_t vs = base + C::V_OFF + s * C::KV_BYTES;

      float sc[BN / 2];
      fence_regs(sc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t col = (kk % 4) * 32;  // 16 bf16 = 32 bytes into the swizzle atom
        const uint64_t da = sw128_desc(q_base + (kk / 4) * kBM * 128 + col, 16, 1024);
        const uint64_t db = sw128_desc(ks + (kk / 4) * BN * 128 + col, 16, 1024);
        wgmma_ss<BN>(sc, da, db, kk > 0);
      }
      wg_commit();
      wg_wait_all();
      fence_regs(sc);

      const int k0 = (t_begin + i) * BN;
      const bool need_mask = k0 + BN > Tk || (causal && k0 + BN - 1 > wg_qmin) ||
                             (window > 0 && k0 <= wg_qmax - window);
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sc[4 * j + e] * scale_log2;
          if (softcap > 0.f) x = softcap * kLog2e * tanhf(sc[4 * j + e] * scale * inv_cap);
          if (need_mask) {
            const int key = k0 + 8 * j + 2 * (lane % 4) + (e & 1);
            const int qp = e < 2 ? qpos0 : qpos1;
            bool valid = key < Tk;
            if (causal) valid = valid && key <= qp;
            if (window > 0) valid = valid && key > qp - window;
            if (!valid) x = -INFINITY;
          }
          sc[4 * j + e] = x;
          if (e < 2) mx0 = fmaxf(mx0, x);
          else mx1 = fmaxf(mx1, x);
        }
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float mu0 = mn0 == -INFINITY ? 0.f : mn0;  // a row with no key yet: no NaN
      const float mu1 = mn1 == -INFINITY ? 0.f : mn1;
      const float alpha0 = exp2f(m0 - mu0), alpha1 = exp2f(m1 - mu1);
      m0 = mn0;
      m1 = mn1;

      uint32_t pa[BN / 16][4];
      float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const float p0 = exp2f(sc[4 * j + 0] - mu0), p1 = exp2f(sc[4 * j + 1] - mu0);
        const float p2 = exp2f(sc[4 * j + 2] - mu1), p3 = exp2f(sc[4 * j + 3] - mu1);
        ls0 += p0 + p1;
        ls1 += p2 + p3;
        // keys 16kk..16kk+15 of rows (r, r + 8): a[0..3] = (r, lo), (r + 8, lo), (r, hi), (r + 8, hi)
        pa[j / 2][(j % 2) * 2 + 0] = pack_bf16(p0, p1);
        pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(p2, p3);
      }
      l0 = alpha0 * l0 + ls0;
      l1 = alpha1 * l1 + ls1;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j + 0] *= alpha0;
        o[4 * j + 1] *= alpha0;
        o[4 * j + 2] *= alpha1;
        o[4 * j + 3] *= alpha1;
      }

      fence_regs(o);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        wgmma_rs<D>(o, pa[kk], sw128_desc(vs + kk * 16 * 128, BN * 128, 1024), 1);
      wg_commit();
      wg_wait_all();
      fence_regs(o);
      mbar_arrive(bar_empty + 8 * s);  // this stage's K and V are no longer read
      if (threadIdx.x == 0 && i + kStages < n_tiles) {
        mbar_wait(bar_empty + 8 * s, (i / kStages) & 1);  // both warpgroups are done with tile i
        load_tile(i + kStages);  // overlaps the products of tile i + 1
      }
    }

    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);

    // Rows that saw no valid key (l == 0; only causal rows with T < S): their
    // o is still 0; sum v over all T keys so the division gives the mean.
    const __nv_bfloat16* vb = v + (size_t)kv_row * Tk * D + 2 * (lane % 4);
    if (l0 == 0.f && row0 < S && Tk > 0) {
      for (int t = 0; t < Tk; ++t) {
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(vb + (size_t)t * D + 8 * j));
          o[4 * j + 0] += x.x;
          o[4 * j + 1] += x.y;
        }
      }
      l0 = (float)Tk;
    }
    if (l1 == 0.f && row0 + 8 < S && Tk > 0) {
      for (int t = 0; t < Tk; ++t) {
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(vb + (size_t)t * D + 8 * j));
          o[4 * j + 2] += x.x;
          o[4 * j + 3] += x.y;
        }
      }
      l1 = (float)Tk;
    }
    const float inv0 = l0 == 0.f ? 0.f : 1.f / l0, inv1 = l1 == 0.f ? 0.f : 1.f / l1;
    __nv_bfloat16* ob = out + ((size_t)bh * S + row0) * D + 2 * (lane % 4);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      if (row0 < S)
        *reinterpret_cast<__nv_bfloat162*>(ob + 8 * j) = __floats2bfloat162_rn(o[4 * j] * inv0, o[4 * j + 1] * inv0);
      if (row0 + 8 < S)
        *reinterpret_cast<__nv_bfloat162*>(ob + 8 * D + 8 * j) =
            __floats2bfloat162_rn(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
    }
  }
}

// cuTensorMapEncodeTiled is a driver-API call; the library links only the
// runtime, so it is taken from the driver's entry point table once.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 3-D map over a bf16 (outer, rows, D) tensor: dims (D, rows, outer), box
// (64, box_rows, 1) with 128-byte swizzle; rows past the edge read as zero.
bool make_map(EncodeTiled enc, CUtensorMap* map, const void* ptr, int D, int rows, int outer, int box_rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)rows, (cuuint64_t)outer};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)rows * D * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int B, int H, int KV, int S,
                   int Tk, int causal, int window, float softcap, float scale, cudaStream_t stream) {
  using C = Cfg<D>;
  const EncodeTiled enc = encode_tiled();
  if (!enc) return cudaErrorNotSupported;
  CUtensorMap qm, km, vm;
  // With T = 0 no key tile is loaded; the K/V maps then describe q (any
  // valid memory) and are never read.
  const void* kp = Tk > 0 ? k : q;
  const void* vp = Tk > 0 ? v : q;
  const int krows = Tk > 0 ? Tk : S, kouter = Tk > 0 ? B * KV : B * H;
  if (!make_map(enc, &qm, q, D, S, B * H, kBM) || !make_map(enc, &km, kp, D, krows, kouter, C::BN) ||
      !make_map(enc, &vm, vp, D, krows, kouter, C::BN))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(flash_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid(B * H, (S + kBM - 1) / kBM), block(kThreads);
  flash_wgmma_kernel<D><<<grid, block, C::SMEM, stream>>>(qm, km, vm, (const __nv_bfloat16*)v,
                                                          (__nv_bfloat16*)out, H, KV, S, Tk, causal,
                                                          window, softcap, scale);
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace

// The CUDA-core kernel.  dtype: 0 = float32 (D in 16..256), 1 = bfloat16
// (D in 16, 32).  scale: the score scale, 1 / sqrt(head dim) (the caller's
// head dim, which is below D where it zero-pads q, k and v to a built D).
// Returns cudaGetLastError() after the launch (cudaErrorInvalidValue for a D
// or dtype it was not built for).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                                      int B, int H, int KV, int S, int T, int D, int causal,
                                      int window, float softcap, float scale, int dtype, void* stream) {
  if (KV <= 0 || H % KV || S <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)launch_d<float>(D, q, k, v, out, B, H, KV, S, T, causal, window, softcap, scale, s);
  if (dtype == 1)
    return (int)launch_d<__nv_bfloat16>(D, q, k, v, out, B, H, KV, S, T, causal, window, softcap, scale, s);
  return (int)cudaErrorInvalidValue;
}

// The tensor-core kernel: bf16 operands, D in {64, 128, 256}, 16-byte
// aligned; scale as above.  Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for a D it was not built for or a tensor map the
// driver refuses).
extern "C" int flash_attention_wgmma_launch(const void* q, const void* k, const void* v, void* out,
                                            int B, int H, int KV, int S, int T, int D, int causal,
                                            int window, float softcap, float scale, void* stream) {
  if (KV <= 0 || H % KV || S <= 0 || B <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 64: return (int)tc::launch<64>(q, k, v, out, B, H, KV, S, T, causal, window, softcap, scale, s);
    case 128: return (int)tc::launch<128>(q, k, v, out, B, H, KV, S, T, causal, window, softcap, scale, s);
    case 256: return (int)tc::launch<256>(q, k, v, out, B, H, KV, S, T, causal, window, softcap, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
