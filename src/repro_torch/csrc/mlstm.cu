// Chunkwise mLSTM forward for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/mlstm.py::mlstm_chunkwise_fwd (Pallas body
// _mlstm_kernel), which computes the recurrence of the xLSTM mLSTM block
// (the lax.scan of src/repro/nn/recurrent.py::mlstm_block_apply); prefill
// of every mLSTM layer runs it.
//
// What it computes, per (b, h), chunk by chunk of L steps (b = cumsum of
// the log forget gates f inside the chunk, g = log input gates, l <= j):
//
//     w_jl  = b_j - b_l + g_l,   m_j = max(max_l w_jl, m_prev + b_j)
//     num_j = e^{m_prev + b_j - m_j} C_prev q_j + sum_l e^{w_jl - m_j} (k_l . q_j) v_l
//     n_j.q_j = e^{m_prev + b_j - m_j} n_prev . q_j + sum_l e^{w_jl - m_j} (k_l . q_j)
//     h_j   = num_j / max(|n_j . q_j|, 1)
//
// and at the chunk's end the carry (C, n, m) with m_next = max(m_prev +
// b_last, max_l (b_last - b_l + g_l)) — the same stabiliser the sequential
// scan reaches, so h and the carry equal the scan's.  C is kept as C[v][k]
// (the model's state layout).  The carry may come in (C0, n0, m0) and always
// goes out; m_prev = -inf is the empty history and takes exactly the fresh
// start's branch (no exp of -inf - -inf, no NaN).
//
// What bounds it on the H100: operations.  Per (b, h) and chunk the block
// does 4 L D^2 flops for C_prev q and the carry update and about 4 L^2 D
// for the scores and their weighted sum: at B = H = 4, S = 2048, D = 384
// that is about 22 GFLOP in fp32, 0.32 ms at 67 TFLOP/s on the CUDA cores,
// against 0.06 ms for its bytes.
//
// What the design does about it (a first, simple kernel):
//   * the fp32 carry C is D x D = 576 KB at D = 384, more than an SM's shared
//     memory (the TPU kernel holds it in VMEM scratch).  The value dimension
//     is split across blocks: block (dv tile, b*h) owns C[dv tile][:] (64 x
//     384 floats = 96 KB) in shared memory for the whole sequence, and each
//     such block recomputes the cheap (L, L) decay and score matrices and n;
//     with n . q_j formed from the scores (n_j . q_j above) no block needs
//     the whole n_j;
//   * L = 32 so q, k (rows padded to D + 1 floats: lane l reads key l without
//     bank conflicts), the v tile and the C tile fit one block: 211 KB at
//     D = 384.  Lane l of a warp is key l for the scores; each thread owns
//     4 rows x 2 columns of the output and 48 x 2 entries of C in the carry
//     update, with its v column scaled by the chunk-end weights in registers;
//   * the ragged last chunk is masked in the kernel (its missing steps have
//     no weight and a zero forget gate), so the carry-out stays exact.
// Products run on the CUDA cores in fp32; wgmma on the (L, D) x (D, 64)
// products is the later step.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int kChunk = 32;  // L: one key per lane
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kChunk / kWarps;  // rows of the chunk per warp

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
__host__ __device__ constexpr int tile_v() { return D < 64 ? D : 64; }

template <int D>
constexpr size_t smem_bytes() {
  constexpr int L = kChunk, TV = tile_v<D>();
  return sizeof(float) * ((size_t)D * TV + (size_t)L * D + (size_t)L * (D + 1) + (size_t)L * TV +
                          (size_t)L * (L + 1) + D + 5 * L + 2);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
mlstm_chunk_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const float* __restrict__ ig, const float* __restrict__ fg,
                   const float* __restrict__ C0, const float* __restrict__ n0,
                   const float* __restrict__ m0, T* __restrict__ out, float* __restrict__ Cout,
                   float* __restrict__ nout, float* __restrict__ mout, int S) {
  constexpr int L = kChunk, TV = tile_v<D>(), EV = TV / 32;
  extern __shared__ float smem[];
  float* Cs = smem;                // [D][TV]   C[dv0 + dv][dk] at Cs[dk * TV + dv]
  float* qs = Cs + D * TV;         // [L][D]
  float* ks = qs + L * D;          // [L][D + 1]
  float* vs = ks + L * (D + 1);    // [L][TV]
  float* Ps = vs + L * TV;         // [L][L + 1] decayed scores
  float* ns = Ps + L * (L + 1);    // [D]
  float* bsum = ns + D;            // [L] cumulative log forget gate
  float* gs = bsum + L;            // [L] log input gate
  float* inter = gs + L;           // [L] weight of the carried state per row
  float* denom = inter + L;        // [L] max(|n_j . q_j|, 1)
  float* kw = denom + L;           // [L] chunk-end key weights
  float* msh = kw + L;             // [2] m, carry scale

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int bh = blockIdx.y, dv0 = blockIdx.x * TV;
  const T* qb = q + (size_t)bh * S * D;
  const T* kb = k + (size_t)bh * S * D;
  const T* vb = v + (size_t)bh * S * D;
  const float* igb = ig + (size_t)bh * S;
  const float* fgb = fg + (size_t)bh * S;

  for (int idx = tid; idx < TV * D; idx += kThreads) {
    const int dv = idx / D, dk = idx % D;
    Cs[dk * TV + dv] = C0 ? C0[((size_t)bh * D + dv0 + dv) * D + dk] : 0.f;
  }
  for (int d = tid; d < D; d += kThreads) ns[d] = n0 ? n0[(size_t)bh * D + d] : 0.f;
  if (tid == 0) msh[0] = m0 ? m0[bh] : -INFINITY;

  for (int c0 = 0; c0 < S; c0 += L) {
    const int Lc = min(L, S - c0);
    __syncthreads();  // the previous chunk's carry update is complete
    for (int idx = tid; idx < L * D; idx += kThreads) {
      const int j = idx / D, d = idx % D;
      const bool in = j < Lc;
      qs[idx] = in ? to_f(qb[(size_t)(c0 + j) * D + d]) : 0.f;
      ks[j * (D + 1) + d] = in ? to_f(kb[(size_t)(c0 + j) * D + d]) : 0.f;
    }
    for (int idx = tid; idx < L * TV; idx += kThreads) {
      const int l = idx / TV, dv = idx % TV;
      vs[idx] = l < Lc ? to_f(vb[(size_t)(c0 + l) * D + dv0 + dv]) : 0.f;
    }
    if (warp == 0) {
      float b = lane < Lc ? fgb[c0 + lane] : 0.f;  // missing steps: no decay
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float y = __shfl_up_sync(0xffffffffu, b, o);
        if (lane >= o) b += y;
      }
      bsum[lane] = b;
      gs[lane] = lane < Lc ? igb[c0 + lane] : 0.f;
    }
    __syncthreads();
    const float m_prev = msh[0];
    const bool hist = m_prev != -INFINITY;

    // Scores s[r] = q_j . k_lane for this warp's rows j = warp + 8 r, and
    // n_prev . q_j.
    float s[kRows], nq[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r] = 0.f;
    const float* krow = ks + lane * (D + 1);
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float kd = krow[d];
#pragma unroll
      for (int r = 0; r < kRows; ++r) s[r] = fmaf(qs[(warp + kWarps * r) * D + d], kd, s[r]);
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float* qrow = qs + (warp + kWarps * r) * D;
      float part = 0.f;
      for (int d = lane; d < D; d += 32) part = fmaf(ns[d], qrow[d], part);
      nq[r] = warp_sum(part);
    }

    // Decays, stabiliser and the denominators, row by row.
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int j = warp + kWarps * r;
      const bool valid = lane <= j && j < Lc;
      const float wv = valid ? bsum[j] - bsum[lane] + gs[lane] : -INFINITY;
      const float m_intra = warp_max(wv);
      const float mj = hist ? fmaxf(m_intra, m_prev + bsum[j]) : m_intra;
      const float p = valid ? expf(wv - mj) * s[r] : 0.f;
      Ps[j * (L + 1) + lane] = p;
      const float inter_j = (hist && j < Lc) ? expf(m_prev + bsum[j] - mj) : 0.f;
      const float nqj = inter_j * nq[r] + warp_sum(p);
      if (lane == 0) {
        inter[j] = inter_j;
        denom[j] = fmaxf(fabsf(nqj), 1.f);
      }
    }
    __syncthreads();

    // h_j[dv] = (inter_j * (C_prev q_j)[dv] + sum_l P_jl v_l[dv]) / denom_j.
    {
      float acc[kRows][EV];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int e = 0; e < EV; ++e) acc[r][e] = 0.f;
#pragma unroll 4
      for (int dk = 0; dk < D; ++dk) {
        float cv[EV];
#pragma unroll
        for (int e = 0; e < EV; ++e) cv[e] = Cs[dk * TV + lane + 32 * e];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float qd = qs[(warp + kWarps * r) * D + dk];
#pragma unroll
          for (int e = 0; e < EV; ++e) acc[r][e] = fmaf(qd, cv[e], acc[r][e]);
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int e = 0; e < EV; ++e) acc[r][e] *= inter[warp + kWarps * r];
#pragma unroll 4
      for (int l = 0; l < L; ++l) {
        float vv[EV];
#pragma unroll
        for (int e = 0; e < EV; ++e) vv[e] = vs[l * TV + lane + 32 * e];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float p = Ps[(warp + kWarps * r) * (L + 1) + l];
#pragma unroll
          for (int e = 0; e < EV; ++e) acc[r][e] = fmaf(p, vv[e], acc[r][e]);
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int j = warp + kWarps * r;
        if (j >= Lc) continue;
        T* orow = out + ((size_t)bh * S + c0 + j) * D + dv0;
#pragma unroll
        for (int e = 0; e < EV; ++e) orow[lane + 32 * e] = from_f<T>(acc[r][e] / denom[j]);
      }
    }

    // Chunk-end stabiliser and key weights.
    if (warp == 0) {
      const float btot = bsum[Lc - 1];
      const bool valid = lane < Lc;
      const float wc = valid ? btot - bsum[lane] + gs[lane] : -INFINITY;
      const float mx = warp_max(wc);
      const float m_next = hist ? fmaxf(m_prev + btot, mx) : mx;
      kw[lane] = valid ? expf(wc - m_next) : 0.f;
      if (lane == 0) {
        msh[0] = m_next;
        msh[1] = hist ? expf(m_prev + btot - m_next) : 0.f;
      }
    }
    __syncthreads();  // C_prev and n_prev are read for the last time above

    // C[dv][dk] = cs * C[dv][dk] + sum_l (kw_l v_l[dv]) k_l[dk];  n likewise.
    const float cs = msh[1];
    float vr[L][EV];
#pragma unroll
    for (int l = 0; l < L; ++l)
#pragma unroll
      for (int e = 0; e < EV; ++e) vr[l][e] = vs[l * TV + lane + 32 * e] * kw[l];
    for (int dk = warp; dk < D; dk += kWarps) {
      float c[EV];
#pragma unroll
      for (int e = 0; e < EV; ++e) c[e] = cs * Cs[dk * TV + lane + 32 * e];
#pragma unroll
      for (int l = 0; l < L; ++l) {
        const float kk = ks[l * (D + 1) + dk];
#pragma unroll
        for (int e = 0; e < EV; ++e) c[e] = fmaf(vr[l][e], kk, c[e]);
      }
#pragma unroll
      for (int e = 0; e < EV; ++e) Cs[dk * TV + lane + 32 * e] = c[e];
    }
    for (int d = tid; d < D; d += kThreads) {
      float nn = cs * ns[d];
#pragma unroll 8
      for (int l = 0; l < L; ++l) nn = fmaf(kw[l], ks[l * (D + 1) + d], nn);
      ns[d] = nn;
    }
  }
  __syncthreads();

  for (int idx = tid; idx < TV * D; idx += kThreads) {
    const int dv = idx / D, dk = idx % D;
    Cout[((size_t)bh * D + dv0 + dv) * D + dk] = Cs[dk * TV + dv];
  }
  if (blockIdx.x == 0) {
    for (int d = tid; d < D; d += kThreads) nout[(size_t)bh * D + d] = ns[d];
    if (tid == 0) mout[bh] = msh[0];
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const float* ig, const float* fg,
                   const float* C0, const float* n0, const float* m0, void* out, float* Cout,
                   float* nout, float* mout, int BH, int S, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(mlstm_chunk_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(D / tile_v<D>(), BH), block(kThreads);
  mlstm_chunk_kernel<T, D><<<grid, block, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, ig, fg, C0, n0, m0, (T*)out, Cout, nout, mout, S);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int D, const void* q, const void* k, const void* v, const float* ig,
                     const float* fg, const float* C0, const float* n0, const float* m0, void* out,
                     float* Cout, float* nout, float* mout, int BH, int S, cudaStream_t stream) {
#define MLSTM_CASE(DD)                                                                          \
  case DD:                                                                                     \
    return launch<T, DD>(q, k, v, ig, fg, C0, n0, m0, out, Cout, nout, mout, BH, S, stream);
  switch (D) {
    MLSTM_CASE(32)
    MLSTM_CASE(64)
    MLSTM_CASE(128)
    MLSTM_CASE(256)
    MLSTM_CASE(384)
    default: return cudaErrorInvalidValue;
  }
#undef MLSTM_CASE
}

}  // namespace

// q, k, v, out: (B*H, S, D) of dtype (0 = float32, 1 = bfloat16); ig, fg:
// (B*H, S) fp32; C0/Cout (B*H, D, D) as C[v][k], n0/nout (B*H, D), m0/mout
// (B*H), all fp32.  C0, n0 and m0 may be null together (the empty history);
// the carry-out must not alias the carry-in.  Returns cudaGetLastError()
// after the launch (cudaErrorInvalidValue for a D or dtype it was not built
// for).
extern "C" int mlstm_chunkwise_launch(const void* q, const void* k, const void* v, const void* ig,
                                      const void* fg, const void* C0, const void* n0,
                                      const void* m0, void* out, void* Cout, void* nout, void* mout,
                                      int BH, int S, int D, int dtype, void* stream) {
  if (BH <= 0 || S <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float *igf = (const float*)ig, *fgf = (const float*)fg;
  const float *c0 = (const float*)C0, *n0f = (const float*)n0, *m0f = (const float*)m0;
  float *co = (float*)Cout, *no = (float*)nout, *mo = (float*)mout;
  if (dtype == 0)
    return (int)launch_d<float>(D, q, k, v, igf, fgf, c0, n0f, m0f, out, co, no, mo, BH, S, s);
  if (dtype == 1)
    return (int)launch_d<__nv_bfloat16>(D, q, k, v, igf, fgf, c0, n0f, m0f, out, co, no, mo, BH, S, s);
  return (int)cudaErrorInvalidValue;
}
