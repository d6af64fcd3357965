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
// that is about 20 GFLOP in fp32, 0.30 ms at 67 TFLOP/s on the CUDA cores,
// against 0.03 ms for its bytes.
//
// The design (fp32 on the CUDA cores, 256 threads, one block per SM):
//   * the fp32 carry C is D x D = 576 KB at D = 384, more than an SM's shared
//     memory (the TPU kernel holds it in VMEM scratch).  The value dimension
//     is split across blocks: block (value tile, b*h) owns C[tile][:] (TV x D
//     floats, kept as Cs[dk][dv]) in shared memory for the whole sequence,
//     and recomputes the chunk's (L, L) scores and n . q (so no block needs
//     another's n).  TV is a launch argument, chosen by
//     kernels/mlstm.py::plan_tile_v: 32 for D < 384; at D = 384, 32 or 48,
//     whichever fills the SMs in fewer, shorter waves (48 at B*H = 16: 128
//     blocks, one wave on 132 SMs; 32 below B*H = 12);
//   * every product runs from register micro-tiles, so an FMA rarely waits
//     on a shared-memory load.  q and k are kept row-major with rows padded
//     to D + 4 floats (16-byte rows that shift banks by 4 words), read as
//     float4 along d.  Lane bits: tc = lane % 8 picks columns, a warp spans
//     4 consecutive rows, so a row operand is a broadcast within the warp
//     and a column operand 128 contiguous bytes:
//       - the scores Q K^T (32 x 32) and C_prev q (32 x TV) share their q
//         loads: the D dimension is split over 4 thread groups (warps 2g,
//         2g + 1); a thread holds a 4 x 4 score tile (rows tr + 8 i, keys
//         tc + 8 i') and a 4 x TV/8 tile of C_prev q (columns 4 tc .. + 3,
//         then 32 + 2 tc at TV = 48: load_cols), 10 FMAs a load; the groups'
//         partials meet in a [4][L][TV] scratch;
//       - P V (K = L) is split the same way, 8 keys a group, on top of the
//         C_prev q partial scaled by the row's carry weight;
//       - the carry update C = cs C + (kw o V)^T K gives thread (tk, tc)
//         the rows dk = 4 tk + 128 e + {0..3} and the columns of tc: a
//         12 x 6 tile at D = 384, TV = 48, 14 FMAs a load;
//   * L = 32 and four barriers a chunk.  Warp 0 turns the gates into each
//     row's stabiliser m_j (a prefix max: b_j + max_{l<=j} (g_l - b_l)) and
//     carry weight, and the chunk end's key weights, so the decay step needs
//     one row sum a row.  Every load of a chunk is issued at once, 16 bytes a
//     thread, into registers; the gates and the previous chunk's h (the sum
//     of the groups' partials) are computed while they land, then the rows
//     go to shared memory (no copy-ahead: a chunk's loads start after the
//     previous chunk's products).  The ragged last chunk is masked in the
//     kernel (missing steps have no weight and a zero forget gate), so the
//     carry-out stays exact.
// What bounds it now (H100 80GB HBM3, 700 W, B = H = 4, S = 2048, D = 384,
// fp32, about 3.4x its operation bound): the chunk loads (each of a head's
// D / TV blocks reads the whole chunk of q and k) and the products'
// load-to-use latency with two warps a scheduler.  Next steps: share the
// scores and the q, k loads of a head's blocks through a cluster, copy the
// next chunk ahead, and the tensor cores.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

namespace {

constexpr int kChunk = 32;  // L
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kGroups = 4;  // the D split of the two D-long products
constexpr int kRows = kChunk / kWarps;  // rows of the chunk per warp in the decay step

__device__ __forceinline__ float bf16_lo(unsigned w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(unsigned w) { return __uint_as_float(w & 0xffff0000u); }

__device__ __forceinline__ float comp(const float4& a, int x) {
  return x == 0 ? a.x : x == 1 ? a.y : x == 2 ? a.z : a.w;
}

template <int D, int TV>
constexpr size_t smem_bytes() {
  constexpr size_t L = kChunk;
  return sizeof(float) * (D * TV              // Cs [D][TV]
                          + 2 * L * (D + 4)   // qs, ks [L][D + 4]
                          + 2 * L * TV        // vs, vws [L][TV]
                          + kGroups * L * TV  // partial products [4][L][TV] (scores [4][L][L])
                          + L * (L + 4)       // Ps [L][L + 4]
                          + D + 6 * L + 4);   // ns; bsum, gs, mrow, inter, denom, kw; m
}

// A thread's TV / 8 columns of a row of TV floats: 4 tc .. 4 tc + 3, then (TV
// = 48) 32 + 2 tc, + 1 — one or two vector accesses, and eight threads tc =
// 0..7 cover the row.
template <int TV>
__device__ __forceinline__ void load_cols(const float* row, int tc, float (&x)[TV / 8]) {
  static_assert(TV == 32 || TV == 48, "value tile of 32 or 48");
  const float4 a = *reinterpret_cast<const float4*>(row + 4 * tc);
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  if constexpr (TV == 48) {
    const float2 b = *reinterpret_cast<const float2*>(row + 32 + 2 * tc);
    x[4] = b.x; x[5] = b.y;
  }
}

template <int TV>
__device__ __forceinline__ void store_cols(float* row, int tc, const float (&x)[TV / 8]) {
  *reinterpret_cast<float4*>(row + 4 * tc) = make_float4(x[0], x[1], x[2], x[3]);
  if constexpr (TV == 48)
    *reinterpret_cast<float2*>(row + 32 + 2 * tc) = make_float2(x[4], x[5]);
}

// The chunk's rows [0, L) x W columns of a slab with row stride D: load()
// issues every 16-byte load of this thread at once into registers (rows from
// Lc on are zero), store() writes them to dst [L][ld] as fp32.
template <typename T, int D, int W>
struct ChunkRows {
  static constexpr int V = 16 / sizeof(T), PER_ROW = W / V, TOTAL = kChunk * PER_ROW;
  static constexpr int N = (TOTAL + kThreads - 1) / kThreads;
  static_assert(W % V == 0, "rows of whole 16-byte vectors");
  uint4 raw[N];

  __device__ __forceinline__ void load(const T* __restrict__ src, int Lc, int tid) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int idx = tid + i * kThreads, j = idx / PER_ROW, c = (idx % PER_ROW) * V;
      raw[i] = (idx < TOTAL && j < Lc) ? *reinterpret_cast<const uint4*>(src + (size_t)j * D + c)
                                      : make_uint4(0u, 0u, 0u, 0u);
    }
  }

  __device__ __forceinline__ void store(float* dst, int ld, int tid) const {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int idx = tid + i * kThreads, j = idx / PER_ROW, c = (idx % PER_ROW) * V;
      if (idx >= TOTAL) break;
      float* d = dst + j * ld + c;
      const uint4 w = raw[i];
      if constexpr (sizeof(T) == 4) {
        *reinterpret_cast<float4*>(d) = make_float4(__uint_as_float(w.x), __uint_as_float(w.y),
                                                    __uint_as_float(w.z), __uint_as_float(w.w));
      } else {  // bf16 pairs: the low half is the first element; a bf16 is a float's top 16 bits
        *reinterpret_cast<float4*>(d) = make_float4(bf16_lo(w.x), bf16_hi(w.x), bf16_lo(w.y), bf16_hi(w.y));
        *reinterpret_cast<float4*>(d + 4) = make_float4(bf16_lo(w.z), bf16_hi(w.z), bf16_lo(w.w), bf16_hi(w.w));
      }
    }
  }
};

__device__ __forceinline__ void store4(float* dst, float4 x) { *reinterpret_cast<float4*>(dst) = x; }
__device__ __forceinline__ void store4(__nv_bfloat16* dst, float4 x) {
  __nv_bfloat162* d = reinterpret_cast<__nv_bfloat162*>(dst);
  d[0] = __floats2bfloat162_rn(x.x, x.y);
  d[1] = __floats2bfloat162_rn(x.z, x.w);
}

template <typename T, int D, int TV>
__global__ void __launch_bounds__(kThreads, 1)
mlstm_chunk_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const float* __restrict__ ig, const float* __restrict__ fg,
                   const float* __restrict__ C0, const float* __restrict__ n0,
                   const float* __restrict__ m0, T* __restrict__ out, float* __restrict__ Cout,
                   float* __restrict__ nout, float* __restrict__ mout, int S) {
  constexpr int L = kChunk, DP = D + 4, LP = L + 4, NC = TV / 8, DG = D / kGroups;
  constexpr int RV = D < 128 ? D / 32 : 4, E = D / (32 * RV);  // carry-update rows: E vectors of RV
  static_assert(DG % 4 == 0, "a group's quarter of D in float4 steps");
  extern __shared__ __align__(16) float smem[];
  float* Cs = smem;                   // [D][TV]   C[dv0 + dv][dk] at Cs[dk * TV + dv]
  float* qs = Cs + D * TV;            // [L][DP]
  float* ks = qs + L * DP;            // [L][DP]
  float* vs = ks + L * DP;            // [L][TV]
  float* vws = vs + L * TV;           // [L][TV]   v scaled by the chunk-end key weights
  float* part = vws + L * TV;         // [4][L][TV] the groups' partials ([4][L][L] for the scores)
  float* Ps = part + kGroups * L * TV;  // [L][LP]  decayed scores
  float* ns = Ps + L * LP;            // [D]
  float* bsum = ns + D;               // [L] cumulative log forget gate
  float* gs = bsum + L;               // [L] log input gate
  float* mrow = gs + L;               // [L] stabiliser m_j per row
  float* inter = mrow + L;            // [L] weight of the carried state per row
  float* denom = inter + L;           // [L] max(|n_j . q_j|, 1)
  float* kw = denom + L;              // [L] chunk-end key weights
  float* msh = kw + L;                // [3] m, carry scale, next m

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int tc = lane % 8;                           // columns (keys, value columns)
  const int grp = warp / 2, tr = (warp % 2) * 4 + lane / 8;  // D quarter; rows tr + 8 i
  const int tk = warp * 4 + lane / 8;                // carry-update rows
  const int bh = blockIdx.y, dv0 = blockIdx.x * TV;
  const T* qb = q + (size_t)bh * S * D;
  const T* kb = k + (size_t)bh * S * D;
  const T* vb = v + (size_t)bh * S * D + dv0;
  const float* igb = ig + (size_t)bh * S;
  const float* fgb = fg + (size_t)bh * S;

  for (int idx = tid; idx < TV * D; idx += kThreads) {
    const int dv = idx / D, dk = idx % D;
    Cs[dk * TV + dv] = C0 ? C0[((size_t)bh * D + dv0 + dv) * D + dk] : 0.f;
  }
  for (int d = tid; d < D; d += kThreads) ns[d] = n0 ? n0[(size_t)bh * D + d] : 0.f;
  if (tid == 0) msh[0] = m0 ? m0[bh] : -INFINITY;
  __syncthreads();

  // h_j = (sum of the groups' partials) / denom_j for the chunk at c0h.
  auto write_h = [&](int c0h, int Lch) {
    for (int idx = tid; idx < L * TV / 4; idx += kThreads) {
      const int j = idx / (TV / 4), c = 4 * (idx % (TV / 4));
      if (j >= Lch) continue;
      float4 h = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        const float4 a = *reinterpret_cast<const float4*>(part + (g * L + j) * TV + c);
        h.x += a.x; h.y += a.y; h.z += a.z; h.w += a.w;
      }
      const float dn = denom[j];
      store4(out + ((size_t)bh * S + c0h + j) * D + dv0 + c,
             make_float4(h.x / dn, h.y / dn, h.z / dn, h.w / dn));
    }
  };

  for (int c0 = 0; c0 < S; c0 += L) {
    const int Lc = min(L, S - c0);
    // No barrier here: since the last one nothing reads q, k or v.  Every
    // load of the chunk is issued first (warp 0's gates before q, k and v);
    // the gates and the previous chunk's h (from part and denom, which this
    // chunk rewrites only after the next barrier) are computed while they land.
    const float f_in = (warp == 0 && lane < Lc) ? fgb[c0 + lane] : 0.f;  // missing steps: no decay
    const float g_in = (warp == 0 && lane < Lc) ? igb[c0 + lane] : 0.f;
    ChunkRows<T, D, D> rq, rk;
    ChunkRows<T, D, TV> rv;
    rq.load(qb + (size_t)c0 * D, Lc, tid);
    rk.load(kb + (size_t)c0 * D, Lc, tid);
    rv.load(vb + (size_t)c0 * D, Lc, tid);
    if (warp == 0) {  // gates; each row's stabiliser and carry weight; the chunk-end ones
      float b = f_in;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float y = __shfl_up_sync(0xffffffffu, b, o);
        if (lane >= o) b += y;
      }
      bsum[lane] = b;
      gs[lane] = g_in;
      const float m_prev = msh[0], btot = __shfl_sync(0xffffffffu, b, Lc - 1);
      const bool hist = m_prev != -INFINITY, valid = lane < Lc;
      // m_j = max(max_{l <= j} (b_j - b_l + g_l), m_prev + b_j): a prefix max of g_l - b_l.
      // The chunk end's max_l (b_last - b_l + g_l) in the same pass.
      float u = valid ? g_in - b : -INFINITY;
      const float wc = valid ? btot - b + g_in : -INFINITY;
      float mx = wc;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float y = __shfl_up_sync(0xffffffffu, u, o);
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        if (lane >= o) u = fmaxf(u, y);
      }
      const float m_intra = valid ? b + u : -INFINITY;
      const float mj = hist ? fmaxf(m_intra, m_prev + b) : m_intra;
      mrow[lane] = mj;
      inter[lane] = (hist && valid) ? expf(m_prev + b - mj) : 0.f;
      const float m_next = hist ? fmaxf(m_prev + btot, mx) : mx;
      kw[lane] = valid ? expf(wc - m_next) : 0.f;
      if (lane == 0) {
        msh[1] = hist ? expf(m_prev + btot - m_next) : 0.f;
        msh[2] = m_next;
      }
    }
    if (c0 > 0) write_h(c0 - L, L);  // only the last chunk is ragged
    rq.store(qs, DP, tid);
    rk.store(ks, DP, tid);
    rv.store(vs, TV, tid);
    __syncthreads();

    // This group's quarter of D: the scores q_j . k_l (rows tr + 8 i, keys
    // tc + 8 i') and C_prev q_j on the thread's columns, from one q load.
    float acc[4][NC];
    {
      float s[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int n = 0; n < 4; ++n) s[i][n] = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int n = 0; n < NC; ++n) acc[i][n] = 0.f;
      const int d0 = grp * DG;
#pragma unroll 4
      for (int d = d0; d < d0 + DG; d += 4) {
        float4 qa[4], ka[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) qa[i] = *reinterpret_cast<const float4*>(qs + (tr + 8 * i) * DP + d);
#pragma unroll
        for (int i = 0; i < 4; ++i) ka[i] = *reinterpret_cast<const float4*>(ks + (tc + 8 * i) * DP + d);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            s[i][n] = fmaf(qa[i].x, ka[n].x, s[i][n]);
            s[i][n] = fmaf(qa[i].y, ka[n].y, s[i][n]);
            s[i][n] = fmaf(qa[i].z, ka[n].z, s[i][n]);
            s[i][n] = fmaf(qa[i].w, ka[n].w, s[i][n]);
          }
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          float cv[NC];
          load_cols<TV>(Cs + (d + x) * TV, tc, cv);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float qx = comp(qa[i], x);
#pragma unroll
            for (int n = 0; n < NC; ++n) acc[i][n] = fmaf(qx, cv[n], acc[i][n]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int n = 0; n < 4; ++n) part[(grp * L + tr + 8 * i) * L + tc + 8 * n] = s[i][n];
    }
    __syncthreads();

    // Decayed scores and the denominators: this warp's rows j = warp + 8 r
    // (lane = key), their row sums reduced together.
    {
      float p[kRows], nq[kRows];  // P_jl, then sum_l P_jl; n_prev . q_j
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int j = warp + kWarps * r;
        float sc = 0.f;
#pragma unroll
        for (int g = 0; g < kGroups; ++g) sc += part[(g * L + j) * L + lane];
        nq[r] = 0.f;
#pragma unroll
        for (int t = 0; t < (D + 127) / 128; ++t) {
          const int d = 4 * lane + 128 * t;
          if (d < D) {
            const float4 a = *reinterpret_cast<const float4*>(ns + d);
            const float4 b = *reinterpret_cast<const float4*>(qs + j * DP + d);
            nq[r] = fmaf(a.x, b.x, fmaf(a.y, b.y, fmaf(a.z, b.z, fmaf(a.w, b.w, nq[r]))));
          }
        }
        const bool valid = lane <= j && j < Lc;
        p[r] = valid ? expf(bsum[j] - bsum[lane] + gs[lane] - mrow[j]) * sc : 0.f;
        Ps[j * LP + lane] = p[r];
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          nq[r] += __shfl_xor_sync(0xffffffffu, nq[r], o);
          p[r] += __shfl_xor_sync(0xffffffffu, p[r], o);
        }
      if (lane == 0)
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const int j = warp + kWarps * r;
          denom[j] = fmaxf(fabsf(inter[j] * nq[r] + p[r]), 1.f);
        }
    }
    for (int idx = tid; idx < L * TV / 4; idx += kThreads) {
      const float4 x = reinterpret_cast<const float4*>(vs)[idx];
      const float w = kw[idx / (TV / 4)];
      reinterpret_cast<float4*>(vws)[idx] = make_float4(x.x * w, x.y * w, x.z * w, x.w * w);
    }
    __syncthreads();

    // inter_j * (C_prev q_j) + sum_l P_jl v_l, this group's part: its quarter
    // of D for the first term, its 8 keys for the second.
    {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float w = inter[tr + 8 * i];
#pragma unroll
        for (int n = 0; n < NC; ++n) acc[i][n] *= w;
      }
#pragma unroll
      for (int l = grp * 8; l < grp * 8 + 8; l += 4) {
        float4 pa[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) pa[i] = *reinterpret_cast<const float4*>(Ps + (tr + 8 * i) * LP + l);
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          float vv[NC];
          load_cols<TV>(vs + (l + x) * TV, tc, vv);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float px = comp(pa[i], x);
#pragma unroll
            for (int n = 0; n < NC; ++n) acc[i][n] = fmaf(px, vv[n], acc[i][n]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) store_cols<TV>(part + (grp * L + tr + 8 * i) * TV, tc, acc[i]);
    }

    // C[dv][dk] = cs * C[dv][dk] + sum_l (kw_l v_l[dv]) k_l[dk]: thread (tk,
    // tc) owns the rows dk = RV tk + 32 RV e + x and the columns of tc.
    const float cs = msh[1];
    {
      float c[E * RV][NC];
#pragma unroll
      for (int e = 0; e < E; ++e)
#pragma unroll
        for (int x = 0; x < RV; ++x) {
          load_cols<TV>(Cs + (RV * tk + 32 * RV * e + x) * TV, tc, c[e * RV + x]);
#pragma unroll
          for (int n = 0; n < NC; ++n) c[e * RV + x][n] *= cs;
        }
#pragma unroll 4
      for (int l = 0; l < L; ++l) {
        float vw[NC];
        load_cols<TV>(vws + l * TV, tc, vw);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float* kr = ks + l * DP + RV * tk + 32 * RV * e;
          float kk[RV];
          if constexpr (RV == 4) {
            const float4 a = *reinterpret_cast<const float4*>(kr);
            kk[0] = a.x; kk[1] = a.y; kk[2] = a.z; kk[3] = a.w;
          } else if constexpr (RV == 2) {
            const float2 a = *reinterpret_cast<const float2*>(kr);
            kk[0] = a.x; kk[1] = a.y;
          } else {
            kk[0] = kr[0];
          }
#pragma unroll
          for (int x = 0; x < RV; ++x)
#pragma unroll
            for (int n = 0; n < NC; ++n) c[e * RV + x][n] = fmaf(kk[x], vw[n], c[e * RV + x][n]);
        }
      }
#pragma unroll
      for (int e = 0; e < E; ++e)
#pragma unroll
        for (int x = 0; x < RV; ++x) store_cols<TV>(Cs + (RV * tk + 32 * RV * e + x) * TV, tc, c[e * RV + x]);
    }
    for (int d = tid; d < D; d += kThreads) {
      float nn = cs * ns[d];
#pragma unroll 8
      for (int l = 0; l < L; ++l) nn = fmaf(kw[l], ks[l * DP + d], nn);
      ns[d] = nn;
    }
    if (tid == 0) msh[0] = msh[2];
    __syncthreads();

  }
  const int c_last = (S - 1) / L * L;
  write_h(c_last, S - c_last);

  for (int idx = tid; idx < TV * D; idx += kThreads) {
    const int dv = idx / D, dk = idx % D;
    Cout[((size_t)bh * D + dv0 + dv) * D + dk] = Cs[dk * TV + dv];
  }
  if (blockIdx.x == 0) {
    for (int d = tid; d < D; d += kThreads) nout[(size_t)bh * D + d] = ns[d];
    if (tid == 0) mout[bh] = msh[0];
  }
}

template <typename T, int D, int TV>
cudaError_t launch(const void* q, const void* k, const void* v, const float* ig, const float* fg,
                   const float* C0, const float* n0, const float* m0, void* out, float* Cout,
                   float* nout, float* mout, int BH, int S, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D, TV>();
  static_assert(smem <= 232448, "shared memory of one block");
  cudaError_t err = cudaFuncSetAttribute(mlstm_chunk_kernel<T, D, TV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(D / TV, BH), block(kThreads);
  mlstm_chunk_kernel<T, D, TV><<<grid, block, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, ig, fg, C0, n0, m0, (T*)out, Cout, nout, mout, S);
  return cudaGetLastError();
}

// The (D, TV) pairs built (kernels/mlstm.py::TILE_VS mirrors this list).
template <typename T>
cudaError_t launch_d(int D, int TV, const void* q, const void* k, const void* v, const float* ig,
                     const float* fg, const float* C0, const float* n0, const float* m0, void* out,
                     float* Cout, float* nout, float* mout, int BH, int S, cudaStream_t stream) {
#define MLSTM_CASE(DD, TT)                                                                      \
  if (D == DD && TV == TT)                                                                     \
    return launch<T, DD, TT>(q, k, v, ig, fg, C0, n0, m0, out, Cout, nout, mout, BH, S, stream);
  MLSTM_CASE(32, 32)
  MLSTM_CASE(64, 32)
  MLSTM_CASE(128, 32)
  MLSTM_CASE(256, 32)
  MLSTM_CASE(384, 32)
  MLSTM_CASE(384, 48)
#undef MLSTM_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

// q, k, v, out: (B*H, S, D) of dtype (0 = float32, 1 = bfloat16), 16-byte
// aligned; ig, fg: (B*H, S) fp32; C0/Cout (B*H, D, D) as C[v][k], n0/nout
// (B*H, D), m0/mout (B*H), all fp32.  C0, n0 and m0 may be null together (the
// empty history); the carry-out must not alias the carry-in.  TV is the value
// tile of a block (grid D / TV x B*H).  Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for a (D, TV) or dtype it was not built for).
extern "C" int mlstm_chunkwise_launch(const void* q, const void* k, const void* v, const void* ig,
                                      const void* fg, const void* C0, const void* n0,
                                      const void* m0, void* out, void* Cout, void* nout, void* mout,
                                      int BH, int S, int D, int TV, int dtype, void* stream) {
  if (BH <= 0 || S <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const float *igf = (const float*)ig, *fgf = (const float*)fg;
  const float *c0 = (const float*)C0, *n0f = (const float*)n0, *m0f = (const float*)m0;
  float *co = (float*)Cout, *no = (float*)nout, *mo = (float*)mout;
  if (dtype == 0)
    return (int)launch_d<float>(D, TV, q, k, v, igf, fgf, c0, n0f, m0f, out, co, no, mo, BH, S, s);
  if (dtype == 1)
    return (int)launch_d<__nv_bfloat16>(D, TV, q, k, v, igf, fgf, c0, n0f, m0f, out, co, no, mo, BH, S, s);
  return (int)cudaErrorInvalidValue;
}
