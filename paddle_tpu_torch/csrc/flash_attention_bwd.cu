// Flash-attention backward for Hopper (sm_90a): two kernels, dq and dk/dv,
// bound through plain C functions loaded with ctypes (see
// paddle_tpu_torch/ops/flash_attention.py).
//
// Replaces the TPU kernels paddle_tpu/ops/pallas_attention.py:
//   _fa_bwd_dq_kernel   -> fa_bwd_dq_mma_kernel (bf16), fa_bwd_dq_kernel (f32)
//   _fa_bwd_dkv_kernel  -> fa_bwd_dkv_mma_kernel (bf16), fa_bwd_dkv_kernel (f32)
// (both launched by _flash_bwd).  They compute the same functions, with the
// masks of the forward (keys at or past lengths[b] masked, an optional
// causal mask, scale = 1/sqrt(dh)):
//   p  = where(mask, exp(s - lse), 0),   s = q k^T * scale
//   dp = dO v^T,   ds = p * (dp - delta) * scale,   delta = rowsum(dO * O)
//   dq = ds k,     dk = ds^T q,          dv = p^T dO
// lse comes from the forward kernel and delta is computed outside the
// kernels, both [B, H, T] f32.  Scores, p, dp, ds and the accumulators are
// f32; as in the TPU kernels (pallas_attention.py:162, 199, 208), the bf16
// kernels round p and ds to bf16 before the products dv = p^T dO, dq = ds k
// and dk = ds^T q, and each gradient rounds once on store.
//
// Bound on this card: per (query, key, head) the masks keep, dq does 6*dh
// operations (recomputed s, dp, dq) and one exp, dk/dv 8*dh (s, dp, dv, dk)
// and one exp, over ~O(B*T*H*dh) bytes: at Transformer-base shapes
// (T = 1024, dh = 64) far above the H100's ridge point, so both kernels are
// bounded by operations (989 TFLOP/s bf16 on the tensor cores; the exps,
// at the SFU's ~4e12/s, cost about as much as the products at dh = 64).
// The bf16 kernels therefore run every product on the tensor cores
// (mma.sync m16n8k16, flash_mma.cuh) and keep P and dS in registers.
//
// Design:
//   * dq, bf16: fa_bwd_dq_mma_kernel.  One block of DQ_WARPS = 8 warps (128
//     query rows) per (q tile, head, batch), over DQ_KEYS = 64-key tiles.
//     The shape was timed on the H100 at dh = 64 only, where 8 warps beat 4
//     on the main path's mix of two non-causal layers per causal one and
//     32-key tiles and 2 warps were slower (126 registers, no spills); it
//     is applied to every head dim untimed, and ptxas shows 8 B of spill
//     stores at dh 33-48 and 223 registers (one block per SM) at dh 128.
//     Each warp owns 16 rows, holds
//     their Q and dO as ldmatrix A fragments and their lse and delta in
//     registers for the whole block.  64-key tiles of K and V are
//     double-buffered in shared memory with cp.async (tile j+1 loads while
//     tile j computes; one __syncthreads per tile), and the loop ends at the
//     causal diagonal and at the last tile that holds a valid key.  Per 16
//     keys: S = Q K^T and dP = dO V^T into f32 accumulators, dS = P (dP -
//     delta) scale from the f32 P (no online softmax: lse is known), and
//     dQ += dS K with dS passed as a bf16 A fragment (never through shared
//     memory) and K through ldmatrix.trans, so one shared K tile serves as
//     the B operand of S and of dQ.  A warp whose rows see no masked key in
//     a tile skips the mask arithmetic, and one whose rows all precede the
//     tile's keys (causal) skips the tile.  dQ is staged through the warp's
//     own rows of the Q tile and stored in 16-byte rows; each block owns its
//     rows (no atomics: deterministic), and a block that runs no tile writes
//     zeros.  dq is not fused into the dk/dv kernel: that would need f32
//     atomics into a scratch, and give up determinism.
//   * dq, f32: fa_bwd_dq_kernel, one block of 256 threads per (q-tile of 64
//     rows, head, batch); a loop over 64-key tiles of K and V staged in
//     shared memory, stopping where the bf16 kernel does; products by
//     scalar FMA with a 4x4 (resp. 4 x dh/16) register tile per thread: the
//     parity dtype, whose bars TF32 products would break.
//   * dk/dv, bf16: fa_bwd_dkv_mma_kernel, on the tensor cores
//     (flash_mma.cuh).  One block of DKV_WARPS = 4 warps (64 keys) per
//     (key tile, head, batch), over q tiles of DKV_BMQ = 32 queries (135
//     registers, no spills at dh = 64; 64-query tiles fit no better than 174
//     registers or spill at 168, and were slower without spills; 8 warps
//     were slower too).  Each warp owns 16 keys, so
//     every product of a q tile stays in that warp's registers:
//       S^T = K Q^T,  P^T = exp(S^T scale - lse),  dV += P^T dO,
//       dP^T = V dO^T,  dS^T = P^T (dP^T - delta) scale,  dK += dS^T Q
//     (in that order, the last three 32 queries at a time, so the f32 P^T
//     tile, half of dP^T and the two accumulators are the most that is live:
//     no spills at dh = 64),
//     with P^T and dS^T passed from their f32 accumulators to the next
//     product as bf16 A fragments (never through shared memory).  K and V
//     stay in shared memory for the whole block; Q, dO, lse and delta of
//     the next q tile load with cp.async while this one computes (one
//     __syncthreads per tile).  The loop starts at the diagonal when causal.
//     The head dim is zero-padded to a multiple of 16 in shared memory.
//   * dk/dv, f32: fa_bwd_dkv_kernel, one block of 256 threads per (64-key
//     tile, head, batch), Q, dO, P and dS staged in shared memory as f32,
//     scalar FMA: the parity dtype, whose bars TF32 products would break.
//   * Both dk/dv kernels: a key tile wholly at or past lengths[b] runs no q
//     tile and writes zeros (the outputs come from torch.empty); no atomics,
//     each block owns its outputs, so the result is deterministic.
//   * q, k, v and dO are read through their batch and token strides (the
//     fused QKV projection's column slices need no copy); dq, dk and dv are
//     written dense [B, T, H, dh].

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "flash_mma.cuh"

namespace {

constexpr int DQ_WARPS = 8;   // warps (16 query rows each) per block of the bf16 dq kernel
constexpr int DQ_KEYS = 64;   // keys per tile of the bf16 dq kernel
constexpr int DKV_WARPS = 4;  // warps (16 keys each) per block of the bf16 dk/dv kernel
constexpr int DKV_BMQ = 32;   // query rows per tile (a multiple of 32) of the bf16 dk/dv kernel
constexpr int BM = 64;        // query rows per tile
constexpr int BN = 64;        // keys per tile
constexpr int NTHREADS = 256;
constexpr int DMAX = 128;     // largest head dim

// rows [r0, r0 + 64) of one head of x (token stride st) into s[64][ld];
// rows at or past t_len read as 0
__device__ __forceinline__ void stage_rows(float* s, const float* x, long long st,
                                           int r0, int t_len, int dh, int ld) {
  for (int idx = threadIdx.x; idx < BM * dh; idx += NTHREADS) {
    const int r = idx / dh, d = idx - r * dh;
    const int p = r0 + r;
    s[r * ld + d] = p < t_len ? x[p * st + d] : 0.f;
  }
}

// lse and delta of rows [q0, q0 + 64) of one (batch, head) row of [B, H, T]
__device__ __forceinline__ void stage_stats(float* lse_s, float* delta_s,
                                            const float* lse_bh,
                                            const float* delta_bh, int q0,
                                            int t_len) {
  if (threadIdx.x < BM) {
    const int qp = q0 + threadIdx.x;
    lse_s[threadIdx.x] = qp < t_len ? lse_bh[qp] : 0.f;
    delta_s[threadIdx.x] = qp < t_len ? delta_bh[qp] : 0.f;
  }
}

__global__ void __launch_bounds__(NTHREADS)
fa_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 const int* __restrict__ lengths, float* __restrict__ dq,
                 int t_len, int n_heads, int dh, long long qsb, long long qst,
                 long long ksb, long long kst, long long vsb, long long vst,
                 long long dsb, long long dst, int causal, float scale) {
  extern __shared__ float smem[];
  const int ld = dh + 1;  // padded row stride: no bank conflicts on rows
  float* qs = smem;                    // [BM][ld]
  float* dos = qs + BM * ld;           // [BM][ld]
  float* ks = dos + BM * ld;           // [BN][ld]
  float* vs = ks + BN * ld;            // [BN][ld]
  float* dss = vs + BN * ld;           // [BM][BN + 1]
  float* lse_s = dss + BM * (BN + 1);  // [BM]
  float* delta_s = lse_s + BM;         // [BM]

  const int q0 = blockIdx.x * BM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int valid_len = min(max(lengths[b], 0), t_len);
  const long long bh = ((long long)b * n_heads + h) * t_len;

  const float* kb = k + b * ksb + (long long)h * dh;
  const float* vb = v + b * vsb + (long long)h * dh;
  stage_rows(qs, q + b * qsb + (long long)h * dh, qst, q0, t_len, dh, ld);
  stage_rows(dos, dout + b * dsb + (long long)h * dh, dst, q0, t_len, dh, ld);
  stage_stats(lse_s, delta_s, lse + bh, delta + bh, q0, t_len);

  // tile mapping: rows ty + 16 i, keys (or head-dim columns) tx + 16 j
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  float acc[4][DMAX / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DMAX / 16; ++c) acc[i][c] = 0.f;

  int n_tiles = (t_len + BN - 1) / BN;
  if (causal) n_tiles = min(n_tiles, (min(q0 + BM, t_len) + BN - 1) / BN);
  n_tiles = min(n_tiles, (valid_len + BN - 1) / BN);

  for (int jt = 0; jt < n_tiles; ++jt) {
    const int k0 = jt * BN;
    __syncthreads();  // previous tile's K, V and dS are consumed
    stage_rows(ks, kb, kst, k0, t_len, dh, ld);
    stage_rows(vs, vb, vst, k0, t_len, dh, ld);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int d = 0; d < dh; ++d) {
      float qv[4], ov[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = qs[(ty + 16 * i) * ld + d];
        ov[i] = dos[(ty + 16 * i) * ld + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = ks[(tx + 16 * j) * ld + d];
        vv[j] = vs[(tx + 16 * j) * ld + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int qp = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        const bool ok = kp < valid_len && qp < t_len && (!causal || kp <= qp);
        const float p = ok ? expf(s[i][j] * scale - lse_s[r]) : 0.f;
        dss[r * (BN + 1) + tx + 16 * j] = p * (dp[i][j] - delta_s[r]) * scale;
      }
    }
    __syncthreads();

    for (int kk = 0; kk < BN; ++kk) {
      float dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = dss[(ty + 16 * i) * (BN + 1) + kk];
#pragma unroll
      for (int c = 0; c < DMAX / 16; ++c) {
        const int col = tx + 16 * c;
        if (col < dh) {
          const float kv = ks[kk * ld + col];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(dsv[i], kv, acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty + 16 * i;
    if (qp >= t_len) continue;
    float* row = dq + (((long long)b * t_len + qp) * n_heads + h) * dh;
#pragma unroll
    for (int c = 0; c < DMAX / 16; ++c) {
      const int col = tx + 16 * c;
      if (col < dh) row[col] = acc[i][c];
    }
  }
}

__global__ void __launch_bounds__(NTHREADS)
fa_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta,
                  const int* __restrict__ lengths, float* __restrict__ dk,
                  float* __restrict__ dv, int t_len, int n_heads, int dh,
                  long long qsb, long long qst, long long ksb, long long kst,
                  long long vsb, long long vst, long long dsb, long long dst,
                  int causal, float scale) {
  extern __shared__ float smem[];
  const int ld = dh + 1;
  float* ks = smem;                    // [BN][ld]
  float* vs = ks + BN * ld;            // [BN][ld]
  float* qs = vs + BN * ld;            // [BM][ld]
  float* dos = qs + BM * ld;           // [BM][ld]
  float* ps = dos + BM * ld;           // [BM][BN + 1]
  float* dss = ps + BM * (BN + 1);     // [BM][BN + 1]
  float* lse_s = dss + BM * (BN + 1);  // [BM]
  float* delta_s = lse_s + BM;         // [BM]

  const int k0 = blockIdx.x * BN;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int valid_len = min(max(lengths[b], 0), t_len);
  const long long bh = ((long long)b * n_heads + h) * t_len;

  const float* qb = q + b * qsb + (long long)h * dh;
  const float* ob = dout + b * dsb + (long long)h * dh;
  stage_rows(ks, k + b * ksb + (long long)h * dh, kst, k0, t_len, dh, ld);
  stage_rows(vs, v + b * vsb + (long long)h * dh, vst, k0, t_len, dh, ld);

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;

  // accumulators: keys ty + 16 i, head-dim columns tx + 16 c
  float acc_k[4][DMAX / 16], acc_v[4][DMAX / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DMAX / 16; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

  const int n_q = (t_len + BM - 1) / BM;
  // causal: q-tiles wholly before this key tile see none of its keys; a key
  // tile wholly at or past the length is masked for every query
  const int first = k0 >= valid_len ? n_q : (causal ? k0 / BM : 0);

  for (int it = first; it < n_q; ++it) {
    const int q0 = it * BM;
    __syncthreads();  // previous tile's Q, dO, P and dS are consumed
    stage_rows(qs, qb, qst, q0, t_len, dh, ld);
    stage_rows(dos, ob, dst, q0, t_len, dh, ld);
    stage_stats(lse_s, delta_s, lse + bh, delta + bh, q0, t_len);
    __syncthreads();

    // s and dp for query rows ty + 16 i and keys tx + 16 j
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int d = 0; d < dh; ++d) {
      float qv[4], ov[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = qs[(ty + 16 * i) * ld + d];
        ov[i] = dos[(ty + 16 * i) * ld + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = ks[(tx + 16 * j) * ld + d];
        vv[j] = vs[(tx + 16 * j) * ld + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int qp = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        const bool ok = kp < valid_len && qp < t_len && (!causal || kp <= qp);
        const float p = ok ? expf(s[i][j] * scale - lse_s[r]) : 0.f;
        ps[r * (BN + 1) + tx + 16 * j] = p;
        dss[r * (BN + 1) + tx + 16 * j] = p * (dp[i][j] - delta_s[r]) * scale;
      }
    }
    __syncthreads();

    // dv += P^T dO, dk += dS^T Q over this tile's query rows
    for (int qq = 0; qq < BM; ++qq) {
      float pv[4], dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = ps[qq * (BN + 1) + ty + 16 * i];
        dsv[i] = dss[qq * (BN + 1) + ty + 16 * i];
      }
#pragma unroll
      for (int c = 0; c < DMAX / 16; ++c) {
        const int col = tx + 16 * c;
        if (col < dh) {
          const float ov = dos[qq * ld + col];
          const float qv = qs[qq * ld + col];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc_v[i][c] = fmaf(pv[i], ov, acc_v[i][c]);
            acc_k[i][c] = fmaf(dsv[i], qv, acc_k[i][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kp = k0 + ty + 16 * i;
    if (kp >= t_len) continue;
    const long long off = (((long long)b * t_len + kp) * n_heads + h) * dh;
#pragma unroll
    for (int c = 0; c < DMAX / 16; ++c) {
      const int col = tx + 16 * c;
      if (col < dh) {
        dk[off + col] = acc_k[i][c];
        dv[off + col] = acc_v[i][c];
      }
    }
  }
}

using fa_mma::bf16;

template <int DP, int NW, int BMQ>
__global__ void __launch_bounds__(NW * 32)
fa_bwd_dkv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      const int* __restrict__ lengths, bf16* __restrict__ dk,
                      bf16* __restrict__ dv, int t_len, int n_heads, int dh,
                      long long qsb, long long qst, long long ksb, long long kst,
                      long long vsb, long long vst, long long dsb, long long dst,
                      int causal, float scale) {
  using namespace fa_mma;
  constexpr int BNW = NW * 16;  // keys per block
  constexpr int NT = NW * 32;
  constexpr int LD = DP + 8;    // padded bf16 row
  constexpr int KC = DP / 16;   // k-chunks over the head dim
  constexpr int NQ = BMQ / 8;   // n-tiles over a q tile
  static_assert(BMQ % 32 == 0, "dP^T is formed 32 queries at a time");
  constexpr int ND = DP / 8;    // n-tiles of dK, dV
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // [BNW][LD]
  bf16* vs = ks + BNW * LD;                      // [BNW][LD]
  bf16* qs = vs + BNW * LD;                      // [2][BMQ][LD]
  bf16* dos = qs + 2 * BMQ * LD;                 // [2][BMQ][LD]
  float* lse_s = reinterpret_cast<float*>(dos + 2 * BMQ * LD);  // [2][BMQ]
  float* delta_s = lse_s + 2 * BMQ;                             // [2][BMQ]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int k0 = blockIdx.x * BNW;
  const int h = blockIdx.y, b = blockIdx.z;
  const int valid_len = min(max(lengths[b], 0), t_len);
  const long long bh = ((long long)b * n_heads + h) * t_len;
  const bf16* qb = q + b * qsb + (long long)h * dh;
  const bf16* ob = dout + b * dsb + (long long)h * dh;

  const int n_q = (t_len + BMQ - 1) / BMQ;
  // causal: q tiles wholly before this key tile see none of its keys; a key
  // tile wholly at or past the length is masked for every query
  const int first = k0 >= valid_len ? n_q : (causal ? k0 / BMQ : 0);

  // Q, dO, lse and delta of q tile `it` into buffer `buf`
  auto load_q_tile = [&](int it, int buf) {
    const int q0 = it * BMQ;
    load_rows<BMQ, DP, NT>(qs + buf * BMQ * LD, qb, qst, q0, t_len, dh);
    load_rows<BMQ, DP, NT>(dos + buf * BMQ * LD, ob, dst, q0, t_len, dh);
    for (int i = threadIdx.x; i < BMQ; i += NT) {
      const bool ok = q0 + i < t_len;
      cp_async_4(lse_s + buf * BMQ + i, lse + bh + (ok ? q0 + i : 0), ok);
      cp_async_4(delta_s + buf * BMQ + i, delta + bh + (ok ? q0 + i : 0), ok);
    }
  };

  if (first < n_q) {
    load_rows<BNW, DP, NT>(ks, k + b * ksb + (long long)h * dh, kst, k0, t_len, dh);
    load_rows<BNW, DP, NT>(vs, v + b * vsb + (long long)h * dh, vst, k0, t_len, dh);
    load_q_tile(first, 0);
  }
  cp_async_commit();

  // this lane's keys: kr and kr + 8 of the warp's 16
  const int kr = k0 + warp * 16 + g;
  const bf16* kw = ks + (warp * 16 + (lane & 15)) * LD + (lane >> 4) * 8;  // A rows
  const bf16* vw = vs + (warp * 16 + (lane & 15)) * LD + (lane >> 4) * 8;
  float acc_k[ND][4], acc_v[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.f;

  for (int it = first; it < n_q; ++it) {
    const int buf = (it - first) & 1;
    cp_async_wait<0>();
    __syncthreads();  // tile it landed; every warp is done with tile it - 1
    if (it + 1 < n_q) {
      load_q_tile(it + 1, buf ^ 1);
      cp_async_commit();
    }
    const bf16* qt = qs + buf * BMQ * LD;
    const bf16* ot = dos + buf * BMQ * LD;
    const float* ls = lse_s + buf * BMQ;
    const float* dls = delta_s + buf * BMQ;
    const int q0 = it * BMQ;
    // B fragments of two query n-tiles (rows of Q or dO) per ldmatrix
    const int brow = (lane & 7) + ((lane >> 4) << 3), bcol = ((lane >> 3) & 1) * 8;

    // B fragments through ldmatrix.trans for the products over queries
    const int trow = (lane & 7) + ((lane >> 3) & 1) * 8, tcol = (lane >> 4) * 8;

    // S^T = K Q^T: [16 keys] x [BMQ queries] per warp
    float st[NQ][4];
#pragma unroll
    for (int j = 0; j < NQ; ++j) st[j][0] = st[j][1] = st[j][2] = st[j][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      uint32_t ka[4];
      ldmatrix_x4(ka, kw + kc * 16);
#pragma unroll
      for (int jp = 0; jp < NQ / 2; ++jp) {
        uint32_t qf[4];
        ldmatrix_x4(qf, qt + (jp * 16 + brow) * LD + kc * 16 + bcol);
        mma_bf16(st[2 * jp], ka, qf[0], qf[1]);
        mma_bf16(st[2 * jp + 1], ka, qf[2], qf[3]);
      }
    }
    // P^T under the masks; element e of n-tile j is key kr + 8 * (e >> 1),
    // query q0 + 8 j + 2 tq + (e & 1)
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(ls + j * 8 + 2 * tq);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qp = q0 + j * 8 + 2 * tq + (e & 1);
        const int kp = kr + 8 * (e >> 1);
        const bool ok = kp < valid_len && qp < t_len && (!causal || kp <= qp);
        st[j][e] = ok ? expf(st[j][e] * scale - ((e & 1) ? l2.y : l2.x)) : 0.f;
      }
    }
    // dV += P^T dO: A = P^T rounded to bf16, B = rows of dO.  Done before
    // dP^T is formed, so the f32 P^T and dP^T tiles and both accumulators
    // are the most that is live at once.
#pragma unroll
    for (int kk = 0; kk < BMQ / 16; ++kk) {
      uint32_t pa[4];
      acc_to_a(pa, st[2 * kk], st[2 * kk + 1]);
#pragma unroll
      for (int dp = 0; dp < ND / 2; ++dp) {
        uint32_t of[4];
        ldmatrix_x4_trans(of, ot + (kk * 16 + trow) * LD + dp * 16 + tcol);
        mma_bf16(acc_v[2 * dp], pa, of[0], of[1]);
        mma_bf16(acc_v[2 * dp + 1], pa, of[2], of[3]);
      }
    }
    // dP^T = V dO^T, dS^T = P^T (dP^T - delta) scale (with the unrounded
    // f32 P^T) and dK += dS^T Q (A = dS^T rounded to bf16, B = rows of Q),
    // 32 queries at a time: half of dP^T is live, not all of it
#pragma unroll
    for (int c = 0; c < BMQ / 32; ++c) {
      float dpt[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) dpt[j][0] = dpt[j][1] = dpt[j][2] = dpt[j][3] = 0.f;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        uint32_t va[4];
        ldmatrix_x4(va, vw + kc * 16);
#pragma unroll
        for (int jp = 0; jp < 2; ++jp) {
          uint32_t of[4];
          ldmatrix_x4(of, ot + (c * 32 + jp * 16 + brow) * LD + kc * 16 + bcol);
          mma_bf16(dpt[2 * jp], va, of[0], of[1]);
          mma_bf16(dpt[2 * jp + 1], va, of[2], of[3]);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 d2 = *reinterpret_cast<const float2*>(dls + (c * 4 + j) * 8 + 2 * tq);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dpt[j][e] = st[c * 4 + j][e] * (dpt[j][e] - ((e & 1) ? d2.y : d2.x)) * scale;
      }
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        uint32_t da[4];
        acc_to_a(da, dpt[2 * kk], dpt[2 * kk + 1]);
#pragma unroll
        for (int dp = 0; dp < ND / 2; ++dp) {
          uint32_t qf[4];
          ldmatrix_x4_trans(qf, qt + (c * 32 + kk * 16 + trow) * LD + dp * 16 + tcol);
          mma_bf16(acc_k[2 * dp], da, qf[0], qf[1]);
          mma_bf16(acc_k[2 * dp + 1], da, qf[2], qf[3]);
        }
      }
    }
  }

  // dK and dV through this warp's rows of the K and V tiles, 16-byte stores
  cp_async_wait<0>();
  __syncthreads();  // with no q tile, K's and V's copies may still be in flight
  const long long row = (long long)n_heads * dh;
  const long long base = ((long long)b * t_len * n_heads + h) * dh;
  bf16* kst_s = ks + warp * 16 * LD;
  bf16* vst_s = vs + warp * 16 * LD;
  stage_acc<DP>(kst_s, acc_k, 1.f, 1.f);
  stage_acc<DP>(vst_s, acc_v, 1.f, 1.f);
  __syncwarp();
  store_rows<DP>(dk + base, row, kst_s, k0 + warp * 16, t_len, dh);
  store_rows<DP>(dv + base, row, vst_s, k0 + warp * 16, t_len, dh);
}

// dQ of one block of DQ_WARPS * 16 query rows over KN-key tiles, on the
// tensor cores.  Each warp owns 16 query rows, so every product of a key
// tile stays in that warp's registers, 16 keys at a time:
//   S = Q K^T,  dP = dO V^T,  P = exp(S scale - lse),
//   dS = P (dP - delta) scale,  dQ += dS K
// with Q and dO held as A fragments for the whole block, dS passed from its
// f32 accumulators to dQ += dS K as a bf16 A fragment, and K read from one
// shared tile in two roles: as the B operand of S (ldmatrix) and of dQ
// (ldmatrix.trans).
template <int DP, int NW, int KN>
__global__ void __launch_bounds__(NW * 32)
fa_bwd_dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     const int* __restrict__ lengths, bf16* __restrict__ dq, int t_len,
                     int n_heads, int dh, long long qsb, long long qst, long long ksb,
                     long long kst, long long vsb, long long vst, long long dsb,
                     long long dst, int causal, float scale) {
  using namespace fa_mma;
  constexpr int BMW = NW * 16;  // query rows per block
  constexpr int NT = NW * 32;
  constexpr int LD = DP + 8;    // padded bf16 row
  constexpr int KC = DP / 16;   // k-chunks over the head dim (S, dP)
  constexpr int NO = DP / 8;    // n-tiles of dQ (head dim)
  static_assert(KN % 16 == 0, "keys go 16 at a time");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [BMW][LD]
  bf16* dos = qs + BMW * LD;                     // [BMW][LD]
  bf16* ks = dos + BMW * LD;                     // [2][KN][LD]
  bf16* vs = ks + 2 * KN * LD;                   // [2][KN][LD]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int q0 = blockIdx.x * BMW;
  const int h = blockIdx.y, b = blockIdx.z;
  const int valid_len = min(max(lengths[b], 0), t_len);
  const long long bh = ((long long)b * n_heads + h) * t_len;
  const bf16* kb = k + b * ksb + (long long)h * dh;
  const bf16* vb = v + b * vsb + (long long)h * dh;

  int n_tiles = (t_len + KN - 1) / KN;
  if (causal) n_tiles = min(n_tiles, (min(q0 + BMW, t_len) + KN - 1) / KN);
  n_tiles = min(n_tiles, (valid_len + KN - 1) / KN);

  load_rows<BMW, DP, NT>(qs, q + b * qsb + (long long)h * dh, qst, q0, t_len, dh);
  load_rows<BMW, DP, NT>(dos, dout + b * dsb + (long long)h * dh, dst, q0, t_len, dh);
  if (n_tiles > 0) {
    load_rows<KN, DP, NT>(ks, kb, kst, 0, t_len, dh);
    load_rows<KN, DP, NT>(vs, vb, vst, 0, t_len, dh);
  }
  cp_async_commit();

  // this lane's rows: qr and qr + 8 of the warp's 16, with their lse, delta
  const int w0 = q0 + warp * 16;
  const int qr = w0 + g;
  float l_r[2], d_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = qr + 8 * r;
    l_r[r] = qp < t_len ? lse[bh + qp] : 0.f;
    d_r[r] = qp < t_len ? delta[bh + qp] : 0.f;
  }
  uint32_t qf[KC][4], of[KC][4];
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int jt = 0; jt < n_tiles; ++jt) {
    cp_async_wait<0>();
    __syncthreads();  // tile jt landed; every warp is done with tile jt - 1
    if (jt == 0) {
      const int arow = (warp * 16 + (lane & 15)) * LD + (lane >> 4) * 8;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        ldmatrix_x4(qf[kc], qs + arow + kc * 16);
        ldmatrix_x4(of[kc], dos + arow + kc * 16);
      }
    }
    if (jt + 1 < n_tiles) {
      const int nb = (jt + 1) & 1;
      load_rows<KN, DP, NT>(ks + nb * KN * LD, kb, kst, (jt + 1) * KN, t_len, dh);
      load_rows<KN, DP, NT>(vs + nb * KN * LD, vb, vst, (jt + 1) * KN, t_len, dh);
      cp_async_commit();
    }
    const int k0 = jt * KN;
    if (causal && k0 > w0 + 15) continue;  // every key of the tile follows the warp's rows
    const bf16* kt = ks + (jt & 1) * KN * LD;
    const bf16* vt = vs + (jt & 1) * KN * LD;
    // the masks are evaluated only where this warp's 16 rows see a masked key
    const bool full = k0 + KN <= valid_len && (!causal || k0 + KN - 1 <= w0);
    // B fragments of two key n-tiles per ldmatrix (K for S, V for dP), and
    // of two head-dim n-tiles per ldmatrix.trans (K for dQ)
    const int brow = (lane & 7) + ((lane >> 4) << 3), bcol = ((lane >> 3) & 1) * 8;
    const int trow = (lane & 7) + ((lane >> 3) & 1) * 8, tcol = (lane >> 4) * 8;
#pragma unroll
    for (int kk = 0; kk < KN / 16; ++kk) {
      float s[2][4], dp[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        uint32_t kf[4], vf[4];
        ldmatrix_x4(kf, kt + (kk * 16 + brow) * LD + kc * 16 + bcol);
        ldmatrix_x4(vf, vt + (kk * 16 + brow) * LD + kc * 16 + bcol);
        mma_bf16(s[0], qf[kc], kf[0], kf[1]);
        mma_bf16(s[1], qf[kc], kf[2], kf[3]);
        mma_bf16(dp[0], of[kc], vf[0], vf[1]);
        mma_bf16(dp[1], of[kc], vf[2], vf[3]);
      }
      // dS from the f32 P; element e of n-tile j is row qr + 8 * (e >> 1),
      // key k0 + 16 kk + 8 j + 2 tq + (e & 1)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          float p = expf(s[j][e] * scale - l_r[r]);
          if (!full) {
            const int kp = k0 + kk * 16 + j * 8 + 2 * tq + (e & 1);
            p = kp < valid_len && (!causal || kp <= qr + 8 * r) ? p : 0.f;
          }
          s[j][e] = p * (dp[j][e] - d_r[r]) * scale;
        }
      // dQ += dS K: A = dS rounded to bf16, B = K's rows through ldmatrix.trans
      uint32_t da[4];
      acc_to_a(da, s[0], s[1]);
#pragma unroll
      for (int dp2 = 0; dp2 < NO / 2; ++dp2) {
        uint32_t kf[4];
        ldmatrix_x4_trans(kf, kt + (kk * 16 + trow) * LD + dp2 * 16 + tcol);
        mma_bf16(acc[2 * dp2], da, kf[0], kf[1]);
        mma_bf16(acc[2 * dp2 + 1], da, kf[2], kf[3]);
      }
    }
  }

  // dQ through this warp's rows of the Q tile (read only at tile 0), 16-byte
  // stores; a block that ran no tile writes zeros
  cp_async_wait<0>();
  __syncthreads();  // with no key tile, Q's and dO's copies may still be in flight
  bf16* os = qs + warp * 16 * LD;
  stage_acc<DP>(os, acc, 1.f, 1.f);
  __syncwarp();
  store_rows<DP>(dq + ((long long)b * t_len * n_heads + h) * dh, (long long)n_heads * dh, os,
                 w0, t_len, dh);
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;
  const int* lengths;
  int b, t, h, dh;
  long long qsb, qst, ksb, kst, vsb, vst, dsb, dst;
  int causal;
  cudaStream_t stream;
};

int launch_dq(const Args& a, void* dq) {
  const int ld = a.dh + 1;
  const size_t smem =
      sizeof(float) * (size_t)(4 * BM * ld + BM * (BN + 1) + 2 * BM);
  cudaError_t err = cudaFuncSetAttribute(
      fa_bwd_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.t + BM - 1) / BM, a.h, a.b);
  fa_bwd_dq_kernel<<<grid, NTHREADS, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout), a.lse,
      a.delta, a.lengths, static_cast<float*>(dq), a.t, a.h, a.dh, a.qsb, a.qst,
      a.ksb, a.kst, a.vsb, a.vst, a.dsb, a.dst, a.causal,
      1.0f / sqrtf((float)a.dh));
  return (int)cudaGetLastError();
}

template <int DP>
int launch_dq_mma(const Args& a, void* dq) {
  constexpr int NW = DQ_WARPS;
  constexpr int KN = DQ_KEYS;
  const size_t smem = sizeof(bf16) * (size_t)(2 * NW * 16 + 4 * KN) * (DP + 8);
  cudaError_t err = cudaFuncSetAttribute(fa_bwd_dq_mma_kernel<DP, NW, KN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.t + NW * 16 - 1) / (NW * 16), a.h, a.b);
  fa_bwd_dq_mma_kernel<DP, NW, KN><<<grid, NW * 32, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout), a.lse,
      a.delta, a.lengths, static_cast<bf16*>(dq), a.t, a.h, a.dh, a.qsb, a.qst,
      a.ksb, a.kst, a.vsb, a.vst, a.dsb, a.dst, a.causal, 1.0f / sqrtf((float)a.dh));
  return (int)cudaGetLastError();
}

int launch_dkv(const Args& a, void* dk, void* dv) {
  const int ld = a.dh + 1;
  const size_t smem =
      sizeof(float) * (size_t)(4 * BM * ld + 2 * BM * (BN + 1) + 2 * BM);
  cudaError_t err = cudaFuncSetAttribute(
      fa_bwd_dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.t + BN - 1) / BN, a.h, a.b);
  fa_bwd_dkv_kernel<<<grid, NTHREADS, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout), a.lse,
      a.delta, a.lengths, static_cast<float*>(dk), static_cast<float*>(dv), a.t, a.h,
      a.dh, a.qsb, a.qst, a.ksb, a.kst, a.vsb, a.vst, a.dsb, a.dst, a.causal,
      1.0f / sqrtf((float)a.dh));
  return (int)cudaGetLastError();
}

template <int DP>
int launch_dkv_mma(const Args& a, void* dk, void* dv) {
  constexpr int NW = DKV_WARPS;
  constexpr int BMQ = DKV_BMQ;
  const size_t smem = sizeof(bf16) * (size_t)(2 * NW * 16 + 4 * BMQ) * (DP + 8) +
                      sizeof(float) * 4 * BMQ;
  cudaError_t err = cudaFuncSetAttribute(fa_bwd_dkv_mma_kernel<DP, NW, BMQ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.t + NW * 16 - 1) / (NW * 16), a.h, a.b);
  fa_bwd_dkv_mma_kernel<DP, NW, BMQ><<<grid, NW * 32, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout), a.lse,
      a.delta, a.lengths, static_cast<bf16*>(dk), static_cast<bf16*>(dv), a.t, a.h,
      a.dh, a.qsb, a.qst, a.ksb, a.kst, a.vsb, a.vst, a.dsb, a.dst, a.causal,
      1.0f / sqrtf((float)a.dh));
  return (int)cudaGetLastError();
}

bool bad_shape(int b, int t, int h, int dh) {
  return dh <= 0 || dh > DMAX || dh % 8 != 0 || b <= 0 || t <= 0 || h <= 0;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements; the head and
// head-dim axes of q, k, v and dout must be dense ([.., H, dh] with strides
// dh, 1); lse and delta are dense [B, H, T] f32; the outputs are dense
// [B, T, H, dh].  For the bf16 kernels, q, k, v and dout must be
// 16-byte aligned with batch and token strides that are multiples of 8 (the
// wrapper checks; cp.async copies 16 bytes).  Each returns the cudaError_t
// of its launch (0 on success).
extern "C" int flash_attention_bwd_dq(
    int dtype, const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, const int* lengths, void* dq, int b,
    int t, int h, int dh, long long qsb, long long qst, long long ksb,
    long long kst, long long vsb, long long vst, long long dsb, long long dst,
    int causal, void* stream) {
  if (bad_shape(b, t, h, dh)) return (int)cudaErrorInvalidValue;
  const Args a{q,   k,   v,   dout, lse, delta, lengths, b,   t,      h, dh,
               qsb, qst, ksb, kst,  vsb, vst,   dsb,     dst, causal,
               static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return launch_dq(a, dq);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  switch ((dh + 15) / 16) {  // the head dim padded to a multiple of 16
    case 1: return launch_dq_mma<16>(a, dq);
    case 2: return launch_dq_mma<32>(a, dq);
    case 3: return launch_dq_mma<48>(a, dq);
    case 4: return launch_dq_mma<64>(a, dq);
    case 5: return launch_dq_mma<80>(a, dq);
    case 6: return launch_dq_mma<96>(a, dq);
    case 7: return launch_dq_mma<112>(a, dq);
    default: return launch_dq_mma<128>(a, dq);
  }
}

extern "C" int flash_attention_bwd_dkv(
    int dtype, const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, const int* lengths, void* dk,
    void* dv, int b, int t, int h, int dh, long long qsb, long long qst,
    long long ksb, long long kst, long long vsb, long long vst, long long dsb,
    long long dst, int causal, void* stream) {
  if (bad_shape(b, t, h, dh)) return (int)cudaErrorInvalidValue;
  const Args a{q,   k,   v,   dout, lse, delta, lengths, b,   t,      h, dh,
               qsb, qst, ksb, kst,  vsb, vst,   dsb,     dst, causal,
               static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return launch_dkv(a, dk, dv);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  switch ((dh + 15) / 16) {  // the head dim padded to a multiple of 16
    case 1: return launch_dkv_mma<16>(a, dk, dv);
    case 2: return launch_dkv_mma<32>(a, dk, dv);
    case 3: return launch_dkv_mma<48>(a, dk, dv);
    case 4: return launch_dkv_mma<64>(a, dk, dv);
    case 5: return launch_dkv_mma<80>(a, dk, dv);
    case 6: return launch_dkv_mma<96>(a, dk, dv);
    case 7: return launch_dkv_mma<112>(a, dk, dv);
    default: return launch_dkv_mma<128>(a, dk, dv);
  }
}
