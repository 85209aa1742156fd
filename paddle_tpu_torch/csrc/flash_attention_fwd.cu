// Flash-attention forward for Hopper (sm_90a), bound through a plain C
// function loaded with ctypes (see paddle_tpu_torch/ops/flash_attention.py).
//
// Replaces the TPU kernel paddle_tpu/ops/pallas_attention.py:_fa_fwd_kernel
// (launched by _flash_fwd).  It computes the same function: exact softmax
// attention with an online softmax over key tiles, keys at or past
// lengths[b] masked, an optional causal mask, scale 1/sqrt(dh), the output
// O in the input dtype and the row log-sum-exp lse = m + log(max(l, 1e-20))
// in f32.  A row with no valid key gives O = 0 and lse = -1e30 + log(1e-20),
// as the TPU kernel does.  Like the TPU kernel, p is rounded to the input
// dtype before P@V (pallas_attention.py:114) while l sums the f32 p.
//
// Bound on this card: at Transformer-base shapes (dh = 64) the work is
// 4*B*H*T^2*dh operations over ~2*B*T*H*dh*4 bytes, i.e. far above the
// H100's ridge point, so the kernel is bounded by operations (989 TFLOP/s
// bf16 on the tensor cores).
//
// The entry point dispatches on dtype:
//   * bf16: fa_fwd_mma_kernel, on the tensor cores (flash_mma.cuh).  One
//     block of FWD_WARPS = 8 warps (128 query rows; 4 warps tied with it)
//     per (q tile, head, batch), 16 query rows per warp.  Q is loaded once into A fragments;
//     64-key tiles of K and V are double-buffered in shared memory with
//     cp.async, so tile j+1 loads while tile j computes (one __syncthreads
//     per tile).  S = Q K^T goes to f32 accumulators, the online softmax
//     runs in registers with the row max and sum over the four lanes of a
//     quad, and O += P V takes P straight from the S fragments rounded to
//     bf16, V through ldmatrix.trans.  A warp whose 16 rows see no masked
//     key in a tile skips the mask arithmetic.  The head dim is zero-padded
//     to a multiple of 16 in shared memory (the kernel is instantiated for
//     each).  Bounded in practice by the softmax's one exp per (query, key):
//     the SFU's rate, not the tensor cores, at dh = 64.
//   * f32: fa_fwd_kernel, the scalar kernel below: the parity dtype, whose
//     bars (1e-4 against the plain version) TF32 products would break.  One
//     block of 256 threads per (q tile of 64, head, batch), K and V staged
//     as f32, scores and P@V by scalar FMA.
// Both skip key tiles past the causal diagonal or wholly past lengths[b]
// (they contribute exactly nothing to m, l or the accumulator), read q, k, v
// through their batch and token strides (the fused QKV projection's column
// slices need no copy), and write O into [B, T, H, dh] and lse into
// [B, H, T].

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "flash_mma.cuh"

namespace {

constexpr int FWD_WARPS = 8;  // warps (16 query rows each) per block of the bf16 kernel
constexpr int BM = 64;        // query rows per block
constexpr int BN = 64;        // keys per tile
constexpr int NTHREADS = 256;
constexpr int DMAX = 128;     // largest head dim
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ void from_f32(float* p, float x) { *p = x; }

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
fa_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int* __restrict__ lengths,
              T* __restrict__ o, float* __restrict__ lse,
              int t_len, int n_heads, int dh,
              long long qsb, long long qst, long long ksb, long long kst,
              long long vsb, long long vst, int causal, float scale) {
  extern __shared__ float smem[];
  const int ld = dh + 1;  // padded row stride: no bank conflicts on rows
  float* qs = smem;                 // [BM][ld]
  float* ks = qs + BM * ld;         // [BN][ld]
  float* vs = ks + BN * ld;         // [BN][ld]
  float* ps = vs + BN * ld;         // [BM][BN + 1]
  float* corr_s = ps + BM * (BN + 1);  // [BM]
  float* l_s = corr_s + BM;            // [BM]
  float* m_s = l_s + BM;               // [BM]

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  // the block loads its own length (the TPU kernel's scalar prefetch)
  const int valid_len = min(max(lengths[b], 0), t_len);

  const T* qb = q + b * qsb + (long long)h * dh;
  const T* kb = k + b * ksb + (long long)h * dh;
  const T* vb = v + b * vsb + (long long)h * dh;

  for (int idx = tid; idx < BM * dh; idx += NTHREADS) {
    const int r = idx / dh, d = idx - r * dh;
    const int qp = q0 + r;
    qs[r * ld + d] = qp < t_len ? to_f32(qb[qp * qst + d]) : 0.f;
  }

  // tile mapping for S = Q K^T and O += P V: rows ty + 16 i, cols tx + 16 j
  const int tx = tid & 15, ty = tid >> 4;
  // row mapping for the softmax: 4 threads per row, keys sub + 4 i
  const int srow = tid >> 2, sub = tid & 3;
  const int sq = q0 + srow;

  float acc[4][DMAX / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DMAX / 16; ++c) acc[i][c] = 0.f;
  float m_row = -INFINITY, l_row = 0.f;

  int n_tiles = (t_len + BN - 1) / BN;
  if (causal) n_tiles = min(n_tiles, (min(q0 + BM, t_len) + BN - 1) / BN);
  n_tiles = min(n_tiles, (valid_len + BN - 1) / BN);

  for (int jt = 0; jt < n_tiles; ++jt) {
    const int k0 = jt * BN;
    __syncthreads();  // previous tile's K, V and P are consumed
    for (int idx = tid; idx < BN * dh; idx += NTHREADS) {
      const int r = idx / dh, d = idx - r * dh;
      const int kp = k0 + r;
      const bool in = kp < t_len;
      ks[r * ld + d] = in ? to_f32(kb[kp * kst + d]) : 0.f;
      vs[r * ld + d] = in ? to_f32(vb[kp * vst + d]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < dh; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty + 16 * i) * ld + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * ld + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ps[(ty + 16 * i) * (BN + 1) + tx + 16 * j] = s[i][j] * scale;
    __syncthreads();

    // online softmax over this tile, one row per 4 threads
    float p[BN / 4];
    float blk_max = NEG_INF;
#pragma unroll
    for (int i = 0; i < BN / 4; ++i) {
      const int kp = k0 + sub + 4 * i;
      const bool ok = kp < valid_len && (!causal || kp <= sq);
      p[i] = ok ? ps[srow * (BN + 1) + sub + 4 * i] : NEG_INF;
      blk_max = fmaxf(blk_max, p[i]);
    }
    blk_max = fmaxf(blk_max, __shfl_xor_sync(0xffffffffu, blk_max, 1));
    blk_max = fmaxf(blk_max, __shfl_xor_sync(0xffffffffu, blk_max, 2));
    const float m_new = fmaxf(m_row, blk_max);
    float psum = 0.f;
#pragma unroll
    for (int i = 0; i < BN / 4; ++i) {
      const int kp = k0 + sub + 4 * i;
      const bool ok = kp < valid_len && (!causal || kp <= sq);
      const float e = ok ? __expf(p[i] - m_new) : 0.f;
      ps[srow * (BN + 1) + sub + 4 * i] = e;
      psum += e;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    const float corr = __expf(m_row - m_new);  // exp(-inf) = 0 on tile 0
    l_row = l_row * corr + psum;
    m_row = m_new;
    if (sub == 0) corr_s[srow] = corr;
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const float cr = corr_s[r];
#pragma unroll
      for (int c = 0; c < DMAX / 16; ++c) acc[i][c] *= cr;
    }
    for (int kk = 0; kk < BN; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty + 16 * i) * (BN + 1) + kk];
#pragma unroll
      for (int c = 0; c < DMAX / 16; ++c) {
        const int col = tx + 16 * c;
        if (col < dh) {
          const float vv = vs[kk * ld + col];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
        }
      }
    }
  }

  // a row that saw no valid key keeps the TPU kernel's finite -1e30 max
  const float m_fin = m_row == -INFINITY ? NEG_INF : m_row;
  const float l_safe = fmaxf(l_row, 1e-20f);
  if (sub == 0) {
    l_s[srow] = l_safe;
    m_s[srow] = m_fin;
    if (sq < t_len)
      lse[((long long)b * n_heads + h) * t_len + sq] = m_fin + logf(l_safe);
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int qp = q0 + r;
    if (qp >= t_len) continue;
    const float inv = 1.f / l_s[r];
    T* orow = o + (((long long)b * t_len + qp) * n_heads + h) * dh;
#pragma unroll
    for (int c = 0; c < DMAX / 16; ++c) {
      const int col = tx + 16 * c;
      if (col < dh) from_f32(orow + col, acc[i][c] * inv);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const int* lengths,
           void* o, float* lse, int b, int t, int h, int dh, long long qsb,
           long long qst, long long ksb, long long kst, long long vsb,
           long long vst, int causal, cudaStream_t stream) {
  const int ld = dh + 1;
  const size_t smem =
      sizeof(float) * (size_t)(3 * BM * ld + BM * (BN + 1) + 3 * BM);
  cudaError_t err = cudaFuncSetAttribute(
      fa_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((t + BM - 1) / BM, h, b);
  fa_fwd_kernel<T><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, static_cast<T*>(o), lse, t, h, dh,
      qsb, qst, ksb, kst, vsb, vst, causal, 1.0f / sqrtf((float)dh));
  return (int)cudaGetLastError();
}

using fa_mma::bf16;

template <int DP, int NW>
__global__ void __launch_bounds__(NW * 32)
fa_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const int* __restrict__ lengths,
                  bf16* __restrict__ o, float* __restrict__ lse, int t_len,
                  int n_heads, int dh, long long qsb, long long qst,
                  long long ksb, long long kst, long long vsb, long long vst,
                  int causal, float scale) {
  using namespace fa_mma;
  constexpr int BMW = NW * 16;  // query rows per block
  constexpr int NT = NW * 32;
  constexpr int LD = DP + 8;    // padded bf16 row
  constexpr int KC = DP / 16;   // k-chunks of Q K^T
  constexpr int NS = BN / 8;    // n-tiles of S (keys)
  constexpr int NO = DP / 8;    // n-tiles of O (head dim)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [BMW][LD]
  bf16* ks = qs + BMW * LD;                      // [2][BN][LD]
  bf16* vs = ks + 2 * BN * LD;                   // [2][BN][LD]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int q0 = blockIdx.x * BMW;
  const int h = blockIdx.y, b = blockIdx.z;
  const int valid_len = min(max(lengths[b], 0), t_len);
  const bf16* qb = q + b * qsb + (long long)h * dh;
  const bf16* kb = k + b * ksb + (long long)h * dh;
  const bf16* vb = v + b * vsb + (long long)h * dh;

  int n_tiles = (t_len + BN - 1) / BN;
  if (causal) n_tiles = min(n_tiles, (min(q0 + BMW, t_len) + BN - 1) / BN);
  n_tiles = min(n_tiles, (valid_len + BN - 1) / BN);

  load_rows<BMW, DP, NT>(qs, qb, qst, q0, t_len, dh);
  if (n_tiles > 0) {
    load_rows<BN, DP, NT>(ks, kb, kst, 0, t_len, dh);
    load_rows<BN, DP, NT>(vs, vb, vst, 0, t_len, dh);
  }
  cp_async_commit();

  // this lane's rows: qr and qr + 8 of the warp's 16
  const int qr = q0 + warp * 16 + g;
  uint32_t qf[KC][4];
  float acc[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m_r[2] = {-INFINITY, -INFINITY};
  float l_r[2] = {0.f, 0.f};  // this lane's part of the row sums

  for (int jt = 0; jt < n_tiles; ++jt) {
    cp_async_wait<0>();
    __syncthreads();  // tile jt landed; every warp is done with tile jt - 1
    if (jt == 0) {
#pragma unroll
      for (int kc = 0; kc < KC; ++kc)
        ldmatrix_x4(qf[kc], qs + (warp * 16 + (lane & 15)) * LD + kc * 16 + (lane >> 4) * 8);
    }
    if (jt + 1 < n_tiles) {
      const int nb = (jt + 1) & 1;
      load_rows<BN, DP, NT>(ks + nb * BN * LD, kb, kst, (jt + 1) * BN, t_len, dh);
      load_rows<BN, DP, NT>(vs + nb * BN * LD, vb, vst, (jt + 1) * BN, t_len, dh);
      cp_async_commit();
    }
    const bf16* kt = ks + (jt & 1) * BN * LD;
    const bf16* vt = vs + (jt & 1) * BN * LD;
    const int k0 = jt * BN;

    // S = Q K^T: B fragments of two key n-tiles per ldmatrix
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
#pragma unroll
      for (int jp = 0; jp < NS / 2; ++jp) {
        uint32_t kf[4];
        ldmatrix_x4(kf, kt + (jp * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD + kc * 16 +
                            ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * jp], qf[kc], kf[0], kf[1]);
        mma_bf16(s[2 * jp + 1], qf[kc], kf[2], kf[3]);
      }
    }

    // online softmax in registers; element e of n-tile j is row
    // qr + 8 * (e >> 1), key k0 + 8 j + 2 tq + (e & 1).  The masks are
    // evaluated only where this warp's 16 rows see a masked key in the tile.
    const bool full = k0 + BN <= valid_len && (!causal || k0 + BN - 1 <= q0 + warp * 16);
    uint32_t ok_bits = 0xffffffffu;
    if (full) {
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] *= scale;
    } else {
      ok_bits = 0;
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = k0 + j * 8 + 2 * tq + (e & 1);
          const bool ok = kp < valid_len && (!causal || kp <= qr + 8 * (e >> 1));
          ok_bits |= (uint32_t)ok << (4 * j + e);
          s[j][e] = ok ? s[j][e] * scale : NEG_INF;
        }
    }
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
    float corr[2], m_new[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m_new[r] = fmaxf(m_r[r], quad_max(mx[r]));
      corr[r] = __expf(m_r[r] - m_new[r]);  // exp(-inf) = 0 on the first tile
      m_r[r] = m_new[r];
    }
    float ps[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = (ok_bits >> (4 * j + e)) & 1u ? __expf(s[j][e] - m_new[e >> 1]) : 0.f;
        ps[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_r[r] = l_r[r] * corr[r] + ps[r];
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }

    // O += P V: P from the S fragments (bf16), V through ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      uint32_t pa[4];
      acc_to_a(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int dp = 0; dp < NO / 2; ++dp) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, vt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                                  dp * 16 + (lane >> 4) * 8);
        mma_bf16(acc[2 * dp], pa, vf[0], vf[1]);
        mma_bf16(acc[2 * dp + 1], pa, vf[2], vf[3]);
      }
    }
  }

  // a row that saw no valid key keeps the TPU kernel's finite -1e30 max
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float l_safe = fmaxf(quad_sum(l_r[r]), 1e-20f);
    const float m_fin = m_r[r] == -INFINITY ? NEG_INF : m_r[r];
    inv[r] = 1.f / l_safe;
    const int qp = qr + 8 * r;
    if (tq == 0 && qp < t_len)
      lse[((long long)b * n_heads + h) * t_len + qp] = m_fin + logf(l_safe);
  }
  // O through this warp's rows of the Q tile (no longer read), 16-byte stores
  cp_async_wait<0>();
  __syncthreads();  // with no key tile, Q's copies may still be in flight
  bf16* os = qs + warp * 16 * LD;
  stage_acc<DP>(os, acc, inv[0], inv[1]);
  __syncwarp();
  store_rows<DP>(o + ((long long)b * t_len * n_heads + h) * dh, (long long)n_heads * dh, os,
                 q0 + warp * 16, t_len, dh);
}

template <int DP>
int launch_mma(const void* q, const void* k, const void* v, const int* lengths,
               void* o, float* lse, int b, int t, int h, int dh, long long qsb,
               long long qst, long long ksb, long long kst, long long vsb,
               long long vst, int causal, cudaStream_t stream) {
  constexpr int NW = FWD_WARPS;
  const size_t smem = sizeof(bf16) * (size_t)(NW * 16 + 4 * BN) * (DP + 8);
  cudaError_t err = cudaFuncSetAttribute(
      fa_fwd_mma_kernel<DP, NW>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((t + NW * 16 - 1) / (NW * 16), h, b);
  fa_fwd_mma_kernel<DP, NW><<<grid, NW * 32, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), lengths, static_cast<bf16*>(o), lse, t, h, dh,
      qsb, qst, ksb, kst, vsb, vst, causal, 1.0f / sqrtf((float)dh));
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32 (scalar kernel), 1 = bfloat16 (tensor cores).  Strides
// are in elements; the head and head-dim axes must be dense ([.., H, dh] with
// strides dh, 1).  For bf16, q, k and v must be 16-byte aligned with batch and
// token strides that are multiples of 8 (the wrapper checks; cp.async copies
// 16 bytes).  Returns the cudaError_t of the launch (0 on success).
extern "C" int flash_attention_fwd(int dtype, const void* q, const void* k,
                                   const void* v, const int* lengths, void* o,
                                   float* lse, int b, int t, int h, int dh,
                                   long long qsb, long long qst, long long ksb,
                                   long long kst, long long vsb, long long vst,
                                   int causal, void* stream) {
  if (dh <= 0 || dh > DMAX || dh % 8 != 0 || b <= 0 || t <= 0 || h <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, lengths, o, lse, b, t, h, dh, qsb, qst, ksb,
                         kst, vsb, vst, causal, s);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
#define FA_FWD_MMA(DP)                                                       \
  return launch_mma<DP>(q, k, v, lengths, o, lse, b, t, h, dh, qsb, qst, ksb, \
                        kst, vsb, vst, causal, s)
  switch ((dh + 15) / 16) {  // the head dim padded to a multiple of 16
    case 1: FA_FWD_MMA(16);
    case 2: FA_FWD_MMA(32);
    case 3: FA_FWD_MMA(48);
    case 4: FA_FWD_MMA(64);
    case 5: FA_FWD_MMA(80);
    case 6: FA_FWD_MMA(96);
    case 7: FA_FWD_MMA(112);
    default: FA_FWD_MMA(128);
  }
#undef FA_FWD_MMA
}
