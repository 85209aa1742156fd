// Flash-attention backward for Hopper (sm_90a): two kernels, dq and dk/dv,
// bound through plain C functions loaded with ctypes (see
// paddle_tpu_torch/ops/flash_attention.py).
//
// Replaces the TPU kernels paddle_tpu/ops/pallas_attention.py:
//   _fa_bwd_dq_kernel   -> fa_bwd_dq_kernel
//   _fa_bwd_dkv_kernel  -> fa_bwd_dkv_kernel
// (both launched by _flash_bwd).  They compute the same functions, with the
// masks of the forward (keys at or past lengths[b] masked, an optional
// causal mask, scale = 1/sqrt(dh)):
//   p  = where(mask, exp(s - lse), 0),   s = q k^T * scale
//   dp = dO v^T,   ds = p * (dp - delta) * scale,   delta = rowsum(dO * O)
//   dq = ds k,     dk = ds^T q,          dv = p^T dO
// lse comes from the forward kernel and delta is computed outside the
// kernels, both [B, H, T] f32.  Scores, p, dp, ds and the three accumulators
// stay f32 (bf16 inputs are widened on load); each gradient rounds once on
// store.  The TPU kernel rounds p and ds to the input dtype before its MXU
// products; these kernels keep them f32, as the forward does.
//
// Design (simple first):
//   * dq: one block of 256 threads per (q-tile of 64 rows, head, batch); a
//     loop over 64-key tiles of K and V staged in shared memory, stopping at
//     the causal diagonal and at the last tile that holds a valid key.  A
//     block whose loop runs no tile (a row of length 0) writes dq = 0.
//   * dk/dv: one block per (64-key tile, head, batch); a loop over q-tiles
//     (from the diagonal when causal) with Q, dO, lse and delta staged in
//     shared memory.  A key tile wholly at or past lengths[b] runs no tile
//     and writes zeros: the outputs come from torch.empty.
//   * products by scalar FMA with a 4x4 (resp. 4 x dh/16) register tile per
//     thread, as in the forward; no atomics: each block owns its outputs.
//   * q, k, v and dO are read through their batch and token strides (the
//     fused QKV projection's column slices need no copy); dq, dk and dv are
//     written dense [B, T, H, dh].
//
// Bound on this card: per (query, key, head) the masks keep, dq does 6*dh
// operations (recomputed s, dp, dq) and dk/dv 8*dh (s, dp, dv, dk), over
// ~O(B*T*H*dh) bytes: at Transformer-base shapes (T = 1024, dh = 64) far
// above the H100's ridge point, so both kernels are bounded by operations
// (989 TFLOP/s bf16 on the tensor cores).  This version does its products
// on the CUDA cores in f32 and leaves the tensor cores idle; mma.sync/wgmma
// operands, cp.async or TMA double buffering and a fused dq are for a later
// version.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;        // query rows per tile
constexpr int BN = 64;        // keys per tile
constexpr int NTHREADS = 256;
constexpr int DMAX = 128;     // largest head dim

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void from_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void from_f32(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// rows [r0, r0 + 64) of one head of x (token stride st) into s[64][ld] as
// f32; rows at or past t_len read as 0
template <typename T>
__device__ __forceinline__ void stage_rows(float* s, const T* x, long long st,
                                           int r0, int t_len, int dh, int ld) {
  for (int idx = threadIdx.x; idx < BM * dh; idx += NTHREADS) {
    const int r = idx / dh, d = idx - r * dh;
    const int p = r0 + r;
    s[r * ld + d] = p < t_len ? to_f32(x[p * st + d]) : 0.f;
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

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
fa_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 const int* __restrict__ lengths, T* __restrict__ dq,
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

  const T* kb = k + b * ksb + (long long)h * dh;
  const T* vb = v + b * vsb + (long long)h * dh;
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
    T* row = dq + (((long long)b * t_len + qp) * n_heads + h) * dh;
#pragma unroll
    for (int c = 0; c < DMAX / 16; ++c) {
      const int col = tx + 16 * c;
      if (col < dh) from_f32(row + col, acc[i][c]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
fa_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, const T* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ delta,
                  const int* __restrict__ lengths, T* __restrict__ dk,
                  T* __restrict__ dv, int t_len, int n_heads, int dh,
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

  const T* qb = q + b * qsb + (long long)h * dh;
  const T* ob = dout + b * dsb + (long long)h * dh;
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
        from_f32(dk + off + col, acc_k[i][c]);
        from_f32(dv + off + col, acc_v[i][c]);
      }
    }
  }
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

template <typename T>
int launch_dq(const Args& a, void* dq) {
  const int ld = a.dh + 1;
  const size_t smem =
      sizeof(float) * (size_t)(4 * BM * ld + BM * (BN + 1) + 2 * BM);
  cudaError_t err = cudaFuncSetAttribute(
      fa_bwd_dq_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.t + BM - 1) / BM, a.h, a.b);
  fa_bwd_dq_kernel<T><<<grid, NTHREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, a.lengths, static_cast<T*>(dq), a.t, a.h, a.dh, a.qsb, a.qst,
      a.ksb, a.kst, a.vsb, a.vst, a.dsb, a.dst, a.causal,
      1.0f / sqrtf((float)a.dh));
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dkv(const Args& a, void* dk, void* dv) {
  const int ld = a.dh + 1;
  const size_t smem =
      sizeof(float) * (size_t)(4 * BM * ld + 2 * BM * (BN + 1) + 2 * BM);
  cudaError_t err = cudaFuncSetAttribute(
      fa_bwd_dkv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.t + BN - 1) / BN, a.h, a.b);
  fa_bwd_dkv_kernel<T><<<grid, NTHREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, a.lengths, static_cast<T*>(dk), static_cast<T*>(dv), a.t, a.h,
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
// [B, T, H, dh].  Each returns the cudaError_t of its launch (0 on success).
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
  if (dtype == 0) return launch_dq<float>(a, dq);
  if (dtype == 1) return launch_dq<__nv_bfloat16>(a, dq);
  return (int)cudaErrorInvalidValue;
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
  if (dtype == 0) return launch_dkv<float>(a, dk, dv);
  if (dtype == 1) return launch_dkv<__nv_bfloat16>(a, dk, dv);
  return (int)cudaErrorInvalidValue;
}
