// Flash attention (online softmax) for LM prefill on Hopper (sm_90a):
//
//     o[b, h, r] = sum_c softmax_c(scale * q[b, h, r] . k[b, h/group, c]) v[b, h/group, c]
//
// over the keys c that row r sees: c < S and, when causal, c <= r + (S - T)
// (queries suffix-aligned to the keys).  A row that sees no key returns 0.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py:80,
// flash_attention (body _fa_kernel).
//
// What bounds it on the H100: operations.  Each visible (query, key) pair
// costs 2*Dh multiply-adds and one exp against 4*Dh bytes of q, k, v and o
// per row; at the llama3.2-1b prefill (B 4, H 32, Hkv 8, T = S = 2048,
// Dh 64) that is 6.9e10 flops over 84 MB.  This first version does its
// multiply-adds in f32 on the CUDA cores (no tensor cores, no TF32), so its
// floor is the f32 FMA rate, 14x below the bf16 tensor-core rate that
// PERF.md's bound assumes.  The design:
//   * The TPU walks a sequential kv grid axis and carries the running max,
//     normaliser and accumulator in VMEM scratch.  Here one block owns a
//     (b, h, 64-row query tile) and loops over 64-key tiles itself, the
//     three running quantities in registers.  The kv head is h / group, so
//     grouped K/V is read in place, never repeated per query head.
//   * Q is staged once, K and V per tile, all converted to f32 on load (Q
//     and K transposed, so each thread reads 4 rows and 4 keys as one
//     16-byte load).  Each of 256 threads owns a 4-row x 4-key patch of the
//     (64, 64) score tile, then the same 4 rows x Dh/16 columns of the
//     output; P goes through shared memory between the two products.
//   * Masked scores are -inf, not a large negative number: a tile in which
//     a row sees nothing leaves that row's max at -inf, its exps are taken
//     against 0 and come out exactly 0, and the row's sum stays 0, so a row
//     with no visible key writes exactly 0 whatever the tiling.  (The Pallas
//     kernel's -1e30 makes such rows depend on its block size.)
//   * Key tiles entirely above the diagonal are never loaded.  Query tiles
//     are issued last-first, so the longest rows of a causal launch start
//     first.  The ragged T and S edges are masked here, so no padded copies
//     are made; Q, K and V may be strided views (last axis contiguous).
//   * Exps are exp2f (the SFU's ex2) on scores pre-multiplied by
//     scale * log2(e).
//
// Instantiations: bf16 and f32 inputs (o in the input type), Dh 64 and 128.
// C interface, bound with ctypes from
// src/repro_torch/kernels/flash_attention/kernel.py.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per kv tile
constexpr int NT = 256;       // threads: 16 x 16, each 4 rows x 4 keys
constexpr int LDT = BQ + 4;   // row stride (floats) of the transposed tiles

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

struct Strides {
  long long b, h, t;  // elements; the last axis is contiguous
};

template <int DH>
constexpr size_t smem_bytes() {
  return sizeof(float) * (2 * DH * LDT + BK * (DH + 4) + BK * LDT);
}

template <typename T, int DH>
__global__ void __launch_bounds__(NT)
fa_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, int group, int t,
          int s_len, Strides qs, Strides ks, Strides vs, int causal,
          float scale_log2) {
  constexpr int LDV = DH + 4;
  constexpr int NC = DH / 64;                  // 4-column groups per thread
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);  // [DH][LDT]  q tile, transposed
  float* kt = qt + DH * LDT;                    // [DH][LDT]  k tile, transposed
  float* vt = kt + DH * LDT;                    // [BK][LDV]  v tile
  float* pt = vt + BK * LDV;                    // [BK][LDT]  p tile, transposed

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int hi = blockIdx.y, bi = blockIdx.z, kh = hi / group;
  const int q_offset = s_len - t;
  const T* qb = q + bi * qs.b + hi * qs.h;
  const T* kb = k + bi * ks.b + kh * ks.h;
  const T* vb = v + bi * vs.b + kh * vs.h;

  for (int e = tid; e < BQ * DH; e += NT) {
    const int r = e / DH, d = e % DH;
    qt[d * LDT + r] = q0 + r < t ? to_f32(qb[(q0 + r) * qs.t + d]) : 0.f;
  }
  // Keys [0, kv_end) hold every key a row of this tile sees.
  int kv_end = s_len;
  if (causal) kv_end = min(s_len, max(0, min(q0 + BQ, t) + q_offset));

  float m_i[4], l_i[4], acc[4][4 * NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = -INFINITY;
    l_i[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * NC; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();  // the previous tile's products are done with kt, vt, pt
    for (int e = tid; e < BK * DH; e += NT) {
      const int j = e / DH, d = e % DH;
      const bool in = k0 + j < s_len;
      kt[d * LDT + j] = in ? to_f32(kb[(k0 + j) * ks.t + d]) : 0.f;
      vt[j * LDV + d] = in ? to_f32(vb[(k0 + j) * vs.t + d]) : 0.f;
    }
    __syncthreads();

    // s = q k^T for rows ty*4 + i, keys tx*4 + j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DH; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(qt + d * LDT + ty * 4);
      const float4 b = *reinterpret_cast<const float4*>(kt + d * LDT + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
    }

    // online softmax over this tile's keys, in the log2 domain
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx * 4 + j;
        const bool seen = col < s_len && (!causal || col <= row + q_offset);
        s[i][j] = seen ? s[i][j] * scale_log2 : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_i[i], mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float corr = exp2f(m_i[i] - m_use);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = exp2f(s[i][j] - m_use);
        rs += s[i][j];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l_i[i] = l_i[i] * corr + rs;
      m_i[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * NC; ++c) acc[i][c] *= corr;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(pt + (tx * 4 + j) * LDT + ty * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

    // acc += p v for rows ty*4 + i, columns cc*64 + tx*4 + c
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      const float4 a = *reinterpret_cast<const float4*>(pt + j * LDT + ty * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) {
        const float4 b = *reinterpret_cast<const float4*>(vt + j * LDV + cc * 64 + tx * 4);
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc[i][cc * 4 + c] = fmaf(av[i], bv[c], acc[i][cc * 4 + c]);
      }
    }
  }

  T* ob = o + ((long long)bi * gridDim.y + hi) * t * DH;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= t) continue;
    const float inv = l_i[i] > 0.f ? 1.f / l_i[i] : 0.f;
#pragma unroll
    for (int cc = 0; cc < NC; ++cc)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        store(ob + (long long)row * DH + cc * 64 + tx * 4 + c, acc[i][cc * 4 + c] * inv);
  }
}

template <typename T, int DH>
int launch_dh(const T* q, const T* k, const T* v, T* o, int b, int h, int hkv,
              int t, int s_len, Strides qs, Strides ks, Strides vs, int causal,
              float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DH>();
  cudaError_t err = cudaFuncSetAttribute(
      fa_kernel<T, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((t + BQ - 1) / BQ, h, b);
  fa_kernel<T, DH><<<grid, NT, smem, stream>>>(
      q, k, v, o, h / hkv, t, s_len, qs, ks, vs, causal,
      scale * 1.4426950408889634f);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int b, int h,
           int hkv, int t, int s_len, int dh, long long qsb, long long qsh,
           long long qst, long long ksb, long long ksh, long long kst,
           long long vsb, long long vsh, long long vst, int causal,
           float scale, void* stream) {
  if (b == 0 || h == 0 || t == 0) return cudaSuccess;
  const Strides qs{qsb, qsh, qst}, ks{ksb, ksh, kst}, vs{vsb, vsh, vst};
  auto st = static_cast<cudaStream_t>(stream);
  auto qp = static_cast<const T*>(q), kp = static_cast<const T*>(k),
       vp = static_cast<const T*>(v);
  auto op = static_cast<T*>(o);
  if (dh == 64)
    return launch_dh<T, 64>(qp, kp, vp, op, b, h, hkv, t, s_len, qs, ks, vs, causal, scale, st);
  if (dh == 128)
    return launch_dh<T, 128>(qp, kp, vp, op, b, h, hkv, t, s_len, qs, ks, vs, causal, scale, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// q (B,H,T,Dh), k/v (B,Hkv,S,Dh), given by their element strides over B, H
// and T (Dh contiguous); o (B,H,T,Dh) contiguous, in the inputs' type.
// H % Hkv == 0, Dh in {64, 128}.  Returns cudaGetLastError().
extern "C" int flash_attention_bf16(
    const void* q, const void* k, const void* v, void* o, int b, int h,
    int hkv, int t, int s_len, int dh, long long qsb, long long qsh,
    long long qst, long long ksb, long long ksh, long long kst, long long vsb,
    long long vsh, long long vst, int causal, float scale, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, b, h, hkv, t, s_len, dh, qsb, qsh,
                               qst, ksb, ksh, kst, vsb, vsh, vst, causal,
                               scale, stream);
}

extern "C" int flash_attention_f32(
    const void* q, const void* k, const void* v, void* o, int b, int h,
    int hkv, int t, int s_len, int dh, long long qsb, long long qsh,
    long long qst, long long ksb, long long ksh, long long kst, long long vsb,
    long long vsh, long long vst, int causal, float scale, void* stream) {
  return launch<float>(q, k, v, o, b, h, hkv, t, s_len, dh, qsb, qsh, qst,
                       ksb, ksh, kst, vsb, vsh, vst, causal, scale, stream);
}
