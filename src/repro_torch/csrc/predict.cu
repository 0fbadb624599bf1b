// Fused serving step for Hopper (sm_90a): for query rows x (t, q) against a
// frozen predictive state
//
//     mean = ksm @ a_mean                    (t, d)
//     quad = rowsum((ksm @ g) * ksm)         (t,)     var = sf2 - quad
//
// with ksm[r, a] = sf2 * exp(-1/2 sum_q (x_rq - z_aq)^2 / ell_q^2).
//
// Replaces the TPU kernel src/repro/kernels/predict/kernel.py,
// predict_pallas (body _predict_kernel).
//
// What bounds it on the H100: operations.  quad is t*m^2 multiply-adds
// (1.7e10 at t = 65,536, m = 512) against ~2 MB of input.  The design:
//   * The TPU walks every (a, b) tile of g in sequence for one query tile
//     and carries quad in its output block.  Here each block owns BT = 32
//     query rows and builds their whole (32, m) slab once in dynamic shared
//     memory (64 KB in f32 at m = 512, hence the
//     cudaFuncAttributeMaxDynamicSharedMemorySize opt-in), so the slab never
//     reaches device memory.
//   * It then streams (BK x BN) tiles of g through shared memory; each thread
//     keeps a 4-row x 4-column tile of (ksm @ g) in registers, multiplies it
//     by the matching slab entries and folds the products into its row sums,
//     which a fixed-order warp butterfly finishes.  mean = ksm @ a_mean is a
//     short loop over the slab.  The CUDA cores do every FMA.
//   * Every row goes through the same arithmetic in the same order, whatever
//     block or position it lands in, so output rows do not depend on the
//     tiling or on the padding of the batch.  Inducing points past m are
//     zero columns of the slab and zero entries of the g tiles; rows past t
//     are computed on x = 0 and never written.
//   * One template, instantiated for float and double.  An engine computes
//     in its compute dtype, as the JAX engine's default path does, so f64
//     states get the double instantiation; f32 (and lifted bf16/f16) states
//     get the float one.  g = Kmm^-1 - Sigma^-1 has entries of order
//     cond(Kmm) and its contraction cancels, but at sgpr-synth-1m the f32
//     tiles stay inside the serving budgets (PERF.md, PR 11).
//
// C interface, bound with ctypes from src/repro_torch/kernels/predict/kernel.py.
#include <cuda_runtime.h>

namespace {

constexpr int BT = 32;   // query rows per block: 8 warps x 4 rows
constexpr int BN = 128;  // g columns per tile: 32 lanes x 4 columns
constexpr int BK = 32;   // g rows per tile
constexpr int NT = 256;

__device__ __forceinline__ float exp_t(float v) { return expf(v); }
__device__ __forceinline__ double exp_t(double v) { return exp(v); }
__device__ __forceinline__ float fma_t(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_t(double a, double b, double c) { return fma(a, b, c); }

template <typename T>
__global__ void __launch_bounds__(NT)
predict_kernel(const T* __restrict__ x, const T* __restrict__ z,
               const T* __restrict__ hp, const T* __restrict__ a_mean,
               const T* __restrict__ g, int t, int m, int q, int d, int m_pad,
               T* __restrict__ mean, T* __restrict__ quad) {
  extern __shared__ double smem_d[];
  const int ld = m_pad + 1;                 // slab row stride
  T* ks = reinterpret_cast<T*>(smem_d);     // [BT][ld]
  T* gs = ks + BT * ld;                     // [BK][BN]
  T* xs = gs + BK * BN;                     // [BT][q]
  T* inv = xs + BT * q;                     // [q]

  const int tid = threadIdx.x;
  const long row0 = (long)blockIdx.x * BT;
  const T sf2 = hp[0];
  for (int e = tid; e < q; e += NT) inv[e] = hp[1 + e];
  const long xlim = (t - row0) * q;
  for (int e = tid; e < BT * q; e += NT) xs[e] = e < xlim ? x[row0 * q + e] : T(0);
  __syncthreads();

  for (int e = tid; e < BT * m_pad; e += NT) {
    const int r = e / m_pad, j = e % m_pad;
    T v = 0;
    if (j < m) {
      const T* zr = z + (size_t)j * q;
      const T* xr = xs + r * q;
      T s = 0;
      for (int k = 0; k < q; ++k) {
        const T dd = xr[k] - zr[k];
        s = fma_t(dd * dd, inv[k], s);
      }
      v = sf2 * exp_t(T(-0.5) * s);
    }
    ks[r * ld + j] = v;
  }
  __syncthreads();

  const int tx = tid % 32, ty = tid / 32;
  const T* kr[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) kr[i] = ks + (ty * 4 + i) * ld;
  T qacc[4] = {0, 0, 0, 0};

  for (int b0 = 0; b0 < m_pad; b0 += BN) {
    T acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0;
    for (int k0 = 0; k0 < m; k0 += BK) {
      for (int e = tid; e < BK * BN; e += NT) {
        const int gr = k0 + e / BN, gc = b0 + e % BN;
        gs[e] = gr < m && gc < m ? g[(size_t)gr * m + gc] : T(0);
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < BK; ++kk) {
        T gv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) gv[j] = gs[kk * BN + tx + 32 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const T kv = kr[i][k0 + kk];
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fma_t(kv, gv[j], acc[i][j]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        qacc[i] = fma_t(acc[i][j], kr[i][b0 + tx + 32 * j], qacc[i]);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    T v = qacc[i];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    const long row = row0 + ty * 4 + i;
    if (tx == 0 && row < t) quad[row] = v;
  }

  for (int e = tid; e < BT * d; e += NT) {
    const int r = e / d, c = e % d;
    const long row = row0 + r;
    if (row < t) {
      T s = 0;
      for (int j = 0; j < m; ++j) s = fma_t(ks[r * ld + j], a_mean[(size_t)j * d + c], s);
      mean[row * d + c] = s;
    }
  }
}

template <typename T>
int launch(const T* x, const T* z, const T* hp, const T* a_mean, const T* g,
           int t, int m, int q, int d, T* mean, T* quad, void* stream) {
  if (t == 0) return cudaSuccess;
  const int m_pad = (m + BN - 1) / BN * BN;
  const size_t smem = sizeof(T) * ((size_t)BT * (m_pad + 1) + BK * BN + BT * q + q);
  cudaError_t err = cudaFuncSetAttribute(
      predict_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  predict_kernel<T><<<(t + BT - 1) / BT, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      x, z, hp, a_mean, g, t, m, q, d, m_pad, mean, quad);
  return cudaGetLastError();
}

}  // namespace

// x (t,q), z (m,q), hp = [sf2, 1/ell^2 (q)], a_mean (m,d), g (m,m): contiguous,
// one dtype.  Outputs mean (t,d), quad (t,).  Returns cudaGetLastError().
extern "C" int predict_f32(const float* x, const float* z, const float* hp,
                           const float* a_mean, const float* g, int t, int m,
                           int q, int d, float* mean, float* quad, void* stream) {
  return launch<float>(x, z, hp, a_mean, g, t, m, q, d, mean, quad, stream);
}

extern "C" int predict_f64(const double* x, const double* z, const double* hp,
                           const double* a_mean, const double* g, int t, int m,
                           int q, int d, double* mean, double* quad, void* stream) {
  return launch<double>(x, z, hp, a_mean, g, t, m, q, d, mean, quad, stream);
}
