// Fused serving step for Hopper (sm_90a): for query rows x (t, q) against a
// frozen predictive state
//
//     mean = ksm @ a_mean                    (t, d)
//     quad = rowsum((ksm @ g) * ksm)         (t,)     var = sf2 - quad
//
// with ksm[r, a] = sf2 * exp(-1/2 sum_q (x_rq - z_aq)^2 / ell_q^2).
//
// Replaces the TPU kernel src/repro/kernels/predict/kernel.py:75,
// predict_pallas (body _predict_kernel, pallas_call at :88).
//
// What bounds it on the H100: operations.  quad is a quadratic form in
// ksm's rows: t*m(m+1)/2 multiply-adds over the symmetric part of g (2.6e9
// at t = 65,536, m = 512), plus t*m slab entries of q distance FMAs and
// one exp each, against ~2.6 MB of input.  The design:
//   * quad sees only g's symmetric part.  Over 128-wide tiles A, B of the
//     inducing points, k^T g k = sum_A k_A^T g_AA k_A
//     + sum_{A<B} k_A^T (g_AB + g_BA^T) k_B.  A first small kernel writes
//     these upper pair tiles H_AB (zero past m) into scratch, in the order
//     the main kernel walks them; g is taken as given, never assumed
//     symmetric (a state's g = Kmm^-1 - Sigma^-1 is symmetric only up to
//     rounding, and the plain version multiplies by g as it is).
//   * The TPU walks every (a, b) tile of g for one query tile and rebuilds
//     both slab tiles at each step.  Here a block owns BT = 64 query rows
//     at a time (one block per SM, each walking row blocks in turn) and
//     walks the pairs with A descending, B >= A ascending.  Per A it builds
//     the slab panel K_A (64 x 128) once in shared memory on the CUDA
//     cores, adds K_A a_mean[A] into its rows of mean (in device memory,
//     one owner thread per entry), and each thread keeps its own entries
//     of K_A in registers and in the block's scratch.  Per pair it runs
//     T = K_A H_AB and folds rowsum(T * K_B) into each row's quad, K_B
//     being the panel's entries (B == A) or those kept from the earlier
//     step at A' = B: every slab entry is built once per row block.  The
//     scratch is SMs x 64 rows x m (34 MB at m = 512), so it stays in L2.
//   * f64: T on the FP64 tensor cores (DMMA: mma.sync m16n8k4, IEEE f64),
//     8 warps of 32 x 32 each.  f32: the same accumulator layout as IEEE
//     f32 FMAs on the CUDA cores (no TF32: the f32 tier has no room for it).
//   * H streams through shared memory in 32-row chunks, double-buffered
//     with cp.async, and stays in L2 (10 pair tiles, 1.3 MB at m = 512);
//     z, x and 1/ell^2 are staged QC = 16 features at a time, the exponent
//     sums carried across chunks.  Shared memory is fixed (SMEM_ELEMS),
//     whatever m, q and d.
//   * Every row goes through the same k order, the same order over its
//     thread's columns, a butterfly over the 4 lanes that share it and a
//     fixed-order sum over the 4 column warps, so an output row does not
//     depend on its position in the batch or on the batch's padding.  Rows
//     past t are computed on x = 0 and never written; inducing points past
//     m are zero columns of the slab and zero rows and columns of H.
//   * One template, instantiated for float and double.  An engine computes
//     in its compute dtype, as the JAX engine's default path does, so f64
//     states get the double instantiation; f32 (and lifted bf16/f16) states
//     get the float one.
//
// C interface, bound with ctypes from src/repro_torch/kernels/predict/kernel.py.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BT = 64;        // query rows per block
constexpr int TK = 128;       // inducing points per tile
constexpr int HK = 32;        // rows of an H tile per staged chunk
constexpr int NT = 256;       // 8 warps: 2 (rows) x 4 (columns) of 32 x 32
constexpr int LDP = TK + 4;   // panel and H-chunk row stride: no bank conflicts
constexpr int QC = 16;        // features of z, x and 1/ell^2 staged at a time
constexpr int XLD = QC + 1;   // staged x row stride
// H chunks [2][HK][LDP], panel [BT][LDP], z [QC][TK], x [BT][XLD],
// 1/ell^2 [QC], quad partials [4][BT]
constexpr int SMEM_ELEMS = 2 * HK * LDP + BT * LDP + QC * TK + BT * XLD + QC
                           + 4 * BT;
static_assert(SMEM_ELEMS * sizeof(double) <= 232448,
              "f64 block over sm_90's 227 KB");

__device__ __forceinline__ float exp_t(float v) { return expf(v); }
__device__ __forceinline__ double exp_t(double v) { return exp(v); }
__device__ __forceinline__ float fma_t(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fma_t(double a, double b, double c) { return fma(a, b, c); }

// c (16 x 8) += a (16 x 4) b (4 x 8) in f64.  Lane l holds a[l/4][l%4] and
// a[l/4 + 8][l%4], b[l%4][l/4], c[l/4 (+8)][2(l%4) + {0, 1}].
__device__ __forceinline__ void dmma(double (&c)[4], const double (&a)[2],
                                     double b) {
  asm volatile(
      "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a[0]), "d"(a[1]), "d"(b));
}

// 16 bytes global -> shared, cached in L2 only.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
                  "l"(src)
               : "memory");
}

// The thread's 4 consecutive entries [mt][nt][0..3] to and from the
// block's scratch.
__device__ __forceinline__ void put4(double* p, const double (&v)[4]) {
  reinterpret_cast<double2*>(p)[0] = make_double2(v[0], v[1]);
  reinterpret_cast<double2*>(p)[1] = make_double2(v[2], v[3]);
}
__device__ __forceinline__ void put4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void get4(const double* p, double (&v)[4]) {
  const double2 lo = reinterpret_cast<const double2*>(p)[0];
  const double2 hi = reinterpret_cast<const double2*>(p)[1];
  v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
}
__device__ __forceinline__ void get4(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}

// The upper pair tiles of g's symmetric part, in the order the main kernel
// walks them (A = nts-1 down to 0, B = A .. nts-1): H[p] = g_AA, or
// g_AB + g_BA^T for A < B; zero past m.
template <typename T>
__global__ void predict_pairs(const T* __restrict__ g, int m, int nts,
                              T* __restrict__ h) {
  const int p = blockIdx.x;
  int j = 0, rem = p;  // j = nts-1-A: the walk's row j has j+1 pairs
  while (rem > j) {
    rem -= j + 1;
    ++j;
  }
  const int a = nts - 1 - j, b = a + rem;
  T* hp = h + (size_t)p * TK * TK;
  for (int e = blockIdx.y * blockDim.x + threadIdx.x; e < TK * TK;
       e += gridDim.y * blockDim.x) {
    const int r = a * TK + e / TK, c = b * TK + e % TK;
    T v = 0;
    if (r < m && c < m) {
      v = g[(size_t)r * m + c];
      if (a != b) v += g[(size_t)c * m + r];
    }
    hp[e] = v;
  }
}

template <typename T>
__global__ void __launch_bounds__(NT, 1)
predict_kernel(const T* __restrict__ x, const T* __restrict__ z,
               const T* __restrict__ hp, const T* __restrict__ a_mean,
               const T* __restrict__ h, int t, int m, int q, int d,
               T* __restrict__ kscr, T* __restrict__ mean,
               T* __restrict__ quad) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* hs = reinterpret_cast<T*>(smem_raw);  // [2][HK][LDP]  chunks of H
  T* panel = hs + 2 * HK * LDP;            // [BT][LDP]     K_A
  T* zs = panel + BT * LDP;                // [QC][TK]      z of one tile
  T* xs = zs + QC * TK;                    // [BT][XLD]     the block's x rows
  T* inv = xs + BT * XLD;                  // [QC]          1/ell^2
  T* red = inv + QC;                       // [4][BT]       quad partials

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int wm = warp / 4, wn = warp % 4;
  const int nts = (m + TK - 1) / TK;
  const int n_chunks = nts * (nts + 1) / 2 * (TK / HK);
  const long n_blocks = (t + BT - 1) / BT;
  // chunks of H this block streams over all its row blocks
  const long n_stream = (n_blocks - blockIdx.x + gridDim.x - 1) / gridDim.x * n_chunks;
  const T sf2 = hp[0];
  // A thread's entries of a (BT x TK) tile are those of its DMMA
  // accumulators: rows wm*32 + mt*16 + gid + 8*hf, columns
  // wn*32 + nt*8 + 2*tig + e, held at [mt][nt][2*hf + e].
  auto row_of = [&](int mt, int hf) { return wm * 32 + mt * 16 + gid + 8 * hf; };
  auto col_of = [&](int nt, int e) { return wn * 32 + nt * 8 + 2 * tig + e; };
  // The thread's entries [mt][nt][0..3] of tile A's slab in the scratch
  // (layout [block][A][mt*4 + nt][thread][4]: a warp's stores are
  // contiguous).
  auto kslot = [&](int A, int mt, int nt) {
    return kscr + (((size_t)blockIdx.x * nts + A) * 8 + mt * 4 + nt) * NT * 4 + tid * 4;
  };

  // Chunk s of the block's stream of H (pair (s % n_chunks) / 4, rows
  // 32 (s % 4) ...) into buffer s & 1.
  auto issue = [&](long s) {
    if (s >= n_stream) return;
    constexpr int VEC = 16 / sizeof(T);
    const T* src = h + (size_t)(s % n_chunks) * HK * TK;
    T* dst = hs + (s & 1) * HK * LDP;
    for (int e = tid; e < HK * TK / VEC; e += NT) {
      const int r = e / (TK / VEC), c = e % (TK / VEC) * VEC;
      cp_async16(dst + r * LDP + c, src + r * TK + c);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  T kb[2][4][4], acc[2][4][4];
  // acc += K_A[:, 32 kc ...] . (the staged chunk hb of H)
  auto product = [&](const T* hb, int kc) {
    if constexpr (std::is_same<T, double>::value) {
#pragma unroll
      for (int kk = 0; kk < HK / 4; ++kk) {
        const int kcol = kc * HK + kk * 4 + tig;
        double af[2][2], bf[4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) af[mt][hf] = panel[row_of(mt, hf) * LDP + kcol];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          bf[nt] = hb[(kk * 4 + tig) * LDP + wn * 32 + nt * 8 + gid];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) dmma(acc[mt][nt], af[mt], bf[nt]);
      }
    } else {
#pragma unroll 4
      for (int kk = 0; kk < HK; ++kk) {
        float av[2][2];
        float2 bv[4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf)
            av[mt][hf] = panel[row_of(mt, hf) * LDP + kc * HK + kk];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          bv[nt] = *reinterpret_cast<const float2*>(hb + kk * LDP + col_of(nt, 0));
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              acc[mt][nt][2 * hf] = fmaf(av[mt][hf], bv[nt].x, acc[mt][nt][2 * hf]);
              acc[mt][nt][2 * hf + 1] = fmaf(av[mt][hf], bv[nt].y, acc[mt][nt][2 * hf + 1]);
            }
      }
    }
  };

  long s = 0;  // the next chunk of the block's stream of H
  issue(0);
  for (long blk = blockIdx.x; blk < n_blocks; blk += gridDim.x) {
    const long row0 = blk * BT;
    bool x_staged = false;
    // z of one tile and 1/ell^2, features [k0, k0 + kw), and the x rows:
    // once when q <= QC (they stay), with every chunk otherwise.
    auto stage = [&](int tile, int k0, int kw) {
      __syncthreads();  // the previous stage and the panel are consumed
      for (int e = tid; e < kw; e += NT) inv[e] = hp[1 + k0 + e];
      for (int e = tid; e < kw * TK; e += NT) {
        const int k = e / TK, col = tile * TK + e % TK;
        zs[e] = col < m ? z[(size_t)col * q + k0 + k] : T(0);
      }
      if (!x_staged || q > QC)
        for (int e = tid; e < BT * kw; e += NT) {
          const int r = e / kw, k = e % kw;
          xs[r * XLD + k] = row0 + r < t ? x[(row0 + r) * q + k0 + k] : T(0);
        }
      x_staged = true;
      __syncthreads();
    };

    T qrow[2][2] = {{T(0), T(0)}, {T(0), T(0)}};
    for (int A = nts - 1; A >= 0; --A) {
      // K_A into the panel.  Each thread owns column i of half of the rows
      // and takes 8 rows at a time, so each z and 1/ell^2 it loads serves
      // 8 rows; the exponent sums carry across q-chunks in the panel.
      const int i = tid % TK, rb = (tid / TK) * (BT / 2);
      const bool valid = A * TK + i < m;
      for (int k0 = 0; k0 < q; k0 += QC) {
        const int kw = min(QC, q - k0);
        stage(A, k0, kw);
        for (int g = 0; g < BT / 2; g += 8) {
          T sm[8];
#pragma unroll
          for (int u = 0; u < 8; ++u)
            sm[u] = k0 == 0 ? T(0) : panel[(rb + g + u) * LDP + i];
          for (int k = 0; k < kw; ++k) {
            const T zv = zs[k * TK + i], iv = inv[k];
#pragma unroll
            for (int u = 0; u < 8; ++u) {
              const T dd = xs[(rb + g + u) * XLD + k] - zv;
              sm[u] = fma_t(dd * dd, iv, sm[u]);
            }
          }
          const bool last = k0 + QC >= q;
#pragma unroll
          for (int u = 0; u < 8; ++u)
            panel[(rb + g + u) * LDP + i] =
                !last ? sm[u] : valid ? sf2 * exp_t(T(-0.5) * sm[u]) : T(0);
        }
      }
      __syncthreads();  // the panel is complete

      // mean rows += K_A a_mean[A], in 4 interleaved chains
      const int kmax = min(TK, m - A * TK);
      for (int e = tid; e < BT * d; e += NT) {
        const int r = e / d, c = e % d;
        const long row = row0 + r;
        const T* ar = a_mean + (size_t)A * TK * d + c;
        T s4[4] = {T(0), T(0), T(0), T(0)};
        int k = 0;
        for (; k + 4 <= kmax; k += 4)
#pragma unroll
          for (int u = 0; u < 4; ++u)
            s4[u] = fma_t(panel[r * LDP + k + u], ar[(size_t)(k + u) * d], s4[u]);
        for (; k < kmax; ++k) s4[0] = fma_t(panel[r * LDP + k], ar[(size_t)k * d], s4[0]);
        const T sm = (s4[0] + s4[1]) + (s4[2] + s4[3]);
        if (row < t) mean[row * d + c] = A == nts - 1 ? sm : mean[row * d + c] + sm;
      }

      for (int B = A; B < nts; ++B) {
        // K_B: the panel's entries (kept for the later pairs (A', A)), or
        // those kept at the earlier step A' = B
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            if (B == A) {
#pragma unroll
              for (int v = 0; v < 4; ++v)
                kb[mt][nt][v] = panel[row_of(mt, v >> 1) * LDP + col_of(nt, v & 1)];
              if (A > 0) put4(kslot(A, mt, nt), kb[mt][nt]);
            } else {
              get4(kslot(B, mt, nt), kb[mt][nt]);
            }
          }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int v = 0; v < 4; ++v) acc[mt][nt][v] = T(0);
        for (int kc = 0; kc < TK / HK; ++kc, ++s) {
          asm volatile("cp.async.wait_group 0;\n" ::: "memory");
          __syncthreads();  // chunk s is in; chunk s-1's buffer is free
          issue(s + 1);
          product(hs + (s & 1) * HK * LDP, kc);
        }
        // quad += rowsum(T * K_B), each row over its thread's columns in order
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int v = 0; v < 4; ++v)
              qrow[mt][v >> 1] = fma_t(acc[mt][nt][v], kb[mt][nt][v], qrow[mt][v >> 1]);
      }
    }

    // Each row: the 4 lanes that share it (a butterfly), then the 4 column
    // warps in a fixed order.
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        T v = qrow[mt][hf];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        if (tig == 0) red[wn * BT + row_of(mt, hf)] = v;
      }
    __syncthreads();
    if (tid < BT && row0 + tid < t)
      quad[row0 + tid] = ((red[tid] + red[BT + tid]) + red[2 * BT + tid]) + red[3 * BT + tid];
  }
}

template <typename T>
int launch(const T* x, const T* z, const T* hp, const T* a_mean, const T* g,
           int t, int m, int q, int d, int blocks, T* h, T* kscr, T* mean,
           T* quad, void* stream) {
  if (t == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nts = (m + TK - 1) / TK;
  predict_pairs<T><<<dim3(nts * (nts + 1) / 2, 8), 256, 0, s>>>(g, m, nts, h);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem = sizeof(T) * SMEM_ELEMS;
  err = cudaFuncSetAttribute(predict_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  predict_kernel<T><<<blocks, NT, smem, s>>>(x, z, hp, a_mean, h, t, m, q, d,
                                             kscr, mean, quad);
  return cudaGetLastError();
}

}  // namespace

// x (t,q), z (m,q), hp = [sf2, 1/ell^2 (q)], a_mean (m,d), g (m,m): contiguous,
// one dtype.  `blocks` persistent blocks (at most one per SM: each takes
// most of an SM's shared memory) walk the ceil(t/64) row blocks.  Scratch
// in that dtype: h (nts(nts+1)/2, 128, 128) and kscr (blocks, nts, 64, 128)
// with nts = ceil(m/128).  Outputs mean (t,d), quad (t,).  Any m, q and d.
// Returns cudaGetLastError().
extern "C" int predict_f32(const float* x, const float* z, const float* hp,
                           const float* a_mean, const float* g, int t, int m,
                           int q, int d, int blocks, float* h, float* kscr,
                           float* mean, float* quad, void* stream) {
  return launch<float>(x, z, hp, a_mean, g, t, m, q, d, blocks, h, kscr, mean,
                       quad, stream);
}

extern "C" int predict_f64(const double* x, const double* z, const double* hp,
                           const double* a_mean, const double* g, int t, int m,
                           int q, int d, int blocks, double* h, double* kscr,
                           double* mean, double* quad, void* stream) {
  return launch<double>(x, z, hp, a_mean, g, t, m, q, d, blocks, h, kscr, mean,
                        quad, stream);
}
