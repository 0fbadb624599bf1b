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
//     at a time (f64; one block per SM, each walking row blocks in turn) and
//     walks the pairs with A descending, B >= A ascending.  Per A it builds
//     the slab panel K_A (64 x 128) once in shared memory on the CUDA
//     cores, adds K_A a_mean[A] into its rows of mean (in device memory,
//     one owner thread per entry), and each thread keeps its own entries
//     of K_A in registers and in the block's scratch.  Per pair it runs
//     T = K_A H_AB and folds rowsum(T * K_B) into each row's quad, K_B
//     being the panel's entries (B == A) or those kept from the earlier
//     step at A' = B: every slab entry is built once per row block.  The
//     scratch is blocks x rows x m (34 MB f64 at m = 512, 69 MB f32 of
//     which a block's live part is its current row block's), in L2.
//   * f64: T on the FP64 tensor cores (DMMA: mma.sync m16n8k4, IEEE f64),
//     8 warps of 32 x 32 each.
//   * f32 (predict_f32_kernel): IEEE f32 FMAs on the CUDA cores (no TF32:
//     the f32 tier has no room for it).  What bounds an f32 FMA loop on
//     Hopper is shared memory: an SM delivers 128 bytes a clock against 128
//     FMA lanes.  So each thread holds an 8 x 8 patch of T (128-row
//     blocks, two to an SM: 16 warps): per k four conflict-free float4
//     loads (the panel is stored transposed, so a thread's rows are
//     contiguous) for 64 FMAs, 1 byte per FMA, where the DMMA layout
//     replayed as FMAs loaded 1.5.  An 8 x 16 patch (0.75 bytes per FMA)
//     needs ~255 registers, so 8 warps an SM, and measured slower.  The
//     slab is built from x and z scaled by sqrt(log2(e) / (2 ell^2)): two
//     ops per feature and one ex2.approx per entry.
//   * H streams through shared memory in 32-row chunks (f32: 16), double
//     buffered with cp.async, and stays in L2 (10 pair tiles, 1.3 MB f64
//     at m = 512); z, x and 1/ell^2 are staged QC = 16 features at a time,
//     the exponent sums carried across chunks.  Shared memory is fixed (SMEM_ELEMS,
//     F32_SMEM_ELEMS), whatever m, q and d, and its attribute is set once
//     per device.
//   * The hyper-parameters come as the log values the caller holds;
//     predict_pairs writes sf2 and 1/ell^2 beside the pair tiles.
//   * Every row goes through the same k order, the same order over its
//     thread's columns, a butterfly over the lanes that share it (4 f64,
//     8 f32) and a fixed-order sum over the column warps, so an output row
//     does not depend on its position in the batch or its padding.  Rows
//     past t are computed on x = 0 and never written; inducing points past
//     m are zero columns of the slab and zero rows and columns of H.
//   * An engine computes in its compute dtype, as the JAX engine's default
//     path does, so f64 states get the f64 kernel; f32 (and lifted
//     bf16/f16) states get the f32 one.
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
__device__ __forceinline__ void get4(const double* p, double (&v)[4]) {
  const double2 lo = reinterpret_cast<const double2*>(p)[0];
  const double2 hi = reinterpret_cast<const double2*>(p)[1];
  v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
}

// The upper pair tiles of g's symmetric part, in the order the main kernel
// walks them (A = nts-1 down to 0, B = A .. nts-1): H[p] = g_AA, or
// g_AB + g_BA^T for A < B; zero past m.  After them, hp = [sf2, 1/ell^2
// (q)] from the log hyper-parameters, rounded as the plain version rounds
// them (exp(log_sf2), exp(-2 log_ell)).
template <typename T>
__global__ void predict_pairs(const T* __restrict__ g,
                              const T* __restrict__ log_sf2,
                              const T* __restrict__ log_ell, int m, int q,
                              int nts, T* __restrict__ h) {
  if (blockIdx.x == 0 && blockIdx.y == 0) {
    T* hp = h + (size_t)nts * (nts + 1) / 2 * TK * TK;
    for (int k = threadIdx.x; k <= q; k += blockDim.x)
      hp[k] = k == 0 ? exp_t(log_sf2[0]) : exp_t(T(-2) * log_ell[k - 1]);
  }
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

// f64: T = K_A H_AB on the FP64 tensor cores.
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

// ---------------------------------------------------------------------------
// f32: IEEE f32 FMAs on the CUDA cores, 8 x 8 register tiles
// ---------------------------------------------------------------------------

constexpr int FBT = 128;        // query rows per block
constexpr int FHK = 16;         // rows of an H tile per staged chunk
constexpr int FLDT = FBT + 4;   // transposed panel row stride (floats)
constexpr int FLDH = TK + 4;    // H chunk row stride (floats)
// H chunks [2][FHK][FLDH], panel K_A^T [TK][FLDT], z [QC][TK], x [FBT][XLD],
// the exponent scales [QC], quad partials [2][FBT], each thread's row sums
// [8][NT] (kept out of the product loop's registers)
constexpr int F32_SMEM_ELEMS = 2 * FHK * FLDH + TK * FLDT + QC * TK + FBT * XLD
                               + QC + 2 * FBT + 8 * NT;
static_assert(2 * (F32_SMEM_ELEMS * sizeof(float) + 1024) <= 233472,
              "two f32 blocks over an SM's 228 KB");

__device__ __forceinline__ float ex2_approx(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// Rows r of K_A^T's columns [i0, i0 + TK/2) over KW staged features (the
// chunk's own, zero-padded to a multiple of 4): x and z come scaled by
// sqrt(log2(e) / (2 ell^2)), so the exponent sum is sum (x - z)^2 and the
// entry sf2 2^-sum, one ex2.approx.  The sums carry across q-chunks in the
// panel (first / last chunk).
template <int KW>
__device__ __forceinline__ void slab_rows(float* panel, const float* zs,
                                          const float* xs, int r, int i0,
                                          int n_valid, bool first, bool last,
                                          float sf2) {
  float xr[KW];
#pragma unroll
  for (int k = 0; k < KW; ++k) xr[k] = xs[r * XLD + k];
  for (int i = i0; i < i0 + TK / 2; ++i) {
    float sm = first ? 0.f : panel[i * FLDT + r];
#pragma unroll
    for (int k = 0; k < KW; ++k) {
      const float dd = xr[k] - zs[k * TK + i];
      sm = fmaf(dd, dd, sm);
    }
    panel[i * FLDT + r] = !last ? sm : i < n_valid ? sf2 * ex2_approx(-sm) : 0.f;
  }
}

// The same function in f32.  A block owns FBT = 128 query rows at a time
// (two blocks per SM, each walking row blocks in turn) and walks the pairs
// as the f64 kernel does.  Each thread owns an 8 x 8 patch of the 128 x 128
// tile T = K_A H_AB: rows rg*4 + {0..3} and 64 + rg*4 + {0..3}, columns
// cg*4 + {0..3} and 64 + cg*4 + {0..3}, so per k it loads its 8 rows of the
// transposed panel and its 8 columns of H as four float4 (conflict-free: a
// warp's 4 row groups and 8 column groups are contiguous) for 64 FMAs.
// Its K_B entries are read in the epilogue from the panel (B == A) or the
// block's scratch, where each thread's 64 entries are 16 float4 at
// [block][A][v][thread] (a warp's accesses contiguous).  The slab exps are
// single ex2.approx instructions, log2(e) / 2 folded into the staged x and z
// (slab_rows).
__global__ void __launch_bounds__(NT, 2)
predict_f32_kernel(const float* __restrict__ x, const float* __restrict__ z,
                   const float* __restrict__ hp, const float* __restrict__ a_mean,
                   const float* __restrict__ h, int t, int m, int q, int d,
                   float* __restrict__ kscr, float* __restrict__ mean,
                   float* __restrict__ quad) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* hs = reinterpret_cast<float*>(smem_raw);  // [2][FHK][FLDH]  chunks of H
  float* panel = hs + 2 * FHK * FLDH;              // [TK][FLDT]      K_A^T
  float* zs = panel + TK * FLDT;                   // [QC][TK]        z of one tile
  float* xs = zs + QC * TK;                        // [FBT][XLD]      the block's x rows
  float* scl = xs + FBT * XLD;                     // [QC]  sqrt(log2(e)/(2 ell^2))
  float* red = scl + QC;                           // [2][FBT]        quad partials
  float* qs = red + 2 * FBT;                       // [8][NT]         each thread's row sums

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rg = (warp >> 1) * 4 + (lane >> 3);    // row group, 0..15
  const int cg = (warp & 1) * 8 + (lane & 7);      // column group, 0..15
  const int nts = (m + TK - 1) / TK;
  const int n_chunks = nts * (nts + 1) / 2 * (TK / FHK);
  const long n_blocks = (t + FBT - 1) / FBT;
  const long n_stream = (n_blocks - blockIdx.x + gridDim.x - 1) / gridDim.x * n_chunks;
  const float sf2 = hp[0];
  // the thread's patch: row i (0..7), column j (0..7) of the tile
  auto row_of = [&](int i) { return (i >> 2) * 64 + rg * 4 + (i & 3); };
  auto col_of = [&](int j) { return (j >> 2) * 64 + cg * 4 + (j & 3); };
  // float4 v (0..15: column j = v / 2, rows 4 (v % 2) ...) of the thread's
  // K entries of tile A in the scratch
  auto kslot = [&](int A, int v) {
    return reinterpret_cast<float4*>(kscr) + (((size_t)blockIdx.x * nts + A) * 16 + v) * NT + tid;
  };

  auto issue = [&](long s) {
    if (s >= n_stream) return;
    const float* src = h + (size_t)(s % n_chunks) * FHK * TK;
    float* dst = hs + (s & 1) * FHK * FLDH;
    for (int e = tid; e < FHK * TK / 4; e += NT) {
      const int r = e / (TK / 4), c = e % (TK / 4) * 4;
      cp_async16(dst + r * FLDH + c, src + r * TK + c);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  long s = 0;  // the next chunk of the block's stream of H
  issue(0);
  for (long blk = blockIdx.x; blk < n_blocks; blk += gridDim.x) {
    const long row0 = blk * FBT;
    bool x_staged = false;
    // z of one tile, features [k0, k0 + kw) zero-padded to kw4, and the x
    // rows, each scaled by sqrt(log2(e) / (2 ell^2)): the x rows once when
    // q <= QC (they stay), with every chunk otherwise.
    auto stage = [&](int tile, int k0, int kw, int kw4) {
      __syncthreads();  // the previous stage and the panel are consumed
      for (int e = tid; e < kw; e += NT)
        scl[e] = sqrtf(hp[1 + k0 + e] * 0.72134752044448170368f);
      __syncthreads();
      for (int e = tid; e < kw4 * TK; e += NT) {
        const int k = e / TK, col = tile * TK + e % TK;
        zs[e] = col < m && k < kw ? z[(size_t)col * q + k0 + k] * scl[k] : 0.f;
      }
      if (!x_staged || q > QC)
        for (int e = tid; e < FBT * kw4; e += NT) {
          const int r = e / kw4, k = e % kw4;
          xs[r * XLD + k] = row0 + r < t && k < kw ? x[(row0 + r) * q + k0 + k] * scl[k] : 0.f;
        }
      x_staged = true;
      __syncthreads();
    };

#pragma unroll
    for (int i = 0; i < 8; ++i) qs[i * NT + tid] = 0.f;
    for (int A = nts - 1; A >= 0; --A) {
      // K_A^T into the panel.  Each thread owns row r and half of the
      // columns, its x features in registers; z is a broadcast and its
      // stores consecutive in r.
      const int r = tid % FBT, i0 = (tid / FBT) * (TK / 2);
      for (int k0 = 0; k0 < q; k0 += QC) {
        const int kw = min(QC, q - k0), kw4 = (kw + 3) & ~3;
        stage(A, k0, kw, kw4);
        const bool first = k0 == 0, last = k0 + QC >= q;
        const int n_valid = m - A * TK;
        switch (kw4) {
          case 4: slab_rows<4>(panel, zs, xs, r, i0, n_valid, first, last, sf2); break;
          case 8: slab_rows<8>(panel, zs, xs, r, i0, n_valid, first, last, sf2); break;
          case 12: slab_rows<12>(panel, zs, xs, r, i0, n_valid, first, last, sf2); break;
          default: slab_rows<16>(panel, zs, xs, r, i0, n_valid, first, last, sf2);
        }
      }
      __syncthreads();  // the panel is complete

      // mean rows += K_A a_mean[A], in 4 interleaved chains
      const int kmax = min(TK, m - A * TK);
      for (int e = tid; e < FBT * d; e += NT) {
        const int rr = e % FBT, c = e / FBT;
        const long row = row0 + rr;
        const float* ar = a_mean + (size_t)A * TK * d + c;
        float s4[4] = {0.f, 0.f, 0.f, 0.f};
        int k = 0;
        for (; k + 4 <= kmax; k += 4)
#pragma unroll
          for (int u = 0; u < 4; ++u)
            s4[u] = fmaf(panel[(k + u) * FLDT + rr], ar[(size_t)(k + u) * d], s4[u]);
        for (; k < kmax; ++k) s4[0] = fmaf(panel[k * FLDT + rr], ar[(size_t)k * d], s4[0]);
        const float sm = (s4[0] + s4[1]) + (s4[2] + s4[3]);
        if (row < t) mean[row * d + c] = A == nts - 1 ? sm : mean[row * d + c] + sm;
      }

      for (int B = A; B < nts; ++B) {
        float acc[8][8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
        for (int kc = 0; kc < TK / FHK; ++kc, ++s) {
          asm volatile("cp.async.wait_group 0;\n" ::: "memory");
          __syncthreads();  // chunk s is in; chunk s-1's buffer is free
          issue(s + 1);
          const float* hb = hs + (s & 1) * FHK * FLDH;
          const float* pk = panel + kc * FHK * FLDT;
#pragma unroll
          for (int kk = 0; kk < FHK; ++kk) {
            const float4 a0 = *reinterpret_cast<const float4*>(pk + kk * FLDT + rg * 4);
            const float4 a1 = *reinterpret_cast<const float4*>(pk + kk * FLDT + 64 + rg * 4);
            const float4 b0 = *reinterpret_cast<const float4*>(hb + kk * FLDH + cg * 4);
            const float4 b1 = *reinterpret_cast<const float4*>(hb + kk * FLDH + 64 + cg * 4);
            const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
            const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
              for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
          }
        }
        // quad += rowsum(T * K_B), each row over its thread's columns in
        // order; K_B from the panel (kept for the later pairs (A', A)) or
        // kept at the earlier step A' = B
        float qrow[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) qrow[i] = qs[i * NT + tid];
#pragma unroll
        for (int v = 0; v < 16; ++v) {
          const int j = v >> 1, i4 = (v & 1) * 4;
          float4 kb;
          if (B == A) {
            kb = *reinterpret_cast<const float4*>(panel + col_of(j) * FLDT + row_of(i4));
            if (A > 0) *kslot(A, v) = kb;
          } else {
            kb = *kslot(B, v);
          }
          qrow[i4] = fmaf(acc[i4][j], kb.x, qrow[i4]);
          qrow[i4 + 1] = fmaf(acc[i4 + 1][j], kb.y, qrow[i4 + 1]);
          qrow[i4 + 2] = fmaf(acc[i4 + 2][j], kb.z, qrow[i4 + 2]);
          qrow[i4 + 3] = fmaf(acc[i4 + 3][j], kb.w, qrow[i4 + 3]);
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) qs[i * NT + tid] = qrow[i];
      }
    }

    // Each row: the 8 lanes that share it (a butterfly), then the two
    // column warps in a fixed order.
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float v = qs[i * NT + tid];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      if ((lane & 7) == 0) red[(warp & 1) * FBT + row_of(i)] = v;
    }
    __syncthreads();
    if (tid < FBT && row0 + tid < t) quad[row0 + tid] = red[tid] + red[FBT + tid];
  }
}

// The pair tiles and hyper-parameters, then the walk of `blocks` persistent
// blocks (kernel.py::scratch: one per SM in f64, two in f32).
template <typename T>
int launch(const T* x, const T* z, const T* log_sf2, const T* log_ell,
           const T* a_mean, const T* g, int t, int m, int q, int d, int blocks,
           T* h, T* kscr, T* mean, T* quad, void* stream) {
  if (t == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nts = (m + TK - 1) / TK;
  predict_pairs<T><<<dim3(nts * (nts + 1) / 2, 8), 256, 0, s>>>(
      g, log_sf2, log_ell, m, q, nts, h);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const T* hp = h + (size_t)nts * (nts + 1) / 2 * TK * TK;
  constexpr bool f64 = std::is_same<T, double>::value;
  const size_t smem = f64 ? sizeof(double) * SMEM_ELEMS : sizeof(float) * F32_SMEM_ELEMS;
  // The shared-memory attribute once per device: a runtime call per launch
  // costs host time the card waits for.
  static bool ready[64] = {};
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || !ready[dev]) {
    if constexpr (f64)
      err = cudaFuncSetAttribute(predict_kernel<double>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    else
      err = cudaFuncSetAttribute(predict_f32_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    if (dev < 64) ready[dev] = true;
  }
  if constexpr (f64)
    predict_kernel<double><<<blocks, NT, smem, s>>>(x, z, hp, a_mean, h, t, m, q, d,
                                                    kscr, mean, quad);
  else
    predict_f32_kernel<<<blocks, NT, smem, s>>>(x, z, hp, a_mean, h, t, m, q, d,
                                                kscr, mean, quad);
  return cudaGetLastError();
}

}  // namespace

// x (t,q), z (m,q), log_sf2 (), log_ell (q,), a_mean (m,d), g (m,m):
// contiguous, one dtype.  `blocks` persistent blocks (at most one per SM in
// f64, two in f32) walk the row blocks of 64 (f64) or 128 (f32) rows.
// Scratch in that dtype: h (nts(nts+1)/2 * 128 * 128 + q + 1: the pair
// tiles, then sf2 and 1/ell^2) and kscr (blocks, nts, rows, 128) with
// nts = ceil(m/128).  Outputs mean (t,d), quad (t,).  Any m, q and d.
// Returns cudaGetLastError().
extern "C" int predict_f32(const float* x, const float* z, const float* log_sf2,
                           const float* log_ell, const float* a_mean,
                           const float* g, int t, int m, int q, int d,
                           int blocks, float* h, float* kscr, float* mean,
                           float* quad, void* stream) {
  return launch<float>(x, z, log_sf2, log_ell, a_mean, g, t, m, q, d, blocks,
                       h, kscr, mean, quad, stream);
}

extern "C" int predict_f64(const double* x, const double* z,
                           const double* log_sf2, const double* log_ell,
                           const double* a_mean, const double* g, int t, int m,
                           int q, int d, int blocks, double* h, double* kscr,
                           double* mean, double* quad, void* stream) {
  return launch<double>(x, z, log_sf2, log_ell, a_mean, g, t, m, q, d, blocks,
                        h, kscr, mean, quad, stream);
}
