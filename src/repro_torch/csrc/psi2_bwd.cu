// Backward of the weighted psi2 statistic for Hopper (sm_90a): the
// vector-Jacobian product of
//
//     D[j, k] = sum_n w_n psi_n[j, k],
//     psi_n[j, k] = sf2^2 prod_q (1 + 2 s_nq / l_q^2)^-1/2
//                   exp(-(z_jq - z_kq)^2 / (4 l_q^2) - r^2 / (l_q^2 + 2 s_nq)),
//     r = mu_nq - (z_jq + z_kq) / 2   (summed over q in the exponent),
//
// for the cotangent g (m, m) (kernels/psi_stats/ref.py::psi2_vjp_ref
// states the closed form).
//
// Replaces the backward of the TPU kernel's custom_vjp,
// src/repro/kernels/psi_stats/ops.py:56: jax.vjp of gp_kernels.psi2_mxu,
// which writes the exponent as E[n, p] = alpha_n + M_n . Zb_p + static_p
// over the upper pairs p = (j <= k).  This kernel computes that VJP the
// same way (ref.py::psi2_vjp_products is its arithmetic in plain torch):
//
//     A = [2 mu'/D, -1/D (feature by feature), alpha, 1]     (n, 2q + 2)
//     B = [zbar', zbar'^2 (feature by feature), 1, static]  (pairs, 2q + 2)
//     E = A B^T,  G = sf2^2 g_p exp(E),  F = w G
//     H = G B     the rows' sums: sum G zbar', sum G zbar'^2, sum G
//     Q = F^T A   the pairs' sums: sum F 2 mu'/D, -sum F / D, ., sum F
//
// with D = l^2 + 2 s, mu' = mu - c and zbar' = (z_j + z_k) / 2 - c for c the
// mean of z, alpha = -1/2 sum log1p(2 s / l^2) - sum mu'^2 / D, static =
// -1/4 sum (z_j - z_k)^2 / l^2 and g_p = g_jk + g_kj (g_jj on the
// diagonal).  The gradients of mu, s, w, log_ell and log_sf2 follow per row
// from H, those of z and log_ell's static part per pair from Q.
//
// What bounds it on the H100: operations, O(n m^2 q): the three products
// (2 (2q + 2) FLOPs each a (row, pair)) and one exp a (row, pair).  The
// design:
//   * Each (row, pair)'s exponent and exp are formed once, whatever q: E
//     accumulates over the column chunks of A and B, G stays in registers
//     for H and goes to shared memory as F for Q.
//   * The products run on the FP64 tensor cores (mma.sync m16n8k4 f64,
//     DMMA: Hopper has no f64 wgmma).  H takes its A operand straight
//     from E's accumulators: a lane's two columns of an 8-pair tile are
//     two k-steps of H's product (the pairs' order within k is free).
//   * The centre c cancels in E (the VJP is invariant to it, as the
//     forward's centred exponent), so the expansion of (mu' - zbar')^2
//     cancels no more than the spread of z and mu allows.
//   * Work items are (64-row tile, 8 x 8-point patch of the upper pairs),
//     row tile major; block b takes items [b T / S, (b + 1) T / S) of the
//     T, with S = two blocks an SM (one past q 15), so every SM gets an
//     equal share of the 4,096-slot items.  Only the diagonal patches
//     carry pairs below the diagonal (zero cotangent), 7 / m of the slots.
//   * Every sum has an owner and a fixed order, no atomics (bitwise
//     repeatable): H accumulates in registers over a row tile's patches
//     and goes to the block's partial of that row tile (two halves, one a
//     warp row), summed over the blocks in order by psi2b_rows_out; Q is
//     complete after the item (k = its 64 rows), turned into point sums
//     (8 pairs a point and feature, a thread each) and added into the
//     block's partial of d z and d log_ell, summed in order by
//     psi2b_reduce.
//   * Any n, m and q: rows past n and points past m are masked (zero G,
//     never written); past q 15 (WIDE) A and B are staged 32 columns at a
//     time, E over the chunks, H and Q chunk by chunk in reverse order
//     (the static column's chunk first), H added into the partial after
//     each item.  Shared memory is fixed.
//   * f32 inputs are computed in f64 (the same template; the tensor
//     cores' f32 path is TF32) and their row outputs rounded to f32.
//   * The hyper-parameters are read as the log values the caller holds,
//     on the card; ragged m is masked in the kernel.
//
// C interface, bound with ctypes from
// src/repro_torch/kernels/psi_stats/kernel.py.
#include <cuda_runtime.h>

namespace {

constexpr int RT = 64;       // rows a tile
constexpr int PB = 8;        // patch edge: an item's pairs are 8 x 8 points
constexpr int PT = PB * PB;  // pairs an item
constexpr int NT = 256;      // threads per block, 8 warps
constexpr int KC = 32;       // columns of A and B a chunk (16 features)
constexpr int LDA = KC + 4;  // row stride of A's and Q's tiles (4 mod 16)
constexpr int LDB = PT + 4;  // row stride of B's and F's tiles (4 mod 16)

// 2^(j/32), j = 0..31, as hi + lo (the forward's table, psi_stats.cu).
__constant__ double kExp2Frac[64] = {
    0x1.0000000000000p+0, 0x1.059b0d3158574p+0, 0x1.0b5586cf9890fp+0, 0x1.11301d0125b51p+0,
    0x1.172b83c7d517bp+0, 0x1.1d4873168b9aap+0, 0x1.2387a6e756238p+0, 0x1.29e9df51fdee1p+0,
    0x1.306fe0a31b715p+0, 0x1.371a7373aa9cbp+0, 0x1.3dea64c123422p+0, 0x1.44e086061892dp+0,
    0x1.4bfdad5362a27p+0, 0x1.5342b569d4f82p+0, 0x1.5ab07dd485429p+0, 0x1.6247eb03a5585p+0,
    0x1.6a09e667f3bcdp+0, 0x1.71f75e8ec5f74p+0, 0x1.7a11473eb0187p+0, 0x1.82589994cce13p+0,
    0x1.8ace5422aa0dbp+0, 0x1.93737b0cdc5e5p+0, 0x1.9c49182a3f090p+0, 0x1.a5503b23e255dp+0,
    0x1.ae89f995ad3adp+0, 0x1.b7f76f2fb5e47p+0, 0x1.c199bdd85529cp+0, 0x1.cb720dcef9069p+0,
    0x1.d5818dcfba487p+0, 0x1.dfc97337b9b5fp+0, 0x1.ea4afa2a490dap+0, 0x1.f50765b6e4540p+0,
    0x0.0p+0, 0x1.d73e2a475b465p-55, 0x1.8a62e4adc610bp-54, -0x1.6c51039449b3ap-54,
    -0x1.19041b9d78a76p-55, 0x1.e016e00a2643cp-54, 0x1.9b07eb6c70573p-54, 0x1.612e8afad1255p-55,
    0x1.6f46ad23182e4p-55, -0x1.63aeabf42eae2p-54, 0x1.ada0911f09ebcp-55, 0x1.89b7a04ef80d0p-59,
    0x1.d4397afec42e2p-56, -0x1.07abe1db13cadp-55, 0x1.6324c054647adp-54, -0x1.383c17e40b497p-54,
    -0x1.bdd3413b26456p-54, -0x1.16e4786887a99p-55, -0x1.41577ee04992fp-55, -0x1.d4c1dd41532d8p-54,
    0x1.6e9f156864b27p-54, -0x1.75fc781b57ebcp-57, 0x1.c7c46b071f2bep-56, -0x1.d2f6edb8d41e1p-54,
    0x1.7a1cd345dcc81p-54, -0x1.5584f7e54ac3bp-56, 0x1.11065895048ddp-55, 0x1.503cbd1e949dbp-56,
    0x1.2ed02d75b3707p-55, -0x1.1a5cd4f184b5cp-54, -0x1.e9c23179c2893p-54, 0x1.9d3e12dd8a18bp-54};

// The forward's exp (psi_stats.cu::exp_pair): f64, branch-free.
__device__ __forceinline__ double exp_pair(double x, const double* tab) {
  constexpr double kShift = 0x1.8p+52;
  constexpr double kInvLn2_32 = 0x1.71547652b82fep+5;
  constexpr double kLn2_32Hi = 0x1.62e42fef00000p-6;
  constexpr double kLn2_32Lo = 0x1.473de6af278edp-39;
  x = x < -750.0 ? -750.0 : x;
  const double t = fma(x, kInvLn2_32, kShift);
  const int n = __double2loint(t);
  const double nd = t - kShift;
  double r = fma(nd, -kLn2_32Hi, x);
  r = fma(nd, -kLn2_32Lo, r);
  double p = fma(r, 1.0 / 720, 1.0 / 120);
  p = fma(p, r, 1.0 / 24);
  p = fma(p, r, 1.0 / 6);
  p = fma(p, r, 0.5);
  p = fma(p, r, 1.0);
  const double hi = tab[n & 31], lo = tab[32 + (n & 31)];
  const double e = hi + fma(hi, p * r, lo);
  const int m = n >> 5, m1 = m >> 1;
  return e * __hiloint2double((m1 + 1023) << 20, 0)
           * __hiloint2double((m - m1 + 1023) << 20, 0);
}

// c (16 x 8) += a (16 x 4) b (4 x 8) in f64.  Lane l holds a[l/4][l%4] and
// a[l/4 + 8][l%4], b[l%4][l/4], c[l/4 (+8)][2(l%4) + {0, 1}].
__device__ __forceinline__ void dmma(double (&c)[4], double a0, double a1,
                                     double b) {
  asm volatile(
      "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a0), "d"(a1), "d"(b));
}

// Patch pt of the upper patches, row-major over nb point blocks: (jb, kb).
__device__ __forceinline__ void patch_of(long pt, int nb, int& jb, int& kb) {
  int rem = (int)pt;
  jb = 0;
  while (rem >= nb - jb) {
    rem -= nb - jb;
    ++jb;
  }
  kb = jb + rem;
}

// Blocks [0, row_blocks): the rows' A (n_pad, kp), zero past n and past
// column 2q + 1.  The blocks past them: each pair slot's g_p sf2^2 (zero
// below the diagonal and past m) and static term, gsp and stp (np_, 64).
// Every block computes l^2 and c (the same sums in the same order); block
// 0 writes hyp = [sf2^2, l^2 (q), c (q), 1 / l^2 (q)] and zc = z - c.
template <typename T>
__global__ void psi2b_prep(const T* __restrict__ mu, const T* __restrict__ s,
                           const T* __restrict__ z, const T* __restrict__ g,
                           const double* __restrict__ log_sf2,
                           const double* __restrict__ log_ell, int n,
                           int n_pad, int m, int q, int kp, int np_,
                           int row_blocks, double* __restrict__ hyp,
                           double* __restrict__ zc, double* __restrict__ a,
                           double* __restrict__ gsp, double* __restrict__ stp) {
  extern __shared__ double hs[];  // [2q]: l^2, c
  const int tid = threadIdx.x;
  for (int f = tid; f < q; f += blockDim.x) {
    double acc = 0.0;
    for (int j = 0; j < m; ++j) acc += (double)z[(size_t)j * q + f];
    hs[f] = exp(2.0 * log_ell[f]);
    hs[q + f] = acc / m;
  }
  __syncthreads();
  if (blockIdx.x == 0) {
    if (tid == 0) hyp[0] = exp(2.0 * log_sf2[0]);
    for (int f = tid; f < q; f += blockDim.x) {
      hyp[1 + f] = hs[f];
      hyp[1 + q + f] = hs[q + f];
      hyp[1 + 2 * q + f] = 1.0 / hs[f];
    }
    for (long e = tid; e < (long)m * q; e += blockDim.x)
      zc[e] = (double)z[e] - hs[q + e % q];
  }
  if ((int)blockIdx.x >= row_blocks) {
    const long e = (long)(blockIdx.x - row_blocks) * blockDim.x + tid;
    if (e >= (long)np_ * PT) return;
    int jb, kb;
    patch_of(e / PT, (m + PB - 1) / PB, jb, kb);
    const int p = (int)(e % PT), j = jb * PB + p / PB, k = kb * PB + p % PB;
    double gv = 0.0, st = 0.0;
    if (j <= k && k < m) {
      gv = exp(2.0 * log_sf2[0])
           * (j == k ? (double)g[(size_t)j * m + j]
                     : (double)g[(size_t)j * m + k] + (double)g[(size_t)k * m + j]);
      for (int f = 0; f < q; ++f) {
        const double d = (double)z[(size_t)j * q + f] - (double)z[(size_t)k * q + f];
        st = fma(d * d, 1.0 / hs[f], st);
      }
      st *= -0.25;
    }
    gsp[e] = gv;
    stp[e] = st;
    return;
  }
  const long i = (long)blockIdx.x * blockDim.x + tid;
  if (i >= n_pad) return;
  double* ar = a + i * kp;
  if (i >= n) {
    for (int c = 0; c < kp; ++c) ar[c] = 0.0;
    return;
  }
  double ln = 0.0, mq = 0.0;
  for (int f = 0; f < q; ++f) {
    const double sv = (double)s[i * q + f], l2 = hs[f];
    const double iv = 1.0 / (l2 + 2.0 * sv);
    const double mc = (double)mu[i * q + f] - hs[q + f];
    ln += log1p(2.0 * sv / l2);
    mq = fma(mc * mc, iv, mq);
    ar[2 * f] = 2.0 * mc * iv;
    ar[2 * f + 1] = -iv;
  }
  ar[2 * q] = -0.5 * ln - mq;
  ar[2 * q + 1] = 1.0;
  for (int c = 2 * q + 2; c < kp; ++c) ar[c] = 0.0;
}

constexpr int LDQ = KC + 2;  // row stride of Q's two halves

// Shared memory of one tile block, in doubles: A's and B's chunks, F, Q's
// two row halves, the pairs' g_p sf2^2 and sum F, the rows' weights.
constexpr int smem_elems() {
  return RT * LDA + KC * LDB + RT * LDB + 2 * PT * LDQ + 2 * PT + RT;
}

// Items [blk T / S, (blk + 1) T / S) of the T = n_rt np_ (row tile, patch)
// items, row tile major.  KN: H's and Q's 8-column tiles (kp = 8 KN) when
// A and B fit one chunk; WIDE (KN 4): kp past one chunk.  hpart (S, nrb,
// 2, RT, kp): the block's H for each row tile it touches (slot = row tile
// - its first); pz (S, m, q), pell (S, 8, q): its sums of d z and of
// d log_ell's static part.
template <typename T, int KN, bool WIDE>
__global__ void __launch_bounds__(NT, WIDE ? 1 : 2)
psi2b_tiles(const double* __restrict__ a, const T* __restrict__ w,
            const double* __restrict__ zc, const double* __restrict__ gsp,
            const double* __restrict__ stp, const double* __restrict__ hyp,
            int n, int m, int q, int kp, int np_, long items, int nrb,
            double* __restrict__ hpart, double* __restrict__ pz,
            double* __restrict__ pell) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ double e2f[64];
  double* as = reinterpret_cast<double*>(smem_raw);  // [RT][LDA]  A chunk
  double* bs = as + RT * LDA;                        // [KC][LDB]  B chunk
  double* fs = bs + KC * LDB;                        // [RT][LDB]  F
  double* q0 = fs + RT * LDB;                        // [PT][LDQ]  Q, rows 0-31
  double* q1 = q0 + PT * LDQ;                        // [PT][LDQ]  Q, rows 32-63
  double* gst = q1 + PT * LDQ;                       // [PT]  g_p sf2^2
  double* dst = gst + PT;                            // [PT]  sum F
  double* ws = dst + PT;                             // [RT]  w

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g8 = lane >> 2, t4 = lane & 3;
  const int wr = (warp & 3) * 16, kh = warp >> 2, wp = kh * 32;
  if (tid < 64) e2f[tid] = kExp2Frac[tid];
  const int blk = blockIdx.x, nblk = gridDim.x;
  const long lo = (long)blk * items / nblk, hi = (long)(blk + 1) * items / nblk;
  const double* il2 = hyp + 1 + 2 * q;
  const int nb = (m + PB - 1) / PB, nkc = WIDE ? (kp + KC - 1) / KC : 1;
  const int scol = 2 * q + 1 - (nkc - 1) * KC;  // sum F's column, last chunk
  double* pzb = pz + (size_t)blk * m * q;
  for (long e = tid; e < (long)m * q; e += NT) pzb[e] = 0.0;
  if (WIDE)
    for (int e = tid; e < PB * q; e += NT) pell[(size_t)blk * PB * q + e] = 0.0;
  const long rt_lo = lo / np_;
  // the point-sum thread: side 0 a point as j (its 8 pairs (j, k); on a
  // diagonal patch as k too), side 1 as k; point pa of the side, feature fl
  const int side = tid >> 7, pa = (tid >> 4) & 7, fl = tid & 15;
  double el_acc = 0.0;  // d log_ell's static part, feature fl (not WIDE)

  double hacc[KN][4];  // H: rows wr + g8 (+8), columns hn 8 + 2 t4 (+1)
  auto zero_h = [&]() {
#pragma unroll
    for (int hn = 0; hn < KN; ++hn)
#pragma unroll
      for (int i = 0; i < 4; ++i) hacc[hn][i] = 0.0;
  };
  // H's columns c0 .. c0 + kw into the block's partial of row tile rt.
  auto flush = [&](long rt, int c0, int kw, bool add) {
    double* hp = hpart + (((size_t)blk * nrb + (rt - rt_lo)) * 2 + kh) * RT * kp;
#pragma unroll
    for (int hn = 0; hn < KN; ++hn)
      if (!WIDE || hn * 8 < kw)
#pragma unroll
        for (int i = 0; i < 4; i += 2) {
          double2* d = reinterpret_cast<double2*>(
              hp + (size_t)(wr + g8 + (i >> 1) * 8) * kp + c0 + hn * 8 + 2 * t4);
          double2 v = make_double2(hacc[hn][i], hacc[hn][i + 1]);
          if (add) {
            const double2 o = *d;
            v.x += o.x;
            v.y += o.y;
          }
          *d = v;
        }
  };
  zero_h();

  long cur = -1;
  int jb = 0, kb = 0;
  if (lo < hi) patch_of(lo % np_, nb, jb, kb);
  for (long item = lo; item < hi; ++item) {
    const long rt = item / np_, pt = item - rt * np_;
    if (item > lo) {  // the next patch, row-major over the upper blocks
      if (pt == 0) {
        jb = kb = 0;
      } else if (++kb == nb) {
        kb = ++jb;
      }
    }
    const bool diag = jb == kb, fresh = rt != cur;
    // The previous item's reads of As, Bs, Fs, gst and ws are behind its
    // barriers: this item may restage them.
    if (fresh) {
      if (!WIDE && cur >= 0) flush(cur, 0, kp, false);
      zero_h();
      cur = rt;
      for (int r = tid; r < RT; r += NT)
        ws[r] = rt * RT + r < n ? (double)w[rt * RT + r] : 0.0;
    }
    auto stage_a = [&](int kc) {
      const int kw = WIDE ? min(KC, kp - kc * KC) : 8 * KN;
#pragma unroll
      for (int it = 0; it < RT * kw / NT; ++it) {
        const int e = tid + it * NT, r = e / kw, c = e % kw;
        as[r * LDA + c] = a[(size_t)(cur * RT + r) * kp + kc * KC + c];
      }
    };
    // B's chunk kc for this patch: pair p = (jb 8 + p / 8, kb 8 + p % 8).
    auto build_b = [&](int kc) {
      const int kw = WIDE ? min(KC, kp - kc * KC) : 8 * KN;
#pragma unroll
      for (int it = 0; it < kw * PT / NT; ++it) {
        const int e = tid + it * NT, c = e / PT, p = e % PT, col = kc * KC + c;
        const int j = jb * PB + p / PB, k = kb * PB + p % PB;
        double v = 0.0;
        if (col == 2 * q) {
          v = 1.0;
        } else if (col == 2 * q + 1) {
          v = stp[pt * PT + p];
        } else if (col < 2 * q && k < m) {
          const int f = col >> 1;
          const double zb = 0.5 * (zc[(size_t)j * q + f] + zc[(size_t)k * q + f]);
          v = col & 1 ? zb * zb : zb;
        }
        bs[c * LDB + p] = v;
      }
    };
    if (tid < PT) gst[tid] = gsp[pt * PT + tid];
    if (!WIDE && fresh) stage_a(0);

    // this item's point sum, fetched early (the last item's stores are
    // behind the barrier after B's build)
    const int point = (side == 0 ? jb : kb) * PB + pa;
    const bool mine = fl < q && point < m && (side == 0 || !diag);
    double pold = 0.0;

    // Q = F^T A for chunk kc (warp: pairs wr .. wr + 16, rows kh 32 .. +
    // 32, into its half's buffer), then the chunk's features' point sums
    // added into the block's partial.
    auto pairs_pass = [&](int kc) {
      const int kw = WIDE ? min(KC, kp - kc * KC) : 8 * KN;
      if (kc == nkc - 1) __syncthreads();  // F
      double qa[KN][4];
#pragma unroll
      for (int qn = 0; qn < KN; ++qn)
#pragma unroll
        for (int i = 0; i < 4; ++i) qa[qn][i] = 0.0;
#pragma unroll
      for (int k0 = 0; k0 < 32; k0 += 4) {
        const int r = kh * 32 + k0 + t4;
        const double a0 = fs[r * LDB + wr + g8], a1 = fs[r * LDB + wr + g8 + 8];
#pragma unroll
        for (int qn = 0; qn < KN; ++qn)
          if (!WIDE || qn * 8 < kw) dmma(qa[qn], a0, a1, as[r * LDA + qn * 8 + g8]);
      }
      double* qh = kh == 0 ? q0 : q1;
#pragma unroll
      for (int qn = 0; qn < KN; ++qn)
        if (!WIDE || qn * 8 < kw)
#pragma unroll
          for (int i = 0; i < 4; i += 2)
            *reinterpret_cast<double2*>(qh + (wr + g8 + (i >> 1) * 8) * LDQ + qn * 8 + 2 * t4) =
                make_double2(qa[qn][i], qa[qn][i + 1]);
      __syncthreads();
      if (WIDE && kc == nkc - 1 && tid < PT) dst[tid] = q0[tid * LDQ + scol] + q1[tid * LDQ + scol];
      const int f = kc * 16 + fl;
      if (f < q && point < m && (side == 0 || !diag)) {
        const double zp = zc[(size_t)point * q + f], il = il2[f];
        double acc = 0.0, el = 0.0;
        // sgn -1: the point as j of pair p (partner zo), +1: as k
        auto term = [&](int p, double zo, double sgn) {
          const double zj = sgn < 0 ? zp : zo, zk = sgn < 0 ? zo : zp;
          const double zb = 0.5 * (zj + zk), d = zj - zk;
          const double dzb = fma(2.0 * zb, q0[p * LDQ + 2 * fl + 1] + q1[p * LDQ + 2 * fl + 1],
                                 q0[p * LDQ + 2 * fl] + q1[p * LDQ + 2 * fl]);
          const double sumf = WIDE && kc < nkc - 1 ? dst[p]
                                                   : q0[p * LDQ + scol] + q1[p * LDQ + scol];
          const double u = 0.5 * sumf * d * il;
          acc += fma(0.5, dzb, sgn * u);
          if (sgn < 0) el = fma(u, d, el);
        };
        if (side == 0) {
#pragma unroll
          for (int o = 0; o < PB; ++o) {  // pairs (point, kb 8 + o)
            const int k = kb * PB + o;
            if ((!diag || o >= pa) && k < m) term(pa * PB + o, zc[(size_t)k * q + f], -1.0);
          }
        }
        if (side == 1 || diag) {
#pragma unroll
          for (int o = 0; o < PB; ++o)  // pairs (jb 8 + o, point)
            if (!diag || o <= pa) term(o * PB + pa, zc[(size_t)(jb * PB + o) * q + f], 1.0);
        }
        const size_t at = (size_t)point * q + f;
        pzb[at] = (WIDE ? pzb[at] : pold) + acc;
        if (side == 0) {
          if (WIDE) pell[((size_t)blk * PB + pa) * q + f] += el;
          else el_acc += el;
        }
      }
    };

    // E = A B^T, G = g_p sf2^2 exp(E) (zero past n) and H += G B, for the
    // warp's 32 pairs in NH parts of NE 8-pair tiles (two when A and B
    // fit one chunk: half E's registers; WIDE: one, its H chunk by
    // chunk, the last (with sum F's column) first, each with its Q).
    constexpr int NH = WIDE ? 1 : 2, NE = 4 / NH;
#pragma unroll
    for (int nh = 0; nh < NH; ++nh) {
      double e[NE][4];
#pragma unroll
      for (int nt = 0; nt < NE; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) e[nt][i] = 0.0;
      for (int kc = 0; kc < nkc; ++kc) {
        if (nh == 0) {
          if (WIDE) {
            if (kc > 0) __syncthreads();  // the last chunk's products are done
            stage_a(kc);
          }
          build_b(kc);
          __syncthreads();
          if (!WIDE && mine) pold = pzb[(size_t)point * q + fl];
        }
        const int kw = WIDE ? min(KC, kp - kc * KC) : 8 * KN;
#pragma unroll
        for (int k0 = 0; k0 < kw; k0 += 4) {
          const double a0 = as[(wr + g8) * LDA + k0 + t4];
          const double a1 = as[(wr + g8 + 8) * LDA + k0 + t4];
#pragma unroll
          for (int nt = 0; nt < NE; ++nt)
            dmma(e[nt], a0, a1, bs[(k0 + t4) * LDB + wp + (nh * NE + nt) * 8 + g8]);
        }
      }
      // G in e; F = w G to shared memory
#pragma unroll
      for (int nt = 0; nt < NE; ++nt)
#pragma unroll
        for (int i = 0; i < 4; i += 2) {
          const int r = wr + g8 + (i >> 1) * 8, p = wp + (nh * NE + nt) * 8 + 2 * t4;
          const bool ok = cur * RT + r < n;
          const double g0 = ok ? gst[p] * exp_pair(e[nt][i], e2f) : 0.0;
          const double g1 = ok ? gst[p + 1] * exp_pair(e[nt][i + 1], e2f) : 0.0;
          e[nt][i] = g0;
          e[nt][i + 1] = g1;
          *reinterpret_cast<double2*>(fs + r * LDB + p) = make_double2(ws[r] * g0, ws[r] * g1);
        }
      for (int kc = nkc - 1; kc >= 0; --kc) {
        const int kw = WIDE ? min(KC, kp - kc * KC) : 8 * KN;
        if (WIDE && kc < nkc - 1) {
          stage_a(kc);
          build_b(kc);
          __syncthreads();
        }
        // H += G B: k-steps of an 8-pair tile are its lanes' even and odd
        // pairs, straight from E's accumulators
#pragma unroll
        for (int hn = 0; hn < KN; ++hn)
          if (!WIDE || hn * 8 < kw)
#pragma unroll
            for (int nt = 0; nt < NE; ++nt) {
              const double* b = bs + (hn * 8 + g8) * LDB + wp + (nh * NE + nt) * 8 + 2 * t4;
              dmma(hacc[hn], e[nt][0], e[nt][2], b[0]);
              dmma(hacc[hn], e[nt][1], e[nt][3], b[1]);
            }
        if (WIDE) {
          flush(cur, kc * KC, kw, !fresh);
          zero_h();
          pairs_pass(kc);
        }
      }
    }
    if (!WIDE) pairs_pass(0);
  }
  if (!WIDE && cur >= 0) flush(cur, 0, kp, false);
  if (!WIDE && side == 0 && fl < q) pell[((size_t)blk * PB + pa) * q + fl] = el_acc;
}

// Per (row, feature): H summed over the blocks that hold its row tile (in
// block order, each block's two halves in order); the row outputs (flags:
// 1 d mu, 2 d s, 4 d w) and the row's terms of d log_ell and d log_sf2,
// into rterm (n, q + 1).
template <typename T>
__global__ void psi2b_rows_out(const double* __restrict__ hpart,
                               const T* __restrict__ mu, const T* __restrict__ s,
                               const T* __restrict__ w,
                               const double* __restrict__ hyp, int n, int q,
                               int kp, int np_, long items, int nblk, int nrb,
                               int flags, T* __restrict__ dmu,
                               T* __restrict__ ds, T* __restrict__ dw,
                               double* __restrict__ rterm) {
  const long t = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long)n * q) return;
  const long i = t / q, rt = i / RT;
  const int f = (int)(t % q), r = (int)(i % RT);
  // the blocks of the row tile's first and last items; the first holds it
  // in its slot s_lo, every later one in its slot 0
  const long b_lo = ((rt * np_ + 1) * nblk - 1) / items;
  const long b_hi = ((rt + 1) * np_ * nblk - 1) / items;
  const long s_lo = rt - (b_lo * items / nblk) / np_;
  const size_t half = (size_t)RT * kp, per_block = (size_t)nrb * 2 * half;
  const double* first = hpart + b_lo * per_block + s_lo * 2 * half + (size_t)r * kp;
  const double* later = hpart + (size_t)r * kp;
  auto h = [&](int c) {
    double acc = first[c] + first[c + half];
    for (long b = b_lo + 1; b <= b_hi; ++b) {
      const double* hp = later + b * per_block + c;
      acc += hp[0];
      acc += hp[half];
    }
    return acc;
  };
  const double wi = (double)w[i], h0 = h(2 * q);
  if (f == 0) {
    if (flags & 4) dw[i] = (T)h0;
    rterm[i * (q + 1) + q] = 2.0 * wi * h0;
  }
  const double h1 = h(2 * f), h2 = h(2 * f + 1);
  const double l2 = hyp[1 + f], sv = (double)s[t];
  const double iv = 1.0 / (l2 + 2.0 * sv);
  const double mc = (double)mu[t] - hyp[1 + q + f];
  const double sr2 = fma(mc, fma(mc, h0, -2.0 * h1), h2);  // sum G r^2
  if (flags & 1) dmu[t] = (T)(2.0 * wi * iv * fma(-mc, h0, h1));
  if (flags & 2) ds[t] = (T)(wi * iv * fma(2.0 * iv, sr2, -h0));
  rterm[i * (q + 1) + f] = wi * iv * (2.0 * sv * h0 + 2.0 * l2 * iv * sr2);
}

// Fixed-order sums: blocks [0, q) d log_ell (the rows' terms and the
// blocks' static terms), block q d log_sf2 (each a tree over 256 strided
// sums), the rest d z (32 entries a block over the blocks' partials).
__global__ void psi2b_reduce(const double* __restrict__ rterm,
                             const double* __restrict__ pz,
                             const double* __restrict__ pell, int nblk, int n,
                             int m, int q, double* __restrict__ dz,
                             double* __restrict__ dell,
                             double* __restrict__ dsf2) {
  __shared__ double sh[256];
  const int blk = blockIdx.x, tid = threadIdx.x;
  if (blk <= q) {
    double acc = 0.0;
#pragma unroll 8
    for (long i = tid; i < n; i += blockDim.x) acc += rterm[i * (q + 1) + blk];
    if (blk < q) {
#pragma unroll 8
      for (long b = tid; b < (long)nblk * PB; b += blockDim.x) acc += pell[b * q + blk];
    }
    sh[tid] = acc;
    __syncthreads();
    for (int o = 128; o > 0; o >>= 1) {
      if (tid < o) sh[tid] += sh[tid + o];
      __syncthreads();
    }
    if (tid == 0) *(blk == q ? dsf2 : dell + blk) = sh[0];
    return;
  }
  // d z: 32 consecutive entries a block, warp w the partials w, w + 8,
  // ..., then warp 0 adds the 8 warps' sums in order
  const int lane = tid & 31, w = tid >> 5;
  const long e = (long)(blk - q - 1) * 32 + lane;
  const long mq = (long)m * q;
  double acc = 0.0;
  if (e < mq) {
#pragma unroll 4
    for (int b = w; b < nblk; b += 8) acc += pz[(size_t)b * mq + e];
  }
  sh[tid] = acc;
  __syncthreads();
  if (w == 0 && e < mq) {
    double t = 0.0;
    for (int k = 0; k < 8; ++k) t += sh[k * 32 + lane];
    dz[e] = t;
  }
}

static_assert(smem_elems() * sizeof(double) * 2 + 2 * 1024 <= 233472,
              "two blocks an SM over sm_90's 228 KB");

template <typename T>
int launch(const T* mu, const T* s, const T* w, const T* z, const T* g,
           const double* log_sf2, const double* log_ell, int n, int m, int q,
           int nblk, int nrb, int flags, double* scratch, double* dz,
           double* dell, double* dsf2, T* dmu, T* ds, T* dw, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int kp = (2 * q + 2 + 7) / 8 * 8;
  const int n_rt = (n + RT - 1) / RT, n_pad = n_rt * RT;
  const int nb = (m + PB - 1) / PB, np_ = nb * (nb + 1) / 2;
  const long items = (long)n_rt * np_;
  double* next = scratch;
  auto take = [&](size_t count) {  // 32-byte aligned regions
    double* p = next;
    next += (count + 3) / 4 * 4;
    return p;
  };
  double* hyp = take(1 + 3 * q);
  double* zc = take((size_t)m * q);
  double* a = take((size_t)n_pad * kp);
  double* gsp = take((size_t)np_ * PT);
  double* stp = take((size_t)np_ * PT);
  double* hpart = take((size_t)nblk * nrb * 2 * RT * kp);
  double* pz = take((size_t)nblk * m * q);
  double* pell = take((size_t)nblk * PB * q);
  double* rterm = take((size_t)n * (q + 1));
  // the tile kernel for kp: 8, 16, 24 or 32 columns in one chunk, or WIDE
  const int variant = kp > KC ? 4 : kp / 8 - 1;
  void (*const kernels[5])(const double*, const T*, const double*, const double*,
                           const double*, const double*, int, int, int, int, int,
                           long, int, double*, double*, double*) = {
      psi2b_tiles<T, 1, false>, psi2b_tiles<T, 2, false>, psi2b_tiles<T, 3, false>,
      psi2b_tiles<T, 4, false>, psi2b_tiles<T, 4, true>};
  auto kernel = kernels[variant];
  const int smem = (int)(smem_elems() * sizeof(double));
  static bool ready[64][5] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || !ready[dev][variant]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    if (dev < 64) ready[dev][variant] = true;
  }
  const int row_blocks = (n_pad + 255) / 256;
  const int pair_blocks = (np_ * PT + 255) / 256;
  psi2b_prep<T><<<(unsigned)(row_blocks + pair_blocks), 256, 2 * q * sizeof(double), st>>>(
      mu, s, z, g, log_sf2, log_ell, n, n_pad, m, q, kp, np_, row_blocks, hyp, zc, a,
      gsp, stp);
  kernel<<<(unsigned)nblk, NT, smem, st>>>(a, w, zc, gsp, stp, hyp, n, m, q, kp, np_,
                                           items, nrb, hpart, pz, pell);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (n > 0)
    psi2b_rows_out<T><<<(unsigned)(((long)n * q + 255) / 256), 256, 0, st>>>(
        hpart, mu, s, w, hyp, n, q, kp, np_, items, nblk, nrb, flags, dmu, ds,
        dw, rterm);
  const long mq = (long)m * q;
  psi2b_reduce<<<(unsigned)(q + 1 + (mq + 31) / 32), 256, 0, st>>>(
      rterm, pz, pell, nblk, n, m, q, dz, dell, dsf2);
  return cudaGetLastError();
}

}  // namespace

// mu, s (n, q), w (n,), z (m, q), g (m, m) in one dtype; log_sf2 (),
// log_ell (q,) in f64.  nblk blocks (at least one) take equal shares of
// the (64-row tile, 8 x 8-point patch) items; nrb row tiles a block at
// most.  scratch (f64), each region rounded up to 4 elements: hyp (1 +
// 3q), zc (m q), A (n_pad kp), gsp and stp (np 64 each, np the upper 8 x 8
// patches), hpart (nblk nrb 2 64 kp), pz (nblk m q), pell (nblk 8 q), rterm
// (n (q + 1)), with
// n_pad = 64 ceil(n / 64) and kp = 8 ceil((2q + 2) / 8).  Outputs (f64):
// dz (m, q), dell (q), dsf2 (); when flags asks (1, 2, 4), dmu, ds (n, q)
// and dw (n) in the input dtype.  Any n, m and q.  Returns
// cudaGetLastError().
extern "C" int psi2_bwd_f64(const double* mu, const double* s, const double* w,
                            const double* z, const double* g,
                            const double* log_sf2, const double* log_ell,
                            int n, int m, int q, int nblk, int nrb, int flags,
                            double* scratch, double* dz, double* dell,
                            double* dsf2, double* dmu, double* ds, double* dw,
                            void* stream) {
  return launch<double>(mu, s, w, z, g, log_sf2, log_ell, n, m, q, nblk, nrb,
                        flags, scratch, dz, dell, dsf2, dmu, ds, dw, stream);
}

extern "C" int psi2_bwd_f32(const float* mu, const float* s, const float* w,
                            const float* z, const float* g,
                            const double* log_sf2, const double* log_ell,
                            int n, int m, int q, int nblk, int nrb, int flags,
                            double* scratch, double* dz, double* dell,
                            double* dsf2, float* dmu, float* ds, float* dw,
                            void* stream) {
  return launch<float>(mu, s, w, z, g, log_sf2, log_ell, n, m, q, nblk, nrb,
                       flags, scratch, dz, dell, dsf2, dmu, ds, dw, stream);
}
