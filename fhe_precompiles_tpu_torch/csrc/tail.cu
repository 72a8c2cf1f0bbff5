// The five BEHZ tail kernels of BFV multiply + relinearize, for Hopper (sm_90a).
//
// Each kernel is one inter-NTT segment of the multiply pipeline and replaces
// one Pallas TPU kernel of fhe_precompiles_tpu/ops/pallas_tail.py:
//
//   to_bsk_ext_kernel   PairTailPallas.to_bsk_ext  (_to_bsk_kern)
//   dyadic_kernel       PairTailPallas.dyadic      (_dyadic_kern)
//   floor_sk_kernel     PairTailPallas.floor_sk    (_floor_sk_kern)
//   relin_dot_kernel    PairTailPallas.relin_dot   (_relin_dot_kern)
//   mod_down_kernel     PairTailPallas.mod_down    (_mod_down_kern)
//
// All five are pointwise along the coefficient axis n (no traffic between
// coefficient positions), and each reads every input word once and writes
// every output word once.
//
// to_bsk_ext, dyadic, relin_dot and mod_down keep the first design: one
// thread per coefficient position, with n the contiguous axis, so a warp
// reads 32 neighbouring 8-byte words; the limb loops run in registers inside
// the thread, unrolled to the maximum limb counts and predicated on the real
// ones; products are 64-bit integer Shoup and Barrett steps.  Each of the
// four runs at half its bytes bound or better on an H100, with a few dozen
// integer operations a word, so nothing more is done for them.
//
// floor_sk does far more arithmetic a word.  Its first design formed 20
// beta = 64 Shoup products and 8 Barrett steps a position at testnet.one
// (1,616 instructions in the body, 687 of them IMAD) and took twice the time
// of a kernel that only moves its words: it was bound by instruction issue.
// Its design now cuts the instructions, to about a fifth:
//   * compile-time limb counts: one instance for each (k, |Bsk|) pair, so no
//     loop body is predicated off and every constant index is fixed;
//   * the products on the FP64 pipe: the reference's beta = 40 Shoup product
//     formed exactly in doubles (csrc/modmath.cuh, shoup40_d), about 7
//     instructions where the 64-bit integer product takes about 18; a value
//     is turned into a double once and every sum stays a double;
//   * the reference's lazy reductions, and fewer of them: the constants of
//     consecutive products are folded on the host (q^-1 b_hat_inv_j into the
//     y2 sums, the m_sk limb's FastFloor into alpha; 17 products a position
//     at testnet.one), each sum of lazy terms is made canonical by the
//     conditional subtracts its stated bound needs, and alpha mod q_i takes
//     the reference's steps_msk_mod_q conditional subtracts (one Barrett
//     step where that count is large);
//   * wider threads: two neighbouring positions a thread, 16-byte loads and
//     stores, all limbs of a row loaded before any arithmetic, 32-bit offsets
//     inside a row.
// On an H100 it now takes the time of the copy-only kernel: the memory
// system bounds it.  The comment at each step of floor_sk_at states its
// bound.
//
// blockIdx.x covers the positions and blockIdx.y (or z) the rows, so no
// thread divides to find its place; a thread loops only when there are more
// rows than a grid dimension holds.  Per-limb constants arrive in one plain
// struct passed by value (constant bank), with fixed maximum limb counts, so
// that one binary serves every parameter preset.
//
// Plain C interface: every launcher takes raw device pointers and the stream,
// launches without synchronising, and returns cudaGetLastError().
#include <cuda_runtime.h>
#include "modmath.cuh"

#define MAX_K 3      // ciphertext limbs
#define MAX_BSK 5    // aux base B plus m_sk
#define MAX_KEY 4    // key limbs (ciphertext limbs + special prime)
#define THREADS 256
#define RELIN_ROWS 8 // batch rows that share one read of the relin key

// one constant factor of floor_sk's products: w, and its beta = 40 Shoup word
// floor(w * 2^40 / p) scaled by 2^-40, both exact as doubles
struct Shoup40 {
    double w, ws;
};

struct TailParams {
    int32_t k, nbsk, k_key;
    int32_t steps_msk_mod_q;                  // max((m_sk - 1) // q_i)
    u64 mt;                                   // m_tilde, a power of two
    u64 q[MAX_K], q_mu[MAX_K];
    u64 bsk[MAX_BSK], bsk_mu[MAX_BSK];        // bsk[nbsk-1] is m_sk
    u64 key[MAX_KEY], key_mu[MAX_KEY];
    // to_bsk_ext
    u64 mt_qhinv[MAX_K], mt_qhinv_s[MAX_K];   // |m_tilde * q_hat_inv_i|_{q_i}
    u64 qhat_bsk[MAX_BSK][MAX_K], qhat_bsk_s[MAX_BSK][MAX_K];
    u64 qhat_mt[MAX_K];                       // q_hat_i mod m_tilde
    u64 neg_inv_q_mt;                         // -q^-1 mod m_tilde
    u64 q_mod_bsk[MAX_BSK], q_mod_bsk_s[MAX_BSK];
    u64 inv_mt_bsk[MAX_BSK], inv_mt_bsk_s[MAX_BSK];
    // floor_sk: the moduli as doubles and the folded factors (floor_sk_at)
    double q_d[MAX_K], bsk_d[MAX_BSK];
    double msk_half_p1;                       // m_sk // 2 + 1
    Shoup40 fs_y2[MAX_BSK - 1][MAX_K + 1];    // [j][i < k]: y_i, [j][k]: x_j
    Shoup40 fs_alpha[MAX_BSK + MAX_K];        // y2_j (j < nB), x_msk, y_i
    Shoup40 fs_out[MAX_K][MAX_BSK - 1];       // b_hat_j mod q_i
    Shoup40 fs_corr[MAX_K][2];                // -prod(B), +prod(B) mod q_i
    // mod_down
    u64 P, P_half;
    u64 half_mod_q[MAX_K];
    u64 inv_P_q[MAX_K], inv_P_q_s[MAX_K];
};

// ---------------------------------------------------------------------------
// to_bsk_ext: (rows, k, n) -> (rows, k + nbsk, n).  Copies the q limbs and
// appends the lift into Bsk (FastBconv + the m_tilde Montgomery correction,
// centred).  The m_tilde row is mask arithmetic on the low bits.
// ---------------------------------------------------------------------------
// one coefficient position: ap / op point at limb 0, limbs are n words apart
__device__ __forceinline__ void to_bsk_ext_at(const u64* __restrict__ ap,
                                              u64* __restrict__ op, int n,
                                              const TailParams& c) {
    const u64 mask = c.mt - 1;
    u64 y[MAX_K];
    u64 acc_mt = 0;
#pragma unroll
    for (int i = 0; i < MAX_K; ++i) {
        if (i < c.k) {
            u64 ai = ap[(long long)i * n];
            op[(long long)i * n] = ai;
            y[i] = mul_shoup(ai, c.mt_qhinv[i], c.mt_qhinv_s[i], c.q[i]);
            acc_mt += (y[i] & mask) * c.qhat_mt[i];
        }
    }
    const u64 r = ((acc_mt & mask) * c.neg_inv_q_mt) & mask;
    const bool big = r > (c.mt >> 1);
#pragma unroll
    for (int j = 0; j < MAX_BSK; ++j) {
        if (j < c.nbsk) {
            const u64 p = c.bsk[j];
            u64 acc = 0;                       // k lazy terms, each < 2p
#pragma unroll
            for (int i = 0; i < MAX_K; ++i)
                if (i < c.k)
                    acc += mul_shoup_lazy(y[i], c.qhat_bsk[j][i],
                                          c.qhat_bsk_s[j][i], p);
            u64 conv = barrett(acc, p, c.bsk_mu[j]);
            // centred r modulo bsk_j: r - m_tilde when r > m_tilde / 2
            u64 rm = big ? p - (c.mt - r) : r;
            u64 num = addmod(conv, mul_shoup(rm, c.q_mod_bsk[j],
                                             c.q_mod_bsk_s[j], p), p);
            op[(long long)(c.k + j) * n] =
                mul_shoup(num, c.inv_mt_bsk[j], c.inv_mt_bsk_s[j], p);
        }
    }
}

__global__ void __launch_bounds__(THREADS)
to_bsk_ext_kernel(const u64* __restrict__ a, u64* __restrict__ out,
                  long long rows, int n, const TailParams c) {
    const int pos = blockIdx.x * THREADS + threadIdx.x;
    if (pos >= n) return;
    for (long long row = blockIdx.y; row < rows; row += gridDim.y)
        to_bsk_ext_at(a + row * c.k * n + pos,
                      out + row * (c.k + c.nbsk) * n + pos, n, c);
}

// ---------------------------------------------------------------------------
// dyadic: (B, 2, nb, n) x (B, 2, nb, n) -> (B, 3, nb, n), Karatsuba over the
// 2 x 2 tensor in the NTT domain, three general products per limb.
// One thread per (limb, position), looping over its share of the batch.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(THREADS)
dyadic_kernel(const u64* __restrict__ fa, const u64* __restrict__ fb,
              u64* __restrict__ out, long long batch, int n,
              const TailParams c) {
    const int pos = blockIdx.x * THREADS + threadIdx.x;
    if (pos >= n) return;
    const int limb = blockIdx.y;
    const long long per = (long long)(c.k + c.nbsk) * n;
    const long long off = (long long)limb * n + pos;
    const u64 p = limb < c.k ? c.q[limb] : c.bsk[limb - c.k];
    const u64 mu = limb < c.k ? c.q_mu[limb] : c.bsk_mu[limb - c.k];
    for (long long b = blockIdx.z; b < batch; b += gridDim.z) {
        const u64* ap = fa + b * 2 * per + off;
        const u64* bp = fb + b * 2 * per + off;
        const u64 a0 = ap[0], a1 = ap[per], b0 = bp[0], b1 = bp[per];
        const u64 t0 = mulmod(a0, b0, p, mu);
        const u64 t2 = mulmod(a1, b1, p, mu);
        const u64 cross = mulmod(addmod(a0, a1, p), addmod(b0, b1, p), p, mu);
        u64* op = out + b * 3 * per + off;
        op[0] = t0;
        op[per] = submod(submod(cross, t0, p), t2, p);
        op[2 * per] = t2;
    }
}

// ---------------------------------------------------------------------------
// floor_sk: (rows, k + nbsk, n) -> (rows, k, n).  The input is the t-scaled
// tensor in coefficient form whose q limbs already carry the q_hat_inv
// factor.  FastBconv q -> Bsk, FastFloor (x - conv) * q^-1, then the exact
// Shenoy-Kumaresan conversion Bsk -> q with the centred alpha correction.
//
// Every product is one beta = 40 Shoup term a * w - floor(a * ws) * p of
// shoup40_d, and every input a of a product is canonical (below one of the
// path's moduli, so a < 2^37 < 2^39), so each term lies in
// [0, p * (1 + a / 2^40)), below 9p/8; a sum of T terms lies below 9T/8 * p,
// an integer far below 2^53 that the double holds exactly.
// ---------------------------------------------------------------------------
// conditional subtracts that make a sum of `terms` terms canonical: the
// least m with 2^m >= 9 * terms / 8
__host__ __device__ constexpr int csubs_for(int terms) {
    int m = 0;
    while ((8 << m) < 9 * terms) ++m;
    return m;
}

// x < 9 * TERMS / 8 * p  ->  x mod p, by subtracting 2^e p where it fits,
// e from csubs_for(TERMS) - 1 down to 0 (each step halves the bound)
template <int TERMS>
__device__ __forceinline__ double canonical(double x, double p) {
    constexpr int m = csubs_for(TERMS);
#pragma unroll
    for (int e = m - 1; e >= 0; --e)
        x = csub_d(x, p * (double)(1 << e));
    return x;
}

__device__ __forceinline__ double term(double a, const Shoup40& f, double p) {
    return shoup40_d(a, f.w, f.ws, p);
}

// the most conditional subtracts for alpha mod q_i; a larger
// steps_msk_mod_q takes one Barrett step instead
constexpr int MSK_CSUB_STEPS = 3;

// One coefficient position.  y: the k q-limbs, x: the nbsk Bsk limbs, all
// canonical, as doubles.  o: the k output limbs, canonical, as doubles.
template <int K, int NBSK>
__device__ __forceinline__ void floor_sk_at(const double (&y)[K],
                                            const double (&x)[NBSK],
                                            double (&o)[K],
                                            const TailParams& c) {
    constexpr int NB = NBSK - 1;              // the primes of B; m_sk last
    // y2_j = |fl_j * b_hat_inv_j|_{B_j} with fl_j = (x_j - FastBconv(y)_j)
    // * q^-1, folded on the host into one sum of k + 1 terms:
    //   y2_j = |x_j * c_j + sum_i y_i * w_ji|_{B_j},
    //   c_j = q^-1 b_hat_inv_j, w_ji = -q_hat_i c_j  (fs_y2[j][k], [j][i])
    double y2[NB];
#pragma unroll
    for (int j = 0; j < NB; ++j) {
        const double p = c.bsk_d[j];
        double s = term(x[j], c.fs_y2[j][K], p);
#pragma unroll
        for (int i = 0; i < K; ++i)
            s = __dadd_rn(s, term(y[i], c.fs_y2[j][i], p));
        // k + 1 terms: s < 9(k + 1)/8 B_j <= 4.5 B_j.  y2_j is summed as an
        // integer below, so it is made canonical.
        y2[j] = canonical<K + 1>(s, p);
    }

    // alpha = |(sum_j y2_j b_hat_j - fl_msk) * prod(B)^-1|_{m_sk}, with
    // fl_msk's FastFloor folded in as above: one sum of nB + 1 + k terms
    //   y2_j * b_hat_j / prod(B), x_msk * -q^-1 / prod(B),
    //   y_i * q_hat_i q^-1 / prod(B)                      (fs_alpha)
    const double msk = c.bsk_d[NB];
    double s = term(x[NB], c.fs_alpha[NB], msk);
#pragma unroll
    for (int j = 0; j < NB; ++j)
        s = __dadd_rn(s, term(y2[j], c.fs_alpha[j], msk));
#pragma unroll
    for (int i = 0; i < K; ++i)
        s = __dadd_rn(s, term(y[i], c.fs_alpha[NB + 1 + i], msk));
    // nB + 1 + k terms: s < 9(nB + 1 + k)/8 m_sk <= 9 m_sk.  The centring
    // compares alpha, so it is made canonical first.
    const double alpha = canonical<NB + 1 + K>(s, msk);
    const bool big = alpha >= c.msk_half_p1;  // alpha stands for alpha - m_sk
    const double mag = big ? __dsub_rn(msk, alpha) : alpha;   // <= m_sk / 2
    const bool by_csub = c.steps_msk_mod_q <= MSK_CSUB_STEPS;

#pragma unroll
    for (int i = 0; i < K; ++i) {
        const double p = c.q_d[i];
        // red = mag mod q_i.  mag < m_sk <= (steps_msk_mod_q + 1) q_i, so
        // that many conditional subtracts are exact (the reference's
        // csub_reduce); a large count (a small q_i) takes one Barrett step.
        double red = mag;
        if (by_csub) {
#pragma unroll
            for (int st = 0; st < MSK_CSUB_STEPS; ++st)
                if (st < c.steps_msk_mod_q) red = csub_d(red, p);
        } else {
            red = exact_double(barrett(exact_u64(mag), c.q[i], c.q_mu[i]));
        }
        // out_i = |sum_j y2_j b_hat_j - centred(alpha) prod(B)|_{q_i}: the
        // centred alpha is -red when big, +red otherwise, so the sign picks
        // +prod(B) or -prod(B) as the factor of red, and red = 0 gives 0
        const Shoup40& corr = big ? c.fs_corr[i][1] : c.fs_corr[i][0];
        double acc = term(red, corr, p);
#pragma unroll
        for (int j = 0; j < NB; ++j)
            acc = __dadd_rn(acc, term(y2[j], c.fs_out[i][j], p));
        // nB + 1 terms: acc < 9(nB + 1)/8 q_i <= 5.625 q_i
        o[i] = canonical<NB + 1>(acc, p);
    }
}

// Two neighbouring positions a thread: one 16-byte word of each limb.  n2 is
// n / 2, the row length in those words; offsets inside a row are 32-bit.
template <int K, int NBSK>
__global__ void __launch_bounds__(THREADS)
floor_sk_kernel(const ulonglong2* __restrict__ t, ulonglong2* __restrict__ out,
                long long rows, int n2, const TailParams c) {
    const int pos = blockIdx.x * THREADS + threadIdx.x;
    if (pos >= n2) return;
    for (long long row = blockIdx.y; row < rows; row += gridDim.y) {
        const ulonglong2* tp = t + row * (K + NBSK) * n2 + pos;
        ulonglong2 v[K + NBSK];
#pragma unroll
        for (int l = 0; l < K + NBSK; ++l) v[l] = tp[l * n2];
        double y0[K], y1[K], x0[NBSK], x1[NBSK], o0[K], o1[K];
#pragma unroll
        for (int i = 0; i < K; ++i) {
            y0[i] = exact_double(v[i].x);
            y1[i] = exact_double(v[i].y);
        }
#pragma unroll
        for (int j = 0; j < NBSK; ++j) {
            x0[j] = exact_double(v[K + j].x);
            x1[j] = exact_double(v[K + j].y);
        }
        floor_sk_at<K, NBSK>(y0, x0, o0, c);
        floor_sk_at<K, NBSK>(y1, x1, o1, c);
        ulonglong2* op = out + row * K * n2 + pos;
#pragma unroll
        for (int i = 0; i < K; ++i)
            op[i * n2] = make_ulonglong2(exact_u64(o0[i]), exact_u64(o1[i]));
    }
}

// ---------------------------------------------------------------------------
// relin_dot: d (B, k, k_key, n) x rk (k, 2, k_key, n) -> (B, 2, k_key, n),
// out[b, comp, l] = sum_j d[b, j, l] * rk[j, comp, l] mod key_l, all in the
// NTT domain.  A block owns one key limb, 256 positions and RELIN_ROWS batch
// rows: its threads read their 2k key words once into registers and reuse
// them for every row.  Products are kept lazy (< 2^48) and summed before one
// Barrett step.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(THREADS)
relin_dot_kernel(const u64* __restrict__ d, const u64* __restrict__ rk,
                 u64* __restrict__ out, long long batch, int n,
                 const TailParams c) {
    const int pos = blockIdx.x * THREADS + threadIdx.x;
    if (pos >= n) return;
    const int l = blockIdx.y;
    const u64 p = c.key[l], mu = c.key_mu[l];
    const long long ln = (long long)l * n + pos;
    const long long kn = (long long)c.k_key * n;

    u64 r0[MAX_K], r1[MAX_K];
#pragma unroll
    for (int j = 0; j < MAX_K; ++j) {
        if (j < c.k) {
            r0[j] = rk[(long long)(j * 2 + 0) * kn + ln];
            r1[j] = rk[(long long)(j * 2 + 1) * kn + ln];
        }
    }
    const long long b0 = (long long)blockIdx.z * RELIN_ROWS;
    for (int rr = 0; rr < RELIN_ROWS; ++rr) {
        const long long b = b0 + rr;
        if (b >= batch) break;
        u64 acc0 = 0, acc1 = 0;
#pragma unroll
        for (int j = 0; j < MAX_K; ++j) {
            if (j < c.k) {
                const u64 dj = d[(b * c.k + j) * kn + ln];
                acc0 += mul_lazy(dj, r0[j], p, mu);
                acc1 += mul_lazy(dj, r1[j], p, mu);
            }
        }
        out[(b * 2 + 0) * kn + ln] = barrett(acc0, p, mu);
        out[(b * 2 + 1) * kn + ln] = barrett(acc1, p, mu);
    }
}

// ---------------------------------------------------------------------------
// mod_down: acc (B, 2, k_key, n) + ct (B, 2, k, n) -> (B, 2, k, n): rounded
// division of the key-switch sum by the special prime P, added to the first
// two components of the size-3 ciphertext.  ct_bstride is the word stride
// between batch rows of ct, so that a view ct3[:, :2] needs no copy.
// ---------------------------------------------------------------------------
// one coefficient position of one (batch row, component)
__device__ __forceinline__ void mod_down_at(const u64* __restrict__ ap,
                                            const u64* __restrict__ cp,
                                            u64* __restrict__ op, int n,
                                            const TailParams& c) {
    const u64 xP_half = addmod(ap[(long long)(c.k_key - 1) * n], c.P_half,
                               c.P);
#pragma unroll
    for (int i = 0; i < MAX_K; ++i) {
        if (i < c.k) {
            const u64 p = c.q[i];
            u64 corr = submod(barrett(xP_half, p, c.q_mu[i]),
                              c.half_mod_q[i], p);
            u64 ti = submod(ap[(long long)i * n], corr, p);
            u64 res = mul_shoup(ti, c.inv_P_q[i], c.inv_P_q_s[i], p);
            op[(long long)i * n] = addmod(cp[(long long)i * n], res, p);
        }
    }
}

__global__ void __launch_bounds__(THREADS)
mod_down_kernel(const u64* __restrict__ acc, const u64* __restrict__ ct,
                u64* __restrict__ out, long long batch, int n,
                long long ct_bstride, const TailParams c) {
    const int pos = blockIdx.x * THREADS + threadIdx.x;
    if (pos >= n) return;
    const long long kn = (long long)c.k_key * n, qn = (long long)c.k * n;
    for (long long b = blockIdx.y; b < batch; b += gridDim.y)
        for (int comp = 0; comp < 2; ++comp)
            mod_down_at(acc + (b * 2 + comp) * kn + pos,
                        ct + b * ct_bstride + comp * qn + pos,
                        out + (b * 2 + comp) * qn + pos, n, c);
}

// ---------------------------------------------------------------------------
// C interface
// ---------------------------------------------------------------------------
// grid: x covers the n positions; y (or z) covers rows, looping past 65535
static inline unsigned blocks_for(int n) {
    return (unsigned)((n + THREADS - 1) / THREADS);
}

static inline unsigned rows_dim(long long rows) {
    return (unsigned)(rows < 65535 ? (rows > 0 ? rows : 1) : 65535);
}

struct FloorSkArgs {
    const ulonglong2* t;
    ulonglong2* out;
    long long rows;
    int n2;
    const TailParams* prm;
    cudaStream_t stream;
};

template <int K, int NBSK>
static int launch_floor_sk(const FloorSkArgs& a) {
    floor_sk_kernel<K, NBSK><<<dim3(blocks_for(a.n2), rows_dim(a.rows)),
                               THREADS, 0, a.stream>>>(a.t, a.out, a.rows,
                                                       a.n2, *a.prm);
    return (int)cudaGetLastError();
}

// one instance for every pair within MAX_K x MAX_BSK (B holds at least one
// prime, so |Bsk| >= 2)
static_assert(MAX_K == 3 && MAX_BSK == 5, "floor_sk instances");
template <int K>
static int floor_sk_nbsk(const FloorSkArgs& a) {
    switch (a.prm->nbsk) {
        case 2: return launch_floor_sk<K, 2>(a);
        case 3: return launch_floor_sk<K, 3>(a);
        case 4: return launch_floor_sk<K, 4>(a);
        case 5: return launch_floor_sk<K, 5>(a);
        default: return (int)cudaErrorInvalidValue;
    }
}

extern "C" {

int fhe_tail_params_size() { return (int)sizeof(TailParams); }

void fhe_tail_limits(int* out) {
    out[0] = MAX_K;
    out[1] = MAX_BSK;
    out[2] = MAX_KEY;
    out[3] = MSK_CSUB_STEPS;
}

int fhe_tail_to_bsk_ext(const void* a, void* out, long long rows, int n,
                        const TailParams* prm, void* stream) {
    to_bsk_ext_kernel<<<dim3(blocks_for(n), rows_dim(rows)), THREADS, 0,
                        (cudaStream_t)stream>>>(
        (const u64*)a, (u64*)out, rows, n, *prm);
    return (int)cudaGetLastError();
}

int fhe_tail_dyadic(const void* fa, const void* fb, void* out,
                    long long batch, int n, const TailParams* prm,
                    void* stream) {
    dim3 grid(blocks_for(n), (unsigned)(prm->k + prm->nbsk), rows_dim(batch));
    dyadic_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const u64*)fa, (const u64*)fb, (u64*)out, batch, n, *prm);
    return (int)cudaGetLastError();
}

// n even (rows of whole 16-byte words) and both pointers 16-byte aligned;
// the wrapper checks both.  A (k, nbsk) pair without an instance is refused.
int fhe_tail_floor_sk(const void* t, void* out, long long rows, int n,
                      const TailParams* prm, void* stream) {
    if (n % 2) return (int)cudaErrorInvalidValue;
    const FloorSkArgs a{(const ulonglong2*)t, (ulonglong2*)out, rows, n / 2,
                        prm, (cudaStream_t)stream};
    switch (prm->k) {
        case 1: return floor_sk_nbsk<1>(a);
        case 2: return floor_sk_nbsk<2>(a);
        case 3: return floor_sk_nbsk<3>(a);
        default: return (int)cudaErrorInvalidValue;
    }
}

int fhe_tail_relin_dot(const void* d, const void* rk, void* out,
                       long long batch, int n, const TailParams* prm,
                       void* stream) {
    dim3 grid(blocks_for(n), (unsigned)prm->k_key,
              rows_dim((batch + RELIN_ROWS - 1) / RELIN_ROWS));
    relin_dot_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const u64*)d, (const u64*)rk, (u64*)out, batch, n, *prm);
    return (int)cudaGetLastError();
}

int fhe_tail_mod_down(const void* acc, const void* ct, void* out,
                      long long batch, int n, long long ct_bstride,
                      const TailParams* prm, void* stream) {
    mod_down_kernel<<<dim3(blocks_for(n), rows_dim(batch)), THREADS, 0,
                      (cudaStream_t)stream>>>(
        (const u64*)acc, (const u64*)ct, (u64*)out, batch, n, ct_bstride,
        *prm);
    return (int)cudaGetLastError();
}

}  // extern "C"
