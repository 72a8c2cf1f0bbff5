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
// coefficient positions), and all five are bound by bytes: each reads every
// input word once and writes every output word once, with a few dozen integer
// operations per word in between.  So the design is the simplest one that
// keeps the memory system busy: one thread per coefficient position, with n
// the contiguous axis, so a warp reads 32 neighbouring 8-byte words; the limb
// loops run in registers inside the thread; the ragged edge is masked.
// blockIdx.x covers the positions and blockIdx.y (or z) the rows, so no
// thread divides to find its place; a thread loops only when there are more
// rows than a grid dimension holds.
//
// Per-limb constants arrive in one plain struct passed by value (constant
// bank), with fixed maximum limb counts, so that one binary serves every
// parameter preset.  Limb loops are unrolled to the maximum and predicated
// on the real count, which keeps the per-thread arrays in registers.
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

struct TailParams {
    int32_t k, nbsk, k_key, reserved;
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
    // floor_sk
    u64 inv_q_bsk[MAX_BSK], inv_q_bsk_s[MAX_BSK];
    u64 bhat_inv[MAX_BSK], bhat_inv_s[MAX_BSK];        // mod B_j
    u64 bhat_msk[MAX_BSK], bhat_msk_s[MAX_BSK];        // mod m_sk
    u64 inv_prodB_msk, inv_prodB_msk_s;
    u64 bhat_q[MAX_K][MAX_BSK], bhat_q_s[MAX_K][MAX_BSK];
    u64 prodB_q[MAX_K], prodB_q_s[MAX_K];
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
// ---------------------------------------------------------------------------
__device__ __forceinline__ void floor_sk_at(const u64* __restrict__ tp,
                                            u64* __restrict__ op, int n,
                                            const TailParams& c) {
    const int nB = c.nbsk - 1;
    const u64 msk = c.bsk[nB], msk_mu = c.bsk_mu[nB];

    u64 y[MAX_K];
#pragma unroll
    for (int i = 0; i < MAX_K; ++i)
        if (i < c.k) y[i] = tp[(long long)i * n];

    // fl_j = (x_j - FastBconv(y)_j) * q^-1 mod bsk_j; then for the B limbs
    // y2_j = fl_j * b_hat_inv_j, and x_msk = fl at the m_sk limb
    u64 y2[MAX_BSK];
    u64 x_msk = 0;
#pragma unroll
    for (int j = 0; j < MAX_BSK; ++j) {
        if (j < c.nbsk) {
            const u64 p = c.bsk[j];
            u64 acc = 0;
#pragma unroll
            for (int i = 0; i < MAX_K; ++i)
                if (i < c.k)
                    acc += mul_shoup_lazy(y[i], c.qhat_bsk[j][i],
                                          c.qhat_bsk_s[j][i], p);
            u64 conv = barrett(acc, p, c.bsk_mu[j]);
            u64 num = submod(tp[(long long)(c.k + j) * n], conv, p);
            u64 fl = mul_shoup(num, c.inv_q_bsk[j], c.inv_q_bsk_s[j], p);
            if (j == nB) x_msk = fl;
            else y2[j] = mul_shoup(fl, c.bhat_inv[j], c.bhat_inv_s[j], p);
        }
    }

    // alpha = (sum_j y2_j * b_hat_j - x_msk) * prod(B)^-1 mod m_sk
    u64 acc = 0;
#pragma unroll
    for (int j = 0; j < MAX_BSK; ++j)
        if (j < nB)
            acc += mul_shoup_lazy(y2[j], c.bhat_msk[j], c.bhat_msk_s[j], msk);
    u64 alpha = mul_shoup(submod(barrett(acc, msk, msk_mu), x_msk, msk),
                          c.inv_prodB_msk, c.inv_prodB_msk_s, msk);
    const bool big = alpha >= (msk >> 1) + 1;     // alpha stands for alpha - m_sk
    const u64 mag = big ? msk - alpha : alpha;    // |centred alpha|

#pragma unroll
    for (int i = 0; i < MAX_K; ++i) {
        if (i < c.k) {
            const u64 p = c.q[i], mu = c.q_mu[i];
            u64 accq = 0;
#pragma unroll
            for (int j = 0; j < MAX_BSK; ++j)
                if (j < nB)
                    accq += mul_shoup_lazy(y2[j], c.bhat_q[i][j],
                                           c.bhat_q_s[i][j], p);
            accq = barrett(accq, p, mu);
            // centred alpha mod q_i; the negation of the reduced m_sk - alpha
            // maps 0 to 0, not to q_i
            u64 red = barrett(mag, p, mu);
            u64 am = (big && red != 0) ? p - red : red;
            u64 corr = mul_shoup(am, c.prodB_q[i], c.prodB_q_s[i], p);
            op[(long long)i * n] = submod(accq, corr, p);
        }
    }
}

__global__ void __launch_bounds__(THREADS)
floor_sk_kernel(const u64* __restrict__ t, u64* __restrict__ out,
                long long rows, int n, const TailParams c) {
    const int pos = blockIdx.x * THREADS + threadIdx.x;
    if (pos >= n) return;
    for (long long row = blockIdx.y; row < rows; row += gridDim.y)
        floor_sk_at(t + row * (c.k + c.nbsk) * n + pos,
                    out + row * c.k * n + pos, n, c);
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

extern "C" {

int fhe_tail_params_size() { return (int)sizeof(TailParams); }

void fhe_tail_limits(int* out) {
    out[0] = MAX_K;
    out[1] = MAX_BSK;
    out[2] = MAX_KEY;
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

int fhe_tail_floor_sk(const void* t, void* out, long long rows, int n,
                      const TailParams* prm, void* stream) {
    floor_sk_kernel<<<dim3(blocks_for(n), rows_dim(rows)), THREADS, 0,
                      (cudaStream_t)stream>>>(
        (const u64*)t, (u64*)out, rows, n, *prm);
    return (int)cudaGetLastError();
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
