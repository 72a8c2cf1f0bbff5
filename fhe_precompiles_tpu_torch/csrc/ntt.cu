// Forward and inverse negacyclic NTT over stacks of RNS limbs, for Hopper
// (sm_90a).
//
//   ntt_kernel<false>   replaces PairPallasNtt.ntt  (_kernel_factory(inverse=False))
//   ntt_kernel<true>    replaces PairPallasNtt.intt (_kernel_factory(inverse=True))
//   of fhe_precompiles_tpu/ops/pallas_pair_ntt.py (TPU kernels 6 and 7).
//
// What they compute: the data is (rows, n) with row r reduced mod
// moduli[r % L].  Forward: Cooley-Tukey butterflies, natural order in,
// SEAL's bit-reversed order out, canonical residues in and out.  Inverse:
// Gentleman-Sande butterflies, bit-reversed in, natural out, times
// n^-1 * factor (the caller's per-limb constant, folded into the table's
// n_inv on the host).  The twiddle of butterfly group i at a stage with m
// groups is root[l, m + i] (inv_root for the inverse), the (L, n) tables of
// ops/ntt.py, each with its 40-bit Shoup word floor(w * 2^40 / p) beside it.
//
// What bounds them: by count, bytes (a row read and written once, each
// limb's two tables read once a launch; at n = 4096 the term of the
// product's FP64 multiply-adds is under a third of it).  What a block
// really spends is instruction issue: some 25 instructions a butterfly, and
// an SM issues integer and FP64 instructions at about the same rate, a mix
// of the two gaining little.  Device memory is not waited for: the copies
// below overlap the butterflies.
//
// What the design does about it:
// - Persistent, limb-affine blocks.  The grid is what the card holds at once
//   (blocks an SM times SMs, never more than the rows), a multiple of L;
//   block b owns limb l = b % L and walks that limb's rows g*L + l for
//   g = b / L, b / L + grid / L, ...  The limbs' blocks differ by one row
//   at most.
// - The limb's twiddles and Shoup words live in shared memory, staged once
//   a block by two TMA bulk copies: every butterfly reads its twiddle there,
//   and the tables cross from L2 once a block instead of once a row.
// - Rows pass through a ring of NTT_RING shared-memory buffers filled and
//   drained by TMA bulk copies (cp.async.bulk, completion on an mbarrier for
//   a load, a bulk group for a store): while a block's threads run row i's
//   butterflies, row i + 1 is on its way in and row i - 1 on its way out.
//   One thread issues every copy; the others spend no instruction on moving
//   a row.  The ring follows n with no knob: three buffers at n <= 4096 (a
//   64 KB table and three 32 KB rows at n = 4096, 160 KB), one at n = 8192
//   (128 KB of table and a 64 KB row), where a row's load waits for the last
//   row's store to have left.
// - Inside a row, as in the kernels before: a thread takes 2^k words a fixed
//   distance apart and runs k stages on them in registers (k <=
//   NTT_RADIX_LOG2 = 3), log2(n) stages cut into the fewest passes of nearly
//   equal k (12 = 3+3+3+3, 13 = 3+3+3+2+2, 10 = 3+3+2+2), __syncthreads()
//   between passes.  A pass whose words are neighbours moves them as 16-byte
//   pairs.
// - The beta = 40 Shoup product of the JAX kernel (shoup_bits=40): every
//   modulus is below 2^37, so lazy values (< 4p) are below 2^39 and the
//   remainder of mul_shoup40_lazy stays below 1.5p.  Its quotient and
//   remainder are formed exactly on the FP64 pipe (modmath.cuh), in fewer
//   instructions than 32-bit partial products take; so the tables are
//   turned into doubles in shared memory once a block.  Harvey's lazy
//   bounds: forward values stay below 4p and are made canonical in the last
//   pass; inverse values stay below 2p and the last pass multiplies each by
//   n^-1 * factor, which also makes it canonical.
//
// The input may be a strided view: rows come in groups of L (one group is
// one (L, n) block, contiguous), and in_gstride is the distance in words
// from one group to the next.  The output is always contiguous.  Every row
// start is 16-byte aligned and every row a multiple of 16 bytes, as bulk
// copies need (the wrapper checks the input; n >= 8).
//
// Plain C interface, as in tail.cu: raw pointers and the stream in,
// cudaGetLastError() out, no synchronisation.
#include <cuda_runtime.h>
#include "modmath.cuh"

// The most stages a pass takes in registers, and the threads of a block
#define NTT_RADIX_LOG2 3
#define NTT_MAX_THREADS 512
#define NTT_MAX_SMEM 232448          // what one block may use on sm_90
#define NTT_RING 3                   // row buffers, where they fit
#define NTT_BARRIER_BYTES 64         // the mbarriers, ahead of the tables
#define NTT_CACHED_DEVICES 64        // cards whose launch geometry is kept

#include "tma.cuh"

// ---------------------------------------------------------------------------
// butterflies
// ---------------------------------------------------------------------------
// The modulus of a row: p and 2p as words, p as a double for the product
struct Mod {
    u64 p, p2;
    double pd;
};

// Cooley-Tukey butterfly, Harvey-lazy: x, y < 4p in, < 4p out.  w and ws are
// the twiddle and its Shoup word scaled by 2^-40, as doubles.
__device__ __forceinline__ void ct_bfly(u64& x, u64& y, double w, double ws,
                                        const Mod& m) {
    const u64 u = csub_signed(x, m.p2);
    const u64 v = mul_shoup40_lazy(y, w, ws, m.pd);
    x = u + v;
    y = u + m.p2 - v;
}

// Gentleman-Sande butterfly, Harvey-lazy: x, y < 2p in, < 2p out
__device__ __forceinline__ void gs_bfly(u64& x, u64& y, double w, double ws,
                                        const Mod& m) {
    const u64 u = x, v = y;
    x = csub_signed(u + v, m.p2);
    y = mul_shoup40_lazy(u + m.p2 - v, w, ws, m.pd);
}

// K stages on R = 2^K words in registers.  a[r] is word r * d of a thread's
// group of R * d words, group g of the m such groups of the row.  Forward:
// the stage with m groups first (register span R/2, twiddle m + g), then the
// stage with 2m groups (twiddles 2(m + g), 2(m + g) + 1), and so on; stage s
// pairs registers R / 2^(s+1) apart and register block c of its 2^s takes
// twiddle (m + g) * 2^s + c.  Inverse: the same stages in the opposite order.
// Every loop unrolls, so the registers are indexed statically.
template <bool INVERSE, int K>
__device__ __forceinline__ void stages(u64 (&a)[1 << K], const double* w,
                                       const double* ws, int m, int g,
                                       const Mod& md) {
    constexpr int R = 1 << K;
#pragma unroll
    for (int t = 0; t < K; ++t) {
        const int s = INVERSE ? K - 1 - t : t;
        const int span = R >> (s + 1);
        const int first = (m + g) << s;
#pragma unroll
        for (int c = 0; c < (1 << s); ++c) {
            const double wc = w[first + c], wsc = ws[first + c];
#pragma unroll
            for (int r = 0; r < span; ++r) {
                u64& lo = a[2 * span * c + r];
                u64& hi = a[2 * span * c + span + r];
                if (INVERSE) gs_bfly(lo, hi, wc, wsc, md);
                else ct_bfly(lo, hi, wc, wsc, md);
            }
        }
    }
}

// One pass of K stages over the row x in shared memory: n / 2^K items, each
// 2^K words d = 2^lq apart.  LAST: the pass also finishes each word, a
// forward word reduced to canonical, an inverse word multiplied by n_inv.
// The pass whose words are neighbours (d == 1: the forward's last, the
// inverse's first) moves them as 16-byte pairs.
template <bool INVERSE, int K, bool LAST>
__device__ __forceinline__ void run_pass(u64* x, int n, int lq,
                                         const double* w, const double* ws,
                                         const Mod& md, double ni,
                                         double nis) {
    constexpr int R = 1 << K;
    const int items = n >> K, d = 1 << lq, m = items >> lq;
#pragma unroll 1
    for (int j = threadIdx.x; j < items; j += blockDim.x) {
        const int g = j >> lq;
        const int i0 = R * j - (R - 1) * (j & (d - 1));   // R * d * g + pos
        u64 a[R];
        if (d == 1) {
            const ulonglong2* v = reinterpret_cast<const ulonglong2*>(x + i0);
#pragma unroll
            for (int r = 0; r < R / 2; ++r) {
                const ulonglong2 t = v[r];
                a[2 * r] = t.x;
                a[2 * r + 1] = t.y;
            }
        } else {
#pragma unroll
            for (int r = 0; r < R; ++r) a[r] = x[i0 + r * d];
        }
        stages<INVERSE, K>(a, w, ws, m, g, md);
        if (LAST) {
#pragma unroll
            for (int r = 0; r < R; ++r)
                a[r] = INVERSE
                    ? csub_signed(mul_shoup40_lazy(a[r], ni, nis, md.pd), md.p)
                    : csub_signed(csub_signed(a[r], md.p2), md.p);
        }
        if (d == 1) {
            ulonglong2* v = reinterpret_cast<ulonglong2*>(x + i0);
#pragma unroll
            for (int r = 0; r < R / 2; ++r) {
                ulonglong2 t;
                t.x = a[2 * r];
                t.y = a[2 * r + 1];
                v[r] = t;
            }
        } else {
#pragma unroll
            for (int r = 0; r < R; ++r) x[i0 + r * d] = a[r];
        }
    }
}

template <bool INVERSE, bool LAST>
__device__ __forceinline__ void run_pass_k(int k, u64* x, int n, int lq,
                                           const double* w, const double* ws,
                                           const Mod& md, double ni,
                                           double nis) {
    switch (k) {
    case 1: run_pass<INVERSE, 1, LAST>(x, n, lq, w, ws, md, ni, nis); break;
    case 2: run_pass<INVERSE, 2, LAST>(x, n, lq, w, ws, md, ni, nis); break;
    case 3: run_pass<INVERSE, 3, LAST>(x, n, lq, w, ws, md, ni, nis); break;
    }
}

// All log2(n) stages of the row in shared memory x, in place (the caller
// synchronises after the last pass).
template <bool INVERSE>
__device__ __forceinline__ void transform_row(u64* x, int n, int log2n,
                                              const double* w,
                                              const double* ws, const Mod& md,
                                              double ni, double nis) {
    // the fewest passes of at most NTT_RADIX_LOG2 stages, of nearly equal
    // size
    const int passes = (log2n + NTT_RADIX_LOG2 - 1) / NTT_RADIX_LOG2;
    const int each = log2n / passes, longer = log2n % passes;
    int done = 0;                         // stages behind us
    for (int i = 0; i < passes; ++i) {
        const int k = each + (i < longer);
        // forward: the pass works on groups of n / 2^done words and its words
        // are a 2^k-th of a group apart; inverse: the spans below 2^done are
        // behind us and the pass's words are 2^done apart
        const int lq = INVERSE ? done : log2n - done - k;
        if (i == passes - 1)
            run_pass_k<INVERSE, true>(k, x, n, lq, w, ws, md, ni, nis);
        else
            run_pass_k<INVERSE, false>(k, x, n, lq, w, ws, md, ni, nis);
        if (i != passes - 1) __syncthreads();
        done += k;
    }
}

// Shared memory: NTT_BARRIER_BYTES of mbarriers (the table's, then one a
// ring buffer), the twiddles (n words), their Shoup words (n), and `ring`
// row buffers of n words.
template <bool INVERSE>
__global__ void __launch_bounds__(NTT_MAX_THREADS)
ntt_kernel(const u64* __restrict__ in, u64* __restrict__ out, int L, int n,
           int log2n, int ring, long long groups, long long in_gstride,
           const u64* __restrict__ mod, const u64* __restrict__ root,
           const u64* __restrict__ root_s, const u64* __restrict__ n_inv,
           const u64* __restrict__ n_inv_s) {
    extern __shared__ __align__(16) unsigned char smem[];
    u64* bars = reinterpret_cast<u64*>(smem);          // [0]: tables
    u64* w = reinterpret_cast<u64*>(smem + NTT_BARRIER_BYTES);
    u64* ws = w + n;
    u64* rows = ws + n;
    const unsigned row_bytes = 8u * (unsigned)n;

    const int l = blockIdx.x % L;
    const long long first = blockIdx.x / L, step = gridDim.x / L;
    const long long count = (groups - first + step - 1) / step;   // >= 1
    const u64 p = mod[l];
    const Mod md = {p, 2 * p, exact_double(p)};
    const double ni = INVERSE ? exact_double(n_inv[l]) : 0.0;
    const double nis = INVERSE ? exact_double(n_inv_s[l]) * 0x1p-40 : 0.0;
    const u64* src = in + first * in_gstride + (long long)l * n;
    u64* dst = out + (first * L + l) * n;
    const long long src_step = step * in_gstride, dst_step = step * L * n;
    // loads ahead of the row in hand: ring - 1, so that a buffer is refilled
    // only after the store before last has left it; one with a single buffer
    const int ahead = ring > 1 ? ring - 1 : 1;

    if (threadIdx.x == 0) {
        for (int s = 0; s <= ring; ++s) mbar_init(&bars[s], 1);
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        mbar_expect_tx(&bars[0], 2 * row_bytes);
        bulk_load(w, root + (long long)l * n, row_bytes, &bars[0]);
        bulk_load(ws, root_s + (long long)l * n, row_bytes, &bars[0]);
        for (int i = 0; i < ahead && i < count; ++i) {
            mbar_expect_tx(&bars[1 + i], row_bytes);
            bulk_load(rows + (long long)i * n, src + i * src_step, row_bytes,
                      &bars[1 + i]);
        }
    }
    mbar_wait(&bars[0], 0);
    // the tables as the product takes them: each twiddle as a double, each
    // Shoup word scaled by 2^-40 (both exact), in place
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
        w[i] = (u64)__double_as_longlong(exact_double(w[i]));
        ws[i] = (u64)__double_as_longlong(exact_double(ws[i]) * 0x1p-40);
    }
    __syncthreads();
    const double* wd = reinterpret_cast<const double*>(w);
    const double* wsd = reinterpret_cast<const double*>(ws);

    for (long long i = 0; i < count; ++i) {
        const int s = (int)(i % ring);
        u64* x = rows + (long long)s * n;
        mbar_wait(&bars[1 + s], (unsigned)((i / ring) & 1));
        transform_row<INVERSE>(x, n, log2n, wd, wsd, md, ni, nis);
        // the threads' writes to x, then the bulk store that reads them
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        __syncthreads();
        if (threadIdx.x == 0) {
            bulk_store(dst + i * dst_step, x, row_bytes);
            const long long j = i + ahead;
            if (j < count) {
                // row j's buffer last held row j - ring: its store must have
                // read it (the newest store may still be going with ring > 1)
                if (ring > 1) bulk_wait_read<1>();
                else bulk_wait_read<0>();
                const int sj = (int)(j % ring);
                mbar_expect_tx(&bars[1 + sj], row_bytes);
                bulk_load(rows + (long long)sj * n, src + j * src_step,
                          row_bytes, &bars[1 + sj]);
            }
        }
    }
    // the stores must be done with shared memory before the block leaves it
    if (threadIdx.x == 0)
        asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// Row buffers for a row of n words: up to NTT_RING, as many as fit beside
// the barriers and the two tables; 0 if not even one does.
static int ring_for(int n) {
    const long long free = NTT_MAX_SMEM - NTT_BARRIER_BYTES - 16LL * n;
    long long r = free > 0 ? free / (8LL * n) : 0;
    if (r > NTT_RING) r = NTT_RING;
    if (r + 1 > NTT_BARRIER_BYTES / 8) r = NTT_BARRIER_BYTES / 8 - 1;
    return (int)r;
}

template <bool INVERSE>
static int launch_ntt(const void* in, void* out, long long rows, int L, int n,
                      long long in_gstride, const void* mod, const void* root,
                      const void* root_s, const void* n_inv,
                      const void* n_inv_s, void* stream) {
    int log2n = 0;
    while ((1 << log2n) < n) ++log2n;
    const int ring = n >= 8 ? ring_for(n) : 0;
    if (n < 8 || (1 << log2n) != n || L < 1 || rows < 0 || rows % L != 0
            || ring < 1)
        return (int)cudaErrorInvalidValue;
    if (rows == 0) return (int)cudaSuccess;
    const size_t smem = NTT_BARRIER_BYTES + 8 * (size_t)n * (2 + ring);
    // a thread for each item of the largest pass, within the block's limit
    int threads = n >> (log2n >= 2 * NTT_RADIX_LOG2 ? NTT_RADIX_LOG2 : 1);
    if (threads > NTT_MAX_THREADS) threads = NTT_MAX_THREADS;
    if (threads < 32) threads = 32;
    // The blocks the card holds at once, found once for each card and n:
    // the shared-memory limit (set to the most any n takes, so that no call
    // lowers it below another's) and the occupancy query are set-up, kept
    // out of every later launch's host time.
    static int capacity[NTT_CACHED_DEVICES][32];
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    int cap = dev < NTT_CACHED_DEVICES ? capacity[dev][log2n] : 0;
    if (cap == 0) {
        e = cudaFuncSetAttribute(ntt_kernel<INVERSE>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 NTT_MAX_SMEM);
        int sms = 0, per_sm = 0;
        if (e == cudaSuccess)
            e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                       dev);
        if (e == cudaSuccess)
            e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &per_sm, ntt_kernel<INVERSE>, threads, smem);
        if (e != cudaSuccess) return (int)e;
        cap = sms * per_sm;
        if (cap < 1) return (int)cudaErrorInvalidConfiguration;
        if (dev < NTT_CACHED_DEVICES) capacity[dev][log2n] = cap;
    }
    // as many blocks as the card holds, a multiple of L, each limb's blocks
    // at most its rows
    const long long groups = rows / L;
    long long per_limb = cap / L;
    if (per_limb > groups) per_limb = groups;
    if (per_limb < 1) per_limb = 1;
    ntt_kernel<INVERSE><<<(unsigned)(per_limb * L), threads, smem,
                          (cudaStream_t)stream>>>(
        (const u64*)in, (u64*)out, L, n, log2n, ring, groups, in_gstride,
        (const u64*)mod, (const u64*)root, (const u64*)root_s,
        (const u64*)n_inv, (const u64*)n_inv_s);
    return (int)cudaGetLastError();
}

extern "C" {

// largest n whose row buffer fits one block's shared memory beside the tables
int fhe_ntt_max_n() {
    int n = 8;
    while (ring_for(2 * n) >= 1) n *= 2;
    return n;
}

int fhe_ntt_forward(const void* in, void* out, long long rows, int L, int n,
                    long long in_gstride, const void* mod, const void* root,
                    const void* root_s, void* stream) {
    return launch_ntt<false>(in, out, rows, L, n, in_gstride, mod, root,
                             root_s, nullptr, nullptr, stream);
}

int fhe_ntt_inverse(const void* in, void* out, long long rows, int L, int n,
                    long long in_gstride, const void* mod, const void* root,
                    const void* root_s, const void* n_inv,
                    const void* n_inv_s, void* stream) {
    return launch_ntt<true>(in, out, rows, L, n, in_gstride, mod, root,
                            root_s, n_inv, n_inv_s, stream);
}

}  // extern "C"
