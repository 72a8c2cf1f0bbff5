// Forward and inverse negacyclic NTT over stacks of RNS limbs, for Hopper
// (sm_90a).
//
//   ntt_kernel<false>   replaces PairPallasNtt.ntt  (_kernel_factory(inverse=False))
//   ntt_kernel<true>    replaces PairPallasNtt.intt (_kernel_factory(inverse=True))
//   of fhe_precompiles_tpu/ops/pallas_pair_ntt.py.
//
// What they compute: the data is (rows, n) with row r reduced mod
// moduli[r % L].  Forward: Cooley-Tukey butterflies, natural order in,
// SEAL's bit-reversed order out, canonical residues in and out.  Inverse:
// Gentleman-Sande butterflies, bit-reversed in, natural out, times
// n^-1 * factor (the caller's per-limb constant, folded into the table's
// n_inv on the host).  The twiddle of butterfly group i at a stage with m
// groups is root[l, m + i] (inv_root for the inverse), the (L, n) tables of
// ops/ntt.py, each with its Shoup word floor(w * 2^64 / p) beside it.
//
// What bounds them: a row is read once and written once (16 bytes a word)
// and takes n/2 * log2(n) butterflies of one Shoup product each (10 32-bit
// multiply-adds).  By that count the bytes term is the larger at n = 4096,
// by a factor of 1.3.  What a kernel really spends is integer instructions:
// beside its ten multiply-adds a butterfly needs the carries of the 64-bit
// high product, two or three 64-bit compare-and-selects, and its share of
// the index arithmetic, the loads and the stores.
//
// What the design does about it: one block owns one row and keeps it in
// shared memory from the first stage to the last, so device memory sees one
// read and one write of each word whatever log2(n) is.  A thread does real
// butterflies only.  It takes 2^k words a fixed distance apart and runs k
// stages on them in registers (k <= NTT_RADIX_LOG2 = 3), which
// divides the passes over shared memory, the __syncthreads() and the index
// arithmetic of a butterfly by k.  log2(n) stages are cut into the fewest
// passes of nearly equal k (12 = 3+3+3+3, 13 = 3+3+3+2+2, 10 = 3+3+2+2).
// The first pass is taken straight from device memory and the last is
// written straight to it.  In the forward transform the first pass reads
// words n/2^k apart (neighbouring threads read neighbouring words) and the
// last writes 2^k neighbouring words a thread (16-byte stores); the inverse
// is the mirror image.  Twiddles come through the read-only cache: the tables
// are 16 * L * n bytes and stay in L2.
//
// Arithmetic is Harvey's lazy form on whole 64-bit words with
// mul_shoup_lazy, right for any prime p < 2^61 (4p must fit a word with room
// to add).  Forward values stay below 4p and are reduced once, when they are
// written.  Inverse values stay below 2p; n^-1 * factor is NOT folded into
// the last stage's twiddles: the last stage runs as the others do and each of
// its outputs takes one more Shoup product by n_inv on its way to device
// memory, which also makes it canonical.  (Folding would save n/2 of the
// n/2 * log2(n) + n products of a row.)
//
// The input may be a strided view: rows come in groups of L (one group is
// one (L, n) block, contiguous), and in_gstride is the distance in words
// from one group to the next.  The output is always contiguous.
//
// Plain C interface, as in tail.cu: raw pointers and the stream in,
// cudaGetLastError() out, no synchronisation.
#include <cuda_runtime.h>
#include "modmath.cuh"

// The most stages a pass may take and the threads of a block: of radix 2, 4,
// 8 and 16 and of 128, 256 and 512 threads, these measured best at n = 4096
// on an H100.
#define NTT_RADIX_LOG2 3
#define NTT_MAX_THREADS 256
#define NTT_MAX_SMEM 232448          // what one block may use on sm_90

// Cooley-Tukey butterfly, Harvey-lazy: x, y < 4p in, < 4p out
__device__ __forceinline__ void ct_bfly(u64& x, u64& y, u64 w, u64 ws, u64 p,
                                        u64 p2) {
    const u64 u = csub(x, p2);
    const u64 v = mul_shoup_lazy(y, w, ws, p);
    x = u + v;
    y = u + p2 - v;
}

// Gentleman-Sande butterfly, Harvey-lazy: x, y < 2p in, < 2p out
__device__ __forceinline__ void gs_bfly(u64& x, u64& y, u64 w, u64 ws, u64 p,
                                        u64 p2) {
    const u64 u = x, v = y;
    x = csub(u + v, p2);
    y = mul_shoup_lazy(u + p2 - v, w, ws, p);
}

// K stages on R = 2^K words in registers.  a[r] is word r * d of a thread's
// group of R * d words, group g of the m such groups of the row.  Forward:
// the stage with m groups first (register span R/2, twiddle m + g), then the
// stage with 2m groups (twiddles 2(m + g), 2(m + g) + 1), and so on; stage s
// pairs registers R / 2^(s+1) apart and register block c of its 2^s takes
// twiddle (m + g) * 2^s + c.  Inverse: the same stages in the opposite order.
// Every loop unrolls, so the registers are indexed statically.
template <bool INVERSE, int K>
__device__ __forceinline__ void stages(u64 (&a)[1 << K],
                                       const u64* __restrict__ w,
                                       const u64* __restrict__ ws, int m,
                                       int g, u64 p, u64 p2) {
    constexpr int R = 1 << K;
#pragma unroll
    for (int t = 0; t < K; ++t) {
        const int s = INVERSE ? K - 1 - t : t;
        const int span = R >> (s + 1);
        const int first = (m + g) << s;
#pragma unroll
        for (int c = 0; c < (1 << s); ++c) {
            const u64 wc = w[first + c], wsc = ws[first + c];
#pragma unroll
            for (int r = 0; r < span; ++r) {
                u64& lo = a[2 * span * c + r];
                u64& hi = a[2 * span * c + span + r];
                if (INVERSE) gs_bfly(lo, hi, wc, wsc, p, p2);
                else ct_bfly(lo, hi, wc, wsc, p, p2);
            }
        }
    }
}

// One pass of K stages over the row: n / 2^K threads' worth of work, each on
// 2^K words d = 2^lq apart.  ROLE 0: the first pass, device memory (src) to
// shared memory (x); 1: shared to shared; 2: the last pass, shared memory to
// device memory (dst), where a forward word is reduced to canonical and an
// inverse word takes its product by n_inv.  The pass whose words are
// neighbours (d = 1: the forward's last, the inverse's first) moves them as
// 16-byte pairs.
template <bool INVERSE, int K, int ROLE>
__device__ __forceinline__ void run_pass(const u64* __restrict__ src, u64* x,
                                         u64* __restrict__ dst, int n, int lq,
                                         const u64* __restrict__ w,
                                         const u64* __restrict__ ws, u64 p,
                                         u64 p2, u64 ni, u64 nis) {
    constexpr int R = 1 << K;
    constexpr bool PAIRS = INVERSE ? ROLE == 0 : ROLE == 2;   // d == 1
    const int items = n >> K, d = 1 << lq, m = items >> lq;
    const u64* from = ROLE == 0 ? src : x;
    u64* to = ROLE == 2 ? dst : x;
#pragma unroll 1   // one item at a time: a second in flight measured no faster
    for (int j = threadIdx.x; j < items; j += blockDim.x) {
        const int g = j >> lq;
        const int i0 = R * j - (R - 1) * (j & (d - 1));   // R * d * g + pos
        u64 a[R];
        if (PAIRS) {
            const ulonglong2* v =
                reinterpret_cast<const ulonglong2*>(from + i0);
#pragma unroll
            for (int r = 0; r < R / 2; ++r) {
                const ulonglong2 t = v[r];
                a[2 * r] = t.x;
                a[2 * r + 1] = t.y;
            }
        } else {
#pragma unroll
            for (int r = 0; r < R; ++r) a[r] = from[i0 + r * d];
        }
        stages<INVERSE, K>(a, w, ws, m, g, p, p2);
        if (ROLE == 2) {
#pragma unroll
            for (int r = 0; r < R; ++r)
                a[r] = INVERSE ? mul_shoup(a[r], ni, nis, p)
                               : csub(csub(a[r], p2), p);
        }
        if (PAIRS) {
            ulonglong2* v = reinterpret_cast<ulonglong2*>(to + i0);
#pragma unroll
            for (int r = 0; r < R / 2; ++r) {
                ulonglong2 t;
                t.x = a[2 * r];
                t.y = a[2 * r + 1];
                v[r] = t;
            }
        } else {
#pragma unroll
            for (int r = 0; r < R; ++r) to[i0 + r * d] = a[r];
        }
    }
}

template <bool INVERSE, int ROLE>
__device__ __forceinline__ void run_pass_k(int k, const u64* __restrict__ src,
                                           u64* x, u64* __restrict__ dst,
                                           int n, int lq,
                                           const u64* __restrict__ w,
                                           const u64* __restrict__ ws, u64 p,
                                           u64 p2, u64 ni, u64 nis) {
    switch (k) {
    case 1: run_pass<INVERSE, 1, ROLE>(src, x, dst, n, lq, w, ws, p, p2, ni, nis); break;
    case 2: run_pass<INVERSE, 2, ROLE>(src, x, dst, n, lq, w, ws, p, p2, ni, nis); break;
    case 3: run_pass<INVERSE, 3, ROLE>(src, x, dst, n, lq, w, ws, p, p2, ni, nis); break;
    }
}

template <bool INVERSE>
__global__ void __launch_bounds__(NTT_MAX_THREADS)
ntt_kernel(const u64* __restrict__ in, u64* __restrict__ out, int L, int n,
           int log2n, long long in_gstride, const u64* __restrict__ mod,
           const u64* __restrict__ root, const u64* __restrict__ root_s,
           const u64* __restrict__ n_inv, const u64* __restrict__ n_inv_s) {
    extern __shared__ __align__(16) u64 x[];
    const long long row = blockIdx.x;
    const int l = (int)(row % L);
    const u64 p = mod[l], p2 = 2 * p;
    const u64* __restrict__ src = in + (row / L) * in_gstride + (long long)l * n;
    u64* __restrict__ dst = out + row * n;
    const u64* __restrict__ w = root + (long long)l * n;
    const u64* __restrict__ ws = root_s + (long long)l * n;
    const u64 ni = INVERSE ? n_inv[l] : 0, nis = INVERSE ? n_inv_s[l] : 0;

    // the fewest passes of at most NTT_RADIX_LOG2 stages, but two at least
    // (one from device memory, one to it), of nearly equal size
    int passes = (log2n + NTT_RADIX_LOG2 - 1) / NTT_RADIX_LOG2;
    if (passes < 2) passes = 2;
    const int each = log2n / passes, longer = log2n % passes;
    int done = 0;                         // stages behind us
    for (int i = 0; i < passes; ++i) {
        const int k = each + (i < longer);
        // forward: the pass works on groups of n / 2^done words and its words
        // are a 2^k-th of a group apart; inverse: the spans below 2^done are
        // behind us and the pass's words are 2^done apart
        const int lq = INVERSE ? done : log2n - done - k;
        if (i == 0) {
            run_pass_k<INVERSE, 0>(k, src, x, dst, n, lq, w, ws, p, p2, ni, nis);
        } else if (i == passes - 1) {
            run_pass_k<INVERSE, 2>(k, src, x, dst, n, lq, w, ws, p, p2, ni, nis);
        } else {
            run_pass_k<INVERSE, 1>(k, src, x, dst, n, lq, w, ws, p, p2, ni, nis);
        }
        if (i != passes - 1) __syncthreads();
        done += k;
    }
}

template <bool INVERSE>
static int launch_ntt(const void* in, void* out, long long rows, int L, int n,
                      long long in_gstride, const void* mod, const void* root,
                      const void* root_s, const void* n_inv,
                      const void* n_inv_s, void* stream) {
    int log2n = 0;
    while ((1 << log2n) < n) ++log2n;
    const long long smem = (long long)n * 8;
    if (n < 8 || (1 << log2n) != n || L < 1 || rows < 0 || rows % L != 0
            || rows > 0x7fffffffLL || smem > NTT_MAX_SMEM)
        return (int)cudaErrorInvalidValue;
    if (rows == 0) return (int)cudaSuccess;
    if (smem > 48 * 1024) {   // more than a block gets without asking; the
                              // attribute is the device's, so set it each time
        cudaError_t e = cudaFuncSetAttribute(
            ntt_kernel<INVERSE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    // a thread for each item of the largest pass, within the block's limit
    int threads = n >> (log2n >= 2 * NTT_RADIX_LOG2 ? NTT_RADIX_LOG2 : 1);
    if (threads > NTT_MAX_THREADS) threads = NTT_MAX_THREADS;
    if (threads < 32) threads = 32;
    ntt_kernel<INVERSE><<<(unsigned)rows, threads, (size_t)smem,
                          (cudaStream_t)stream>>>(
        (const u64*)in, (u64*)out, L, n, log2n, in_gstride, (const u64*)mod,
        (const u64*)root, (const u64*)root_s, (const u64*)n_inv,
        (const u64*)n_inv_s);
    return (int)cudaGetLastError();
}

extern "C" {

// largest n whose row fits one block's shared memory
int fhe_ntt_max_n() { return NTT_MAX_SMEM / 8; }

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
