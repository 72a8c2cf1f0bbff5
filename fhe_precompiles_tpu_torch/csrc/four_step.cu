// Four-step negacyclic NTT over stacks of RNS limbs on the integer tensor
// cores, for Hopper (sm_90a).
//
//   four_step_kernel<false>  replaces PallasNtt._fused_call, forward
//   four_step_kernel<true>   replaces PallasNtt._fused_call, inverse
//                            (_fused_kernel_factory of
//                            fhe_precompiles_tpu/ops/pallas_ntt.py)
//   four_step_phase_kernel   replaces PallasNtt._phase
//                            (_phase_kernel_factory, modes none/pre/post)
//
// What they compute (ops/four_step.py holds the tables and the plain
// versions).  A row of n = R * C words, reduced mod p of its limb, is the
// R x C matrix M.  Forward: Z = (T (*) (A @ M)) @ B0^T; inverse:
// X = A' @ (T' (*) (M @ B0'^T)), with n^-1 times the caller's factor inside
// A'.  A, B0, A', B0' come as five base-256 digit planes (uint8), T and T'
// as words with their Shoup companions.  Canonical residues in and out;
// moduli below 2^37.  The phase kernel runs one product W @ X over a K x J
// matrix, with the grid multiplied in before it (mode 1), after it (mode 2)
// or not at all (0): the two-launch form of the transform.
//
// Each product W @ X is 25 digit-pair products u8 x u8 -> s32 on the
// tensor cores, the pair products of equal weight 256^s (s = da + db)
// summed into one of nine sums S_s.  A pair sum is below 255^2 * K, so
// S_s < 5 * 255^2 * 128 < 2^26 for K <= 128.  The first product's outputs
// take the grid and go back to shared memory as digit planes in the layout
// the second product reads: the transpose between the two phases is where
// each output is written.  Forward: r-product (contracting over r, K = R,
// N = C), grid, c-product (K = C, N = R); inverse: c-product, grid,
// r-product.
//
// four_step_phase_kernel (kernel 9) is the first, simple design: a block a
// row, the row loaded FS_LOADS words a thread at a time, mma.sync.m16n8k32
// a warp per 16 x 8 tile with its A fragments fetched through L1 and L2 for
// every tile, and the nine sums recombined as v = lo + hi * 2^40,
// v mod p = barrett(lo) + shoup(hi, 2^40 mod p) with 64-bit words on the
// integer pipe.  Its operand X (K x N) is stored column by column, each
// column's K digits contiguous, columns FS_PAD bytes apart beyond K.
//
// four_step_kernel (kernel 8) began as that design; what held it back was
// latency: a block a row, 118-120 registers a thread, the A fragments
// fetched again for every tile of every row, the 64-bit epilogue.  Now:
// - Persistent, limb-affine blocks of four warpgroups, one block an SM, as
//   ntt.cu: the grid is what the card holds at once, a multiple of L; block
//   b owns limb l = b % L and walks that limb's rows.
// - The limb's weights (both matrices' five digit planes) are staged in
//   shared memory once a block by one TMA bulk copy each, already in
//   wgmma's canonical K-major layout (packed on the host, ops/four_step.py
//   wgmma_weight_layout), and every row the block holds uses them.
// - Several rows a batch, as many as fit (FS_MAX_ROWS at most), each with
//   its two operands' digit planes.  The batch's raw rows arrive by TMA
//   bulk copies into staging buffers; the next batch's copies are issued as
//   soon as this batch's rows are split into digit planes, so that they
//   overlap this batch's products.  Where the staging buffer does not fit
//   beside the weights and one row (n = 8192), the threads load the row
//   from device memory themselves and nothing overlaps.
// - The products on wgmma.m64n32k32.s32.u8.u8, both operands in shared
//   memory (integer wgmma takes both K-major: the weights' rows and the
//   operand's columns hold their depth contiguous).  A warpgroup takes a
//   64 x 32 output tile; the digit pairs of one weight 256^s are one group
//   of wgmma into one set of accumulators, and two sets alternate, so that
//   the tensor cores run group s - 1 while group s is folded into one
//   64-bit word an output on the integer pipe (wg_fold).  Nine sums a tile
//   in registers would be 144 a thread; this is 32 for the accumulators
//   and 32 for the folded words.
// - The async proxy: the digit planes are written by ordinary stores (the
//   split, the first product's epilogue) and read by wgmma, so each write
//   phase ends with fence.proxy.async and a barrier; wgmma.fence before
//   each group, commit and wait before its accumulators are read.
// - The epilogue on the FP64 pipe, every step an integer below 2^53 that
//   the doubles hold exactly: hi = S_4 + S_5 2^8 + ... + S_8 2^32 < 2^50
//   (digit 4 of a canonical word is below 2^5) is reduced by a beta = 52
//   Shoup product with 2^32 mod p to r1 < 2p; x = r1 + S_3 2^24 + ... + S_0
//   < 2^51 and x - floor(x * floor(2^52 / p) / 2^52) * p lies in
//   [0, 1.5p).  The grid product (the grid's beta = 40 Shoup words) takes
//   that lazy value to below 1.1875p, and one conditional subtract makes
//   either product's output canonical.
//
// Shared memory of kernel 8 (FS_BARRIER_BYTES, the weights, then per row of
// a batch the two operands' planes and an 8n-byte staging buffer; a weight
// matrix's rows padded to a multiple of 64, a depth of 16 to 32, an operand
// to 32 columns): n = 4096 (R = C = 64): 40,960 bytes of weights, 40,960 of
// planes and 32,768 of staging a row: two rows, 188,432 bytes.  n = 8192
// (R = 128, C = 64): 102,400 of weights, 81,920 of planes: one row,
// unstaged, 184,336 bytes.  R = C = 128 does not fit and is refused.
//
// What bounds it, by count: at n = 4096 the bytes (a row read and written
// once, 16 bytes a word); then the tensor cores (25 n (R + C) u8
// multiply-adds a row) and the FP64 pipe (16 multiply-adds an output word).
// What it spends more than that, and where: PERF.md, from chip_compare.py's
// ablations.
//
// Plain C interface, as in ntt.cu: raw pointers and the stream in,
// cudaGetLastError() out, no synchronisation.  R and C must be 16, 32, 64
// or 128.
#include <cuda_runtime.h>
#include "modmath.cuh"
#include "tma.cuh"

typedef unsigned int u32;
typedef unsigned char u8;

#define FS_NDIG 5
#define FS_SUMS (2 * FS_NDIG - 1)
#define FS_PAD 16
// The phase kernel's threads a block and words of the row a thread loads at
// once: of 128, 256 and 512 threads and of one and eight words in flight,
// these measured best at n = 4096 on an H100.
#define FS_THREADS 256
#define FS_LOADS 8
#define FS_MAX_SMEM 232448          // what one block may use on sm_90
// kernel 8: threads of a block (four warpgroups, one block an SM), rows a
// batch at most, the mbarriers ahead of the weights, cards whose launch
// geometry is kept
#define FS8_THREADS 512
#define FS_MAX_ROWS 4
#define FS_BARRIER_BYTES 16
#define FS_CACHED_DEVICES 64

struct LimbScalars {
    u64 p, mu, w40, w40s;           // p, floor(2^64 / p), 2^40 mod p, Shoup
};

__device__ __forceinline__ LimbScalars limb_scalars(const u64* s, int l) {
    LimbScalars r;
    r.p = s[4 * l];
    r.mu = s[4 * l + 1];
    r.w40 = s[4 * l + 2];
    r.w40s = s[4 * l + 3];
    return r;
}

// d += a * b on the tensor cores: a 16 x 32 u8 (row), b 32 x 8 u8 (col),
// d 16 x 8 s32.  Fragments as the PTX ISA lays them out, g = lane / 4,
// t = lane % 4: a = {row g k 4t.., row g+8 k 4t.., row g k 16+4t..,
// row g+8 k 16+4t..}, four digits a register, lowest k in the low byte;
// b = {col g k 4t.., col g k 16+4t..}; d = {(g, 2t), (g, 2t+1), (g+8, 2t),
// (g+8, 2t+1)}.
__device__ __forceinline__ void mma_u8(int (&d)[4], const u32 (&a)[4],
                                       const u32 (&b)[2]) {
    asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// the five base-256 digits of v, one in each plane
__device__ __forceinline__ void put_digits(u8* X, int plane, int at, u64 v) {
#pragma unroll
    for (int d = 0; d < FS_NDIG; ++d) X[d * plane + at] = (u8)(v >> (8 * d));
}

// the row from device memory, FS_LOADS words a thread in flight:
// put(idx, word) for every idx < n
template <class Put>
__device__ __forceinline__ void load_row(const u64* __restrict__ src, int n,
                                         Put put) {
    for (int base = threadIdx.x; base < n; base += FS_LOADS * blockDim.x) {
        u64 v[FS_LOADS];
#pragma unroll
        for (int j = 0; j < FS_LOADS; ++j) {
            const int idx = base + j * blockDim.x;
            v[j] = idx < n ? src[idx] : 0ull;
        }
#pragma unroll
        for (int j = 0; j < FS_LOADS; ++j) {
            const int idx = base + j * blockDim.x;
            if (idx < n) put(idx, v[j]);
        }
    }
}

// out = W @ X mod p for W (K x K) in device memory, digit planes
// W[d * K * K + i * K + k], and X (K x N) in shared memory, digit planes
// X[d * N * (K + PAD) + n * (K + PAD) + k].  Each warp takes 16 x 8 output
// tiles in turn and hands every output to epi(i, n, value), value canonical,
// after multiplying it by the grid word at gidx(i, n) when G is not null.
template <class GridIdx, class Epi>
__device__ __forceinline__ void digit_product(const u8* X, int K, int N,
                                              const u8* __restrict__ W,
                                              const LimbScalars& s,
                                              const u64* __restrict__ G,
                                              const u64* __restrict__ Gs,
                                              GridIdx gidx, Epi epi) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const int SK = K + FS_PAD, plane = N * SK, wplane = K * K;
    const int tiles_n = N >> 3, tiles = (K >> 4) * tiles_n;
    for (int tile = threadIdx.x >> 5; tile < tiles; tile += blockDim.x >> 5) {
        const int i0 = (tile / tiles_n) << 4, n0 = (tile % tiles_n) << 3;
        int acc[FS_SUMS][4];
#pragma unroll
        for (int s2 = 0; s2 < FS_SUMS; ++s2)
            acc[s2][0] = acc[s2][1] = acc[s2][2] = acc[s2][3] = 0;
        for (int k0 = 0; k0 < K; k0 += 32) {
            // K = 16: the upper half of the 32-deep step is zero
            const bool upper = k0 + 16 < K;
            u32 b[FS_NDIG][2];
#pragma unroll
            for (int d = 0; d < FS_NDIG; ++d) {
                const u8* xp = X + d * plane + (n0 + g) * SK + k0 + 4 * t;
                b[d][0] = *reinterpret_cast<const u32*>(xp);
                b[d][1] = upper ? *reinterpret_cast<const u32*>(xp + 16) : 0u;
            }
#pragma unroll
            for (int da = 0; da < FS_NDIG; ++da) {
                const u32* wp = reinterpret_cast<const u32*>(
                    W + da * wplane + (i0 + g) * K + k0 + 4 * t);
                const int row8 = 2 * K;          // 8 rows on, in words
                u32 a[4];
                a[0] = __ldg(wp);
                a[1] = __ldg(wp + row8);
                a[2] = upper ? __ldg(wp + 4) : 0u;
                a[3] = upper ? __ldg(wp + row8 + 4) : 0u;
#pragma unroll
                for (int db = 0; db < FS_NDIG; ++db)
                    mma_u8(acc[da + db], a, b[db]);
            }
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
            u64 lo = 0, hi = 0;
#pragma unroll
            for (int s2 = 0; s2 < FS_NDIG; ++s2)
                lo += (u64)(u32)acc[s2][e] << (8 * s2);
#pragma unroll
            for (int s2 = FS_NDIG; s2 < FS_SUMS; ++s2)
                hi += (u64)(u32)acc[s2][e] << (8 * (s2 - FS_NDIG));
            const int i = i0 + g + ((e >> 1) << 3), j = n0 + 2 * t + (e & 1);
            u64 v = csub(barrett(lo, s.p, s.mu)
                         + mul_shoup(hi, s.w40, s.w40s, s.p), s.p);
            if (G != nullptr) {
                const int idx = gidx(i, j);
                v = mul_shoup(v, G[idx], Gs[idx], s.p);
            }
            epi(i, j, v);
        }
    }
}

// one product over a K x J matrix a row: out = W @ (G (*) X) (mode 1),
// G (*) (W @ X) (mode 2) or W @ X (mode 0)
__global__ void __launch_bounds__(FS_THREADS)
four_step_phase_kernel(const u64* __restrict__ in, u64* __restrict__ out,
                       int L, int K, int J, long long in_gstride,
                       const u64* __restrict__ scal, const u8* __restrict__ w,
                       const u64* __restrict__ grid,
                       const u64* __restrict__ grid_s, int mode) {
    extern __shared__ __align__(16) u8 smem[];
    const long long row = blockIdx.x;
    const int l = (int)(row % L), n = K * J, lj = __ffs(J) - 1;
    const LimbScalars s = limb_scalars(scal, l);
    const u64* __restrict__ src = in + (row / L) * in_gstride + (long long)l * n;
    u64* __restrict__ dst = out + row * n;
    const u64* __restrict__ G = grid + (long long)l * n;
    const u64* __restrict__ Gs = grid_s + (long long)l * n;
    const u8* __restrict__ W = w + (long long)l * FS_NDIG * K * K;
    const int KP = K + FS_PAD, plane = J * KP;

    load_row(src, n, [&](int idx, u64 v) {
        if (mode == 1) v = mul_shoup(v, G[idx], Gs[idx], s.p);
        put_digits(smem, plane, (idx & (J - 1)) * KP + (idx >> lj), v);
    });
    __syncthreads();
    auto at = [&](int i, int j) { return (i << lj) + j; };
    digit_product(smem, K, J, W, s, mode == 2 ? G : nullptr, Gs, at,
                  [&](int i, int j, u64 v) { dst[at(i, j)] = v; });
}

// ---------------------------------------------------------------------------
// kernel 8: the whole transform, persistent blocks, wgmma
// ---------------------------------------------------------------------------
// A limb's constants for the epilogue, as doubles (all exact): p,
// c32 = 2^32 mod p and its beta = 52 Shoup word floor(c32 * 2^52 / p) * 2^-52,
// and floor(2^52 / p) * 2^-52.  From `fold_scalars` (L, 4) of MxuNttTables.
struct Mod52 {
    double p, c32, c32s, pinv;
};

__device__ __forceinline__ Mod52 mod52(const u64* s, int l) {
    Mod52 m;
    m.p = exact_double(s[4 * l]);
    m.c32 = exact_double(s[4 * l + 1]);
    m.c32s = exact_double(s[4 * l + 2]) * 0x1p-52;
    m.pinv = exact_double(s[4 * l + 3]) * 0x1p-52;
    return m;
}

// Operands in shared memory, both K-major in wgmma's canonical layout
// without swizzle: core matrices of 8 rows x 16 bytes (128 contiguous
// bytes), the two 16-byte halves of a 32-deep step 128 bytes apart (LBO),
// groups of 8 rows 8 * KP bytes apart (SBO).  Element (row, k) of a matrix
// of depth K is at (row / 8) * 8 KP + (k / 16) * 128 + (row % 8) * 16
// + k % 16, KP = max(K, 32): a depth of 16 is padded to one step.  A weight
// matrix (K x K) has its rows padded to a multiple of 64 (wgmma's M) with
// zeros; an operand X (K x N) has N >= 32 columns (wgmma's N here).
__host__ __device__ __forceinline__ int fs_kp(int K) { return K < 32 ? 32 : K; }
__host__ __device__ __forceinline__ int fs_mp(int K) { return (K + 63) & ~63; }
__host__ __device__ __forceinline__ int fs_np(int N) { return N < 32 ? 32 : N; }

// byte offset of element (row, k) in a plane of depth K
__device__ __forceinline__ int wg_at(int row, int k, int K) {
    return (row >> 3) * 8 * fs_kp(K) + ((k >> 4) << 7) + ((row & 7) << 4)
           + (k & 15);
}

// bytes of the five digit planes of a K x K weight matrix
__host__ __device__ __forceinline__ int weight_bytes(int K) {
    return FS_NDIG * fs_mp(K) * fs_kp(K);
}

// The matrix descriptor of a K-major operand at p (shared memory), 8-row
// groups `sbo` bytes apart, no swizzle: start address, LBO = 128 and SBO in
// 16-byte units (bits 0-13, 16-29, 32-45), layout type 0.
__device__ __forceinline__ u64 wg_desc(const void* p, unsigned sbo) {
    return (u64)((smem_u32(p) >> 4) & 0x3FFF) | ((u64)(128 >> 4) << 16)
           | ((u64)((sbo >> 4) & 0x3FFF) << 32);
}

// d (+)= A (64 x 32, rows of W) * B (32 x 32, columns of X), s32 += u8 * u8,
// on the tensor cores, asynchronously; ACC 0 overwrites d.  A's and B's
// descriptors are wa + AOFF and xb + BOFF (offsets in 16-byte units of the
// start address), the offsets immediates of the instruction: as registers,
// the compiler holds every one of a tile's instructions' offsets at once.
// Accumulator layout (warp w of the warpgroup, g = lane / 4, t = lane % 4):
// d[4 jb + 2 v1 + v0] is (row 16 w + g + 8 v1, column 8 jb + 2 t + v0).
template <int AOFF, int BOFF, int ACC>
__device__ __forceinline__ void wgmma_u8(int (&d)[16], u64 wa, u64 xb) {
    asm volatile(
        "{\n.reg .pred p;\n.reg .b64 da, db;\n"
        "setp.ne.b32 p, %18, 0;\n"
        "add.s64 da, %16, %19;\nadd.s64 db, %17, %20;\n"
        "wgmma.mma_async.sync.aligned.m64n32k32.s32.u8.u8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15}, da, db, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
          "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
          "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
          "+r"(d[15])
        : "l"(wa), "l"(xb), "r"(ACC), "n"(AOFF), "n"(BOFF));
}

// the accumulators as the compiler must see them: written by the asm
// before, read only after
__device__ __forceinline__ void wg_hold(int (&d)[16]) {
#pragma unroll
    for (int e = 0; e < 16; ++e) asm volatile("" : "+r"(d[e]) :: "memory");
}

// the grid word w (with its beta = 40 Shoup word ws) times a lazy a < 1.5p,
// canonical
__device__ __forceinline__ u64 grid_mul(double a, u64 w, u64 ws,
                                        const Mod52& m) {
    const double t = shoup40_d(a, exact_double(w),
                               exact_double(ws) * 0x1p-40, m.p);
    return exact_u64(csub_d(t, m.p));        // t < 1.1875p
}

__device__ __forceinline__ u64 canonical(double a, const Mod52& m) {
    return exact_u64(csub_d(a, m.p));        // a < 1.5p
}

// The digits of two canonical words v0, v1 (< 2^37) of neighbouring depths
// of one column, a 16-bit store a digit plane.
__device__ __forceinline__ void put_pair(u8* X, int plane, int at, u64 v0,
                                         u64 v1) {
    const u32 l0 = (u32)v0, l1 = (u32)v1;
#pragma unroll
    for (int d = 0; d < FS_NDIG - 1; ++d)
        *reinterpret_cast<unsigned short*>(X + d * plane + at) =
            (unsigned short)__byte_perm(l0, l1, d | ((d + 4) << 4));
    *reinterpret_cast<unsigned short*>(X + (FS_NDIG - 1) * plane + at) =
        (unsigned short)((u32)(v0 >> 32) | ((u32)(v1 >> 32) << 8));
}

// A raw row (generic pointer: the staging buffer, or device memory) into
// the first product's operand X (K x N, element (column a, depth b) at
// wg_at(a, b, K)).  Raw word (a, b) is at b * C + a (forward: the
// r-product, b = r, a = c) or a * C + b (inverse: the c-product, b = c,
// a = r).  A thread takes four consecutive depths of one column and writes
// one 32-bit word a digit plane; a warp fills one core matrix, 32 banks.
template <bool INVERSE>
__device__ __forceinline__ void split_row(const u64* raw, u8* X, int K, int N,
                                          int C) {
    const int plane = fs_np(N) * fs_kp(K), kchunks = K >> 4;
    for (int u = threadIdx.x; u < N * (K >> 2); u += FS8_THREADS) {
        const int core = u >> 5, kc = core % kchunks;
        const int a = ((core / kchunks) << 3) + ((u >> 2) & 7);
        const int b = (kc << 4) + ((u & 3) << 2);
        u64 v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
            v[j] = INVERSE ? raw[a * C + b + j] : raw[(b + j) * C + a];
        const u32 x0 = (u32)v[0], x1 = (u32)v[1], x2 = (u32)v[2],
                  x3 = (u32)v[3];
        u32* dst = reinterpret_cast<u32*>(X + wg_at(a, b, K));
#pragma unroll
        for (int d = 0; d < FS_NDIG - 1; ++d) {
            const int sel = d | ((d + 4) << 4);
            dst[d * (plane >> 2)] = __byte_perm(__byte_perm(x0, x1, sel),
                                                __byte_perm(x2, x3, sel),
                                                0x5410);
        }
        dst[(FS_NDIG - 1) * (plane >> 2)] =
            (u32)(v[0] >> 32) | ((u32)(v[1] >> 32) << 8)
            | ((u32)(v[2] >> 32) << 16) | ((u32)(v[3] >> 32) << 24);
    }
}

// The wgmma of group S from digit pair (DA, S - DA), step KI on: every
// digit pair of weight 256^S, each over the KS 32-deep steps, into d (the
// first overwrites it).  Digit planes of the weights W16, of the operand
// X16 16-byte units apart.
template <int S, int KS, int W16, int X16, int DA, int KI>
__device__ __forceinline__ void wg_issue(int (&d)[16], u64 wa, u64 xb) {
    constexpr int LO = S > 4 ? S - 4 : 0, HI = S < 4 ? S : 4;
    wgmma_u8<DA * W16 + 16 * KI, (S - DA) * X16 + 16 * KI,
             (DA != LO || KI != 0)>(d, wa, xb);
    if constexpr (KI + 1 < KS)
        wg_issue<S, KS, W16, X16, DA, KI + 1>(d, wa, xb);
    else if constexpr (DA < HI)
        wg_issue<S, KS, W16, X16, DA + 1, 0>(d, wa, xb);
}

// group S, fenced and committed
template <int S, int KS, int W16, int X16>
__device__ __forceinline__ void wg_group(int (&d)[16], u64 wa, u64 xb) {
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
    wg_issue<S, KS, W16, X16, (S > 4 ? S - 4 : 0), 0>(d, wa, xb);
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

// Folds group s's sums S (s32, below 2^26) into x, one 64-bit word an
// output, the groups coming in the order s = 8, 7, ..., 0, each a multiply-
// add of S by a power of two on the integer pipe.  s = 8 .. 4:
// x = hi = S_4 + S_5 2^8 + ... + S_8 2^32 < 2^50 (digit 4 of a canonical
// word is below 2^5); after s = 4, hi * 2^32 mod p lazily by a beta = 52
// Shoup product with c32 = 2^32 mod p on the FP64 pipe, r1 in [0, 2p);
// s = 3 .. 0: x = r1 + S_3 2^24 + ... + S_0 < 2^51.
__device__ __forceinline__ void wg_fold(u64 (&x)[16], int (&d)[16], int s,
                                        const Mod52& m) {
    wg_hold(d);
#pragma unroll
    for (int e = 0; e < 16; ++e) {
        const u64 v = (u64)(u32)d[e];
        if (s == 8) x[e] = v << 32;
        else x[e] += v << (8 * (s >= 4 ? s - 4 : s));
    }
    if (s != 4) return;
    // four outputs at a time: the empty asm takes a quartet's results and
    // the next quartet's inputs, so that the compiler cannot run all sixteen
    // products side by side and spill their temporaries
#pragma unroll
    for (int c = 0; c < 16; c += 4) {
#pragma unroll
        for (int e = c; e < c + 4; ++e)
            x[e] = exact_u64(shoup40_d(exact_double(x[e]), m.c32, m.c32s,
                                       m.p));
        if (c + 4 < 16)
            asm volatile("" : "+l"(x[c]), "+l"(x[c + 1]), "+l"(x[c + 2]),
                         "+l"(x[c + 3]), "+l"(x[c + 4]), "+l"(x[c + 5]),
                         "+l"(x[c + 6]), "+l"(x[c + 7]));
    }
}

// out = W @ X for the `rows` operands X0 + row * slot of a batch (each
// K x N, KS = max(K, 32) / 32 steps deep), W (K x K, digit planes of
// weight_bytes(K) / 5 bytes) in shared memory.  Each warpgroup takes
// 64 x 32 output tiles in turn; the nine groups of a tile alternate between
// two sets of accumulators, so that one group runs on the tensor cores
// while the one before is folded (wg_fold).  Each output pair (i, j),
// (i, j + 1) inside the matrices goes to epi(row, i, j, v0, v1), each v
// x - floor(x * pinv) * p in [0, 1.5p) (x < 2^51), on the FP64 pipe.
template <int Q, int KS, int W16, int X16>
__device__ __forceinline__ void wg_groups(int (&acc0)[16], int (&acc1)[16],
                                          u64 (&x)[16], u64 wa, u64 xb,
                                          const Mod52& m) {
    constexpr int S = FS_SUMS - 1 - Q;
    if constexpr (Q + 1 < FS_SUMS) {
        if constexpr (Q & 1) wg_group<S - 1, KS, W16, X16>(acc0, wa, xb);
        else wg_group<S - 1, KS, W16, X16>(acc1, wa, xb);
        asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
    } else {
        asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    }
    if constexpr (Q & 1) wg_fold(x, acc1, S, m);
    else wg_fold(x, acc0, S, m);
    if constexpr (Q + 1 < FS_SUMS)
        wg_groups<Q + 1, KS, W16, X16>(acc0, acc1, x, wa, xb, m);
}

template <int KS, int KSN, class Epi>
__device__ __forceinline__ void wg_product_k(const u8* X0, int slot, int rows,
                                             int K, int N, const u8* W,
                                             const Mod52& m, Epi epi) {
    // the warpgroup's index, broadcast so that the compiler knows it is the
    // same in every lane: the descriptors then live in uniform registers
    const int wg = __shfl_sync(0xffffffffu, threadIdx.x >> 7, 0);
    const int w = (threadIdx.x >> 5) & 3;
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const int KP = 32 * KS, mtiles = fs_mp(K) >> 6, ntiles = fs_np(N) >> 5;
    // digit planes 16-byte units apart: weights fs_mp(K) x KP, operand
    // fs_np(N) x KP (KSN: the steps of N's side, which fix fs_np(N))
    constexpr int W16 = (32 * (KS < 2 ? 2 : KS) * 32 * KS) >> 4;
    constexpr int X16 = (32 * KSN * 32 * KS) >> 4;
    const unsigned sbo = 8u * KP;
    for (int task = wg; task < rows * mtiles * ntiles;
         task += FS8_THREADS >> 7) {
        const int row = task / (mtiles * ntiles);
        const int rest = task - row * mtiles * ntiles;
        const int mt = rest / ntiles, nt = rest - mt * ntiles;
        const u64 wa = wg_desc(W + mt * 64 * KP, sbo);
        const u64 xb = wg_desc(X0 + row * slot + nt * 32 * KP, sbo);
        int acc0[16], acc1[16];
        u64 x[16];
        wg_group<FS_SUMS - 1, KS, W16, X16>(acc0, wa, xb);
        wg_groups<0, KS, W16, X16>(acc0, acc1, x, wa, xb, m);
#pragma unroll
        for (int jb = 0; jb < 4; ++jb) {
#pragma unroll
            for (int v1 = 0; v1 < 2; ++v1) {
                const int i = mt * 64 + 16 * w + g + 8 * v1;
                const int j = nt * 32 + 8 * jb + 2 * t;
                if (i >= K || j >= N) continue;
                double v[2];
#pragma unroll
                for (int v0 = 0; v0 < 2; ++v0) {
                    const double xe = exact_double(x[4 * jb + 2 * v1 + v0]);
                    const double q = __dsub_rn(__fma_rd(xe, m.pinv, 0x1p52),
                                               0x1p52);
                    v[v0] = __fma_rn(-q, m.p, xe);
                }
                epi(row, i, j, v[0], v[1]);
            }
        }
    }
}

// Rows of a batch and whether they are staged, for sides R, C: as many rows
// (up to FS_MAX_ROWS) as fit beside the weights with their planes and
// staging buffers; else one row without staging; else 0.
struct Fit {
    int rows, staged;
};

// the two operands' digit planes of one row
__host__ __device__ __forceinline__ int fs_slot(int R, int C) {
    return FS_NDIG * (fs_np(C) * fs_kp(R) + fs_np(R) * fs_kp(C));
}

static Fit four_step_fit(int R, int C) {
    const long long fixed = FS_BARRIER_BYTES + weight_bytes(R)
                            + weight_bytes(C);
    const long long slot = fs_slot(R, C), stage = 8LL * R * C;
    long long rows = (FS_MAX_SMEM - fixed) / (slot + stage);
    if (rows > FS_MAX_ROWS) rows = FS_MAX_ROWS;
    if (rows >= 1) return {(int)rows, 1};
    return {fixed + slot <= FS_MAX_SMEM ? 1 : 0, 0};
}

static long long four_step_smem(int R, int C, Fit f) {
    return FS_BARRIER_BYTES + weight_bytes(R) + weight_bytes(C)
           + (long long)f.rows * (fs_slot(R, C) + (f.staged ? 8LL * R * C
                                                            : 0));
}

// Shared memory: two mbarriers (weights, staged rows), Wr and Wc's digit
// planes, `rows` slots of the two operands' planes, `rows` staging buffers
// of n words if staged.  grid and grid_s are in the first product's output
// order: T (R x C) forward, T' transposed (C x R) inverse.  KSR, KSC: the
// 32-deep steps of the r- and c-product, max(R, 32) / 32 and max(C, 32) / 32
// (one instance for each pair: the products' loops then unroll fully).
template <bool INVERSE, int KSR, int KSC>
__global__ void __launch_bounds__(FS8_THREADS, 1)
four_step_kernel(const u64* __restrict__ in, u64* __restrict__ out, int L,
                 int R, int C, int rows, int staged, long long groups,
                 long long in_gstride, const u64* __restrict__ scal,
                 const u8* __restrict__ w_r, const u8* __restrict__ w_c,
                 const u64* __restrict__ grid,
                 const u64* __restrict__ grid_s) {
    extern __shared__ __align__(16) u8 smem[];
    u64* bars = reinterpret_cast<u64*>(smem);
    const int n = R * C, lc = __ffs(C) - 1;
    const int wr_bytes = weight_bytes(R), wc_bytes = weight_bytes(C);
    u8* Wr = smem + FS_BARRIER_BYTES;
    u8* Wc = Wr + wr_bytes;
    const int r_plane = fs_np(C) * fs_kp(R), c_plane = fs_np(R) * fs_kp(C);
    const int slot = fs_slot(R, C);
    u8* Xr = Wc + wc_bytes;                       // r-product's operand
    u8* Xc = Xr + FS_NDIG * r_plane;              // c-product's operand
    u64* stage = reinterpret_cast<u64*>(Xr + rows * slot);

    const int l = blockIdx.x % L;
    const long long first = blockIdx.x / L, step = gridDim.x / L;
    const long long count = (groups - first + step - 1) / step;   // >= 1
    const Mod52 m = mod52(scal, l);
    const u64* src = in + first * in_gstride + (long long)l * n;
    u64* dst = out + (first * L + l) * n;
    const long long src_step = step * in_gstride, dst_step = step * L * n;
    const u64* __restrict__ G = grid + (long long)l * n;
    const u64* __restrict__ Gs = grid_s + (long long)l * n;
    const unsigned row_bytes = 8u * (unsigned)n;

    // thread 0: the raw rows i0 .. of a batch into the staging buffers
    auto issue = [&](long long i0) {
        const int nr = (int)(count - i0 < rows ? count - i0 : rows);
        mbar_expect_tx(&bars[1], (unsigned)nr * row_bytes);
        for (int r = 0; r < nr; ++r)
            bulk_load(stage + (long long)r * n, src + (i0 + r) * src_step,
                      row_bytes, &bars[1]);
    };
    if (threadIdx.x == 0) {
        mbar_init(&bars[0], 1);
        mbar_init(&bars[1], 1);
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        mbar_expect_tx(&bars[0], (unsigned)(wr_bytes + wc_bytes));
        bulk_load(Wr, w_r + (long long)l * wr_bytes, (unsigned)wr_bytes,
                  &bars[0]);
        bulk_load(Wc, w_c + (long long)l * wc_bytes, (unsigned)wc_bytes,
                  &bars[0]);
        if (staged) issue(0);
    }
    mbar_wait(&bars[0], 0);

    int batch = 0;
    for (long long i0 = 0; i0 < count; i0 += rows, ++batch) {
        const int nr = (int)(count - i0 < rows ? count - i0 : rows);
        if (staged) mbar_wait(&bars[1], (unsigned)(batch & 1));
        for (int r = 0; r < nr; ++r) {
            const u64* raw = staged ? stage + (long long)r * n
                                    : src + (i0 + r) * src_step;
            if (INVERSE) split_row<true>(raw, Xc + r * slot, C, R, C);
            else split_row<false>(raw, Xr + r * slot, R, C, C);
        }
        // the planes' ordinary stores, then wgmma's reads of them (the async
        // proxy); the staging buffers are free for the next batch, whose
        // copies overlap this batch's products; the previous batch's second
        // product is done with its planes
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        __syncthreads();
        if (staged && threadIdx.x == 0 && i0 + rows < count) issue(i0 + rows);
        if (!INVERSE) {
            // Y = T (*) (A @ M): output (i, j) is (r = i, c = j), into the
            // c-product's operand as (column r, depth c)
            wg_product_k<KSR, KSC>(Xr, slot, nr, R, C, Wr, m,
                       [&](int row, int i, int j, double v0, double v1) {
                const int idx = (i << lc) + j;
                const ulonglong2 w = *reinterpret_cast<const ulonglong2*>(G + idx);
                const ulonglong2 ws = *reinterpret_cast<const ulonglong2*>(Gs + idx);
                put_pair(Xc + row * slot, c_plane, wg_at(i, j, C),
                         grid_mul(v0, w.x, ws.x, m), grid_mul(v1, w.y, ws.y, m));
            });
            asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
            __syncthreads();
            // Z^T = B0 @ Y^T: output (i, j) is (r = j, c = i)
            wg_product_k<KSC, KSR>(Xc, slot, nr, C, R, Wc, m,
                       [&](int row, int i, int j, double v0, double v1) {
                u64* d = dst + (i0 + row) * dst_step;
                d[(j << lc) + i] = canonical(v0, m);
                d[((j + 1) << lc) + i] = canonical(v1, m);
            });
        } else {
            // Z^T = T'^T (*) (B0' @ M^T): output (i, j) is (c = i, r = j),
            // its grid word at i * R + j, into the r-product's operand as
            // (column c, depth r)
            wg_product_k<KSC, KSR>(Xc, slot, nr, C, R, Wc, m,
                       [&](int row, int i, int j, double v0, double v1) {
                const int idx = i * R + j;
                const ulonglong2 w = *reinterpret_cast<const ulonglong2*>(G + idx);
                const ulonglong2 ws = *reinterpret_cast<const ulonglong2*>(Gs + idx);
                put_pair(Xr + row * slot, r_plane, wg_at(i, j, R),
                         grid_mul(v0, w.x, ws.x, m), grid_mul(v1, w.y, ws.y, m));
            });
            asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
            __syncthreads();
            // X = A' @ Z: output (i, j) is (r = i, c = j)
            wg_product_k<KSR, KSC>(Xr, slot, nr, R, C, Wr, m,
                       [&](int row, int i, int j, double v0, double v1) {
                u64* d = dst + (i0 + row) * dst_step + (i << lc) + j;
                *reinterpret_cast<ulonglong2*>(d) =
                    make_ulonglong2(canonical(v0, m), canonical(v1, m));
            });
        }
    }
}

static bool kernel_side(int x) {
    return x == 16 || x == 32 || x == 64 || x == 128;
}

template <class Kernel>
static int prepare_launch(Kernel kernel, long long smem, long long rows,
                          int L) {
    if (L < 1 || rows < 0 || rows % L != 0 || rows > 0x7fffffffLL
            || smem > FS_MAX_SMEM)
        return (int)cudaErrorInvalidValue;
    if (smem > 48 * 1024) {   // more than a block gets without asking; the
                              // attribute is the device's, so set it each time
        cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    return (int)cudaSuccess;
}

static int side_index(int x) {
    return x == 16 ? 0 : x == 32 ? 1 : x == 64 ? 2 : 3;
}

typedef void (*Kernel8)(const u64*, u64*, int, int, int, int, int, long long,
                        long long, const u64*, const u8*, const u8*,
                        const u64*, const u64*);

// 32-deep steps of a product over a side of 16, 32, 64 or 128
static int ksteps(int K) { return K <= 32 ? 1 : K >> 5; }

// kernel 8's instance for the two products' steps (R = C = 128 has none)
template <bool INVERSE, int KSR>
static Kernel8 kernel8_c(int ksc) {
    if (ksc == 1) return four_step_kernel<INVERSE, KSR, 1>;
    if (ksc == 2) return four_step_kernel<INVERSE, KSR, 2>;
    if constexpr (KSR < 4) return four_step_kernel<INVERSE, KSR, 4>;
    return nullptr;
}

template <bool INVERSE>
static Kernel8 kernel8(int R, int C) {
    const int ksr = ksteps(R), ksc = ksteps(C);
    if (ksr == 1) return kernel8_c<INVERSE, 1>(ksc);
    if (ksr == 2) return kernel8_c<INVERSE, 2>(ksc);
    return kernel8_c<INVERSE, 4>(ksc);
}

template <bool INVERSE>
static int launch_four_step(const void* in, void* out, long long rows, int L,
                            int R, int C, long long in_gstride,
                            const void* scal, const void* w_r,
                            const void* w_c, const void* grid,
                            const void* grid_s, void* stream) {
    if (!kernel_side(R) || !kernel_side(C) || L < 1 || rows < 0
            || rows % L != 0 || rows > 0x7fffffffLL)
        return (int)cudaErrorInvalidValue;
    const Fit f = four_step_fit(R, C);
    const Kernel8 kern = kernel8<INVERSE>(R, C);
    if (f.rows < 1 || kern == nullptr) return (int)cudaErrorInvalidValue;
    if (rows == 0) return (int)cudaSuccess;
    const long long smem = four_step_smem(R, C, f);
    // The blocks the card holds at once, found once for each card and
    // (R, C), as in ntt.cu: set-up kept out of every later launch.
    static int capacity[FS_CACHED_DEVICES][4][4];
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    int* slot = dev < FS_CACHED_DEVICES
        ? &capacity[dev][side_index(R)][side_index(C)] : nullptr;
    int cap = slot ? *slot : 0;
    if (cap == 0) {
        e = cudaFuncSetAttribute(kern,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 FS_MAX_SMEM);
        int sms = 0, per_sm = 0;
        if (e == cudaSuccess)
            e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                       dev);
        if (e == cudaSuccess)
            e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &per_sm, kern, FS8_THREADS, (size_t)smem);
        if (e != cudaSuccess) return (int)e;
        cap = sms * per_sm;
        if (cap < 1) return (int)cudaErrorInvalidConfiguration;
        if (slot) *slot = cap;
    }
    // as many blocks as the card holds, a multiple of L, each limb's blocks
    // at most its rows
    const long long groups = rows / L;
    long long per_limb = cap / L;
    if (per_limb > groups) per_limb = groups;
    if (per_limb < 1) per_limb = 1;
    kern<<<(unsigned)(per_limb * L), FS8_THREADS, (size_t)smem,
           (cudaStream_t)stream>>>(
        (const u64*)in, (u64*)out, L, R, C, f.rows, f.staged, groups,
        in_gstride, (const u64*)scal, (const u8*)w_r, (const u8*)w_c,
        (const u64*)grid, (const u64*)grid_s);
    return (int)cudaGetLastError();
}

extern "C" {

// kernel 8's batch at sides R, C: rows, whether staged, shared-memory bytes
// (rows 0: R, C is refused)
void fhe_four_step_fit(int R, int C, int* out) {
    const Fit f = kernel_side(R) && kernel_side(C) ? four_step_fit(R, C)
                                                   : Fit{0, 0};
    out[0] = f.rows;
    out[1] = f.staged;
    out[2] = f.rows ? (int)four_step_smem(R, C, f) : 0;
}

int fhe_four_step_ntt(const void* in, void* out, long long rows, int L, int R,
                      int C, long long in_gstride, const void* scal,
                      const void* w_r, const void* w_c, const void* grid,
                      const void* grid_s, int inverse, void* stream) {
    return inverse
        ? launch_four_step<true>(in, out, rows, L, R, C, in_gstride, scal, w_r,
                                 w_c, grid, grid_s, stream)
        : launch_four_step<false>(in, out, rows, L, R, C, in_gstride, scal,
                                  w_r, w_c, grid, grid_s, stream);
}

int fhe_four_step_phase(const void* in, void* out, long long rows, int L,
                        int K, int J, long long in_gstride, const void* scal,
                        const void* w, const void* grid, const void* grid_s,
                        int mode, void* stream) {
    if (!kernel_side(K) || !kernel_side(J) || mode < 0 || mode > 2
            || (mode != 0 && (grid == nullptr || grid_s == nullptr)))
        return (int)cudaErrorInvalidValue;
    const long long smem = (long long)FS_NDIG * J * (K + FS_PAD);
    const int rc = prepare_launch(four_step_phase_kernel, smem, rows, L);
    if (rc != (int)cudaSuccess || rows == 0) return rc;
    four_step_phase_kernel<<<(unsigned)rows, FS_THREADS, (size_t)smem,
                             (cudaStream_t)stream>>>(
        (const u64*)in, (u64*)out, L, K, J, in_gstride, (const u64*)scal,
        (const u8*)w, (const u64*)grid, (const u64*)grid_s, mode);
    return (int)cudaGetLastError();
}

}  // extern "C"
