// Four-step negacyclic NTT over stacks of RNS limbs on the integer tensor
// cores, for Hopper (sm_90a).
//
//   four_step_kernel<false>  replaces PallasNtt._fused_call, forward
//   four_step_kernel<true>   replaces PallasNtt._fused_call, inverse
//                            (_fused_kernel_factory of
//                            fhe_precompiles_tpu/ops/pallas_ntt.py)
//   four_step_phase_kernel   replaces PallasNtt._phase
//                            (_phase_kernel_factory, modes none/pre/post):
//                            kernel 9, one product a launch
//
// What they compute (ops/four_step.py holds the tables and the plain
// versions).  A row of n = R * C words, reduced mod p of its limb, is the
// R x C matrix M.  Forward: Z = (T (*) (A @ M)) @ B0^T; inverse:
// X = A' @ (T' (*) (M @ B0'^T)), with n^-1 times the caller's factor inside
// A'.  A, B0, A', B0' come as five base-256 digit planes (uint8), T and T'
// as words with their Shoup companions.  Canonical residues in and out;
// moduli below 2^37.  The phase kernel runs one product W @ X over a K x J
// matrix, with the grid G multiplied in before it (mode 1, "pre":
// W @ (G (*) X)), after it (mode 2, "post": G (*) (W @ X)) or not at all
// (0): the two-launch form of the transform.
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
// Both kernels began as a block a row on mma.sync, the A fragments
// fetched again for every tile of every row, and a 64-bit Barrett epilogue
// on the integer pipe; what held them back was latency.  Kernel 8 (the
// whole transform) is now, and kernel 9 (one product) is built of the same
// pieces:
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
// Kernel 9 is the same for one product, in blocks of two warpgroups, two
// blocks an SM where their shared memory fits (one block's waits for its
// copies then overlap the other's arithmetic; one block of four
// warpgroups an SM measured slower): the limb's weight matrix and its grid
// words staged once a block; each batch's raw rows brought by TMA into a
// staging buffer, the next batch's while this one computes; in mode 1 the
// split multiplies each word by its grid word first; the epilogue makes
// the lazy value canonical, or multiplies it by its grid word (mode 2),
// and stores the output pair (i, j), (i, j + 1) of the row-major K x J
// matrix as one 16-byte word (TMA bulk stores of a staged row measured
// slower).  Its grid product is an exact FP64 Barrett product from the
// word alone (grid_mul_w), so that the grid is 8 bytes a word and fits
// in shared memory (word and Shoup word read from device memory cost as
// much time as the product).
// Shared memory (phase_fit): FS_BARRIER_BYTES, the weights, the grid (8KJ
// bytes) where it fits, then per row of a batch the operand's planes
// (5 max(J, 32) max(K, 32) bytes) and an 8KJ-byte staging buffer where it
// fits: K = J = 64, one row, both staged, 106,512 bytes, two blocks an SM;
// K = 128, J = 64, two rows, grid staged, rows not, 229,392, one block;
// K = J = 128, one row, neither, 163,856.
//
// Shared memory of kernel 8 (FS_BARRIER_BYTES, the weights, then per row of
// a batch the two operands' planes and an 8n-byte staging buffer; a weight
// matrix's rows padded to a multiple of 64, a depth of 16 to 32, an operand
// to 32 columns): n = 4096 (R = C = 64): 40,960 bytes of weights, 40,960 of
// planes and 32,768 of staging a row: two rows, 188,432 bytes.  n = 8192
// (R = 128, C = 64): 102,400 of weights, 81,920 of planes: one row,
// unstaged, 184,336 bytes.  R = C = 128 does not fit and is refused.
//
// What bounds them, by count: at n = 4096 the bytes (a row read and
// written once, 16 bytes a word; kernel 9 also reads its grid); then the
// tensor cores (25 n K u8 multiply-adds a row and product) and the FP64
// pipe (8 multiply-adds an output word and product, 4 more a grid
// product).  What they spend more than that, and where: PERF.md, from
// chip_compare.py's ablations.
//
// Plain C interface, as in ntt.cu: raw pointers and the stream in,
// cudaGetLastError() out, no synchronisation.  R and C (K and J) must be
// 16, 32, 64 or 128.
#include <cuda_runtime.h>
#include "modmath.cuh"
#include "tma.cuh"

typedef unsigned int u32;
typedef unsigned char u8;

#define FS_NDIG 5
#define FS_SUMS (2 * FS_NDIG - 1)
#define FS_MAX_SMEM 232448          // what one block may use on sm_90
// threads of a block (four warpgroups, one block an SM), rows a batch at
// most, the mbarriers ahead of the weights, cards whose launch geometry is
// kept
#define FS_THREADS 512
#define FS_MAX_ROWS 4
#define FS_BARRIER_BYTES 16
#define FS_CACHED_DEVICES 64
// kernel 9: threads of a block (two warpgroups), so that two blocks share
// an SM where their shared memory fits (an SM's 233,472 bytes, 1,024 of
// them kept by the card for each block): one block's waits for its copies
// overlap the other's arithmetic
#define FS_PHASE_THREADS 256
#define FS_SM_SMEM 233472
#define FS_BLOCK_RESERVED 1024

// ---------------------------------------------------------------------------
// the pieces of kernels 8 and 9: persistent blocks, wgmma
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

// The digits of four canonical words v (< 2^37) of neighbouring depths of
// one column, a 32-bit store a digit plane at X + at, planes `plane` bytes
// apart.
__device__ __forceinline__ void put_quad(u8* X, int plane, int at,
                                         const u64 (&v)[4]) {
    const u32 x0 = (u32)v[0], x1 = (u32)v[1], x2 = (u32)v[2], x3 = (u32)v[3];
    u32* dst = reinterpret_cast<u32*>(X + at);
#pragma unroll
    for (int d = 0; d < FS_NDIG - 1; ++d) {
        const int sel = d | ((d + 4) << 4);
        dst[d * (plane >> 2)] = __byte_perm(__byte_perm(x0, x1, sel),
                                            __byte_perm(x2, x3, sel), 0x5410);
    }
    dst[(FS_NDIG - 1) * (plane >> 2)] =
        (u32)(v[0] >> 32) | ((u32)(v[1] >> 32) << 8)
        | ((u32)(v[2] >> 32) << 16) | ((u32)(v[3] >> 32) << 24);
}

// Where thread slot u of a split writes in an operand of depth K: four
// consecutive depths b .. b + 3 of column a.  A warp fills one core matrix,
// 32 banks.
__device__ __forceinline__ void split_slot(int u, int K, int& a, int& b) {
    const int kchunks = K >> 4, core = u >> 5, kc = core % kchunks;
    a = ((core / kchunks) << 3) + ((u >> 2) & 7);
    b = (kc << 4) + ((u & 3) << 2);
}

// A raw row (generic pointer: the staging buffer, or device memory) into
// the first product's operand X (K x N, element (column a, depth b) at
// wg_at(a, b, K)).  Raw word (a, b) is at b * C + a (forward: the
// r-product, b = r, a = c) or a * C + b (inverse: the c-product, b = c,
// a = r).
template <bool INVERSE>
__device__ __forceinline__ void split_row(const u64* raw, u8* X, int K, int N,
                                          int C) {
    const int plane = fs_np(N) * fs_kp(K);
    for (int u = threadIdx.x; u < N * (K >> 2); u += FS_THREADS) {
        int a, b;
        split_slot(u, K, a, b);
        u64 v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
            v[j] = INVERSE ? raw[a * C + b + j] : raw[(b + j) * C + a];
        put_quad(X, plane, wg_at(a, b, K), v);
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

template <int KS, int KSN, int THREADS = FS_THREADS, class Epi>
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
         task += THREADS >> 7) {
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
__global__ void __launch_bounds__(FS_THREADS, 1)
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

// ---------------------------------------------------------------------------
// kernel 9: one product a launch
// ---------------------------------------------------------------------------
// a * w mod p, canonical, for a lazy a < 1.5p and a canonical grid word w,
// from the word alone (kernel 9 keeps no Shoup words, so that the grid is
// 8 bytes a word), on the FP64 pipe: h = a w rounded, its error
// l = a w - h (exact: a w < 2^75, |l| <= 2^21); q = floor(h * rinv) with
// rinv = 1 / p rounded, within one of floor(a w / p) (h * rinv is a w / p
// within 2^-14), less one; r = h - q p (exact: an integer below 2^53)
// plus l is a w - q p, in [0, 3p), read back through 2^52.  The two
// conditional subtracts on the integer pipe (p: the modulus as an
// integer), which leaves the FP64 pipe to the rest of the split and the
// epilogue.
__device__ __forceinline__ u64 grid_mul_w(double a, u64 w, double rinv,
                                          const Mod52& m, u64 p) {
    const double wd = exact_double(w);
    const double h = __dmul_rn(a, wd);
    const double l = __fma_rn(a, wd, -h);
    const double q = __dsub_rn(__fma_rd(h, rinv, 0x1p52), 0x1p52 + 1.0);
    const double r = __dadd_rn(__fma_rn(-q, m.p, h), __dadd_rn(l, 0x1p52));
    return csub(csub((u64)__double_as_longlong(r) & 0xFFFFFFFFFFFFFull, p),
                p);
}

// A batch's raw rows (row r at raw + r * raw_step: the staging buffer, or
// device memory) into their operands X0 + r * slot (K x J, element
// (column j, depth k) at wg_at(j, k, K)) from raw word k * J + j, as
// split_row<false> does.  PRE: each word first times its grid word
// G[k * J + j] (grid_mul_w; a canonical word meets its a < 1.5p), the grid
// words loaded once for all the batch's rows.
template <bool PRE>
__device__ __forceinline__ void split_batch(const u64* raw,
                                            long long raw_step, int rows,
                                            u8* X0, int slot, int K, int J,
                                            const u64* G, double rinv,
                                            const Mod52& m, u64 p) {
    const int plane = fs_np(J) * fs_kp(K);
    // four slots a thread in flight (a row of 64 x 64 at once)
#pragma unroll 4
    for (int u = threadIdx.x; u < J * (K >> 2); u += FS_PHASE_THREADS) {
        int a, b;
        split_slot(u, K, a, b);
        const int at = wg_at(a, b, K);
        u64 g[4];
        if (PRE) {
#pragma unroll
            for (int q = 0; q < 4; ++q) g[q] = G[(b + q) * J + a];
        }
#pragma unroll
        for (int r = 0; r < FS_MAX_ROWS; ++r) {
            if (r >= rows) break;
            u64 v[4];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                v[q] = raw[r * raw_step + (b + q) * J + a];
                if (PRE)
                    v[q] = grid_mul_w(exact_double(v[q]), g[q], rinv, m, p);
            }
            put_quad(X0 + r * slot, plane, at, v);
        }
    }
}

// out = W @ (G (*) X) (mode 1), G (*) (W @ X) (mode 2) or W @ X (mode 0)
// over each K x J matrix of a stack (groups, L, K, J), the input's groups
// in_gstride words apart.  Shared memory: two mbarriers (weights and grid,
// staged rows), W's digit planes, the limb's K x J grid words if
// grid_staged (else they are read from device memory), `rows` operands'
// planes, `rows` input staging buffers of n = K J words if in_staged.  The
// outputs go out as 16-byte stores: measured against TMA bulk stores of a
// staged row, they were faster.  KS, KSN: the 32-deep steps of K and of J,
// max(K, 32) / 32 and max(J, 32) / 32 (one instance for each pair).  mode
// is the same for every thread.
template <int KS, int KSN>
__global__ void __launch_bounds__(FS_PHASE_THREADS, 2)
four_step_phase_kernel(const u64* __restrict__ in, u64* __restrict__ out,
                       int L, int K, int J, int rows, int grid_staged,
                       int in_staged, long long groups, long long in_gstride,
                       const u64* __restrict__ scal, const u8* __restrict__ w,
                       const u64* __restrict__ grid, int mode) {
    extern __shared__ __align__(16) u8 smem[];
    u64* bars = reinterpret_cast<u64*>(smem);
    const int n = K * J, w_bytes = weight_bytes(K);
    const int slot = FS_NDIG * fs_np(J) * fs_kp(K);
    u8* W = smem + FS_BARRIER_BYTES;
    u64* G_staged = reinterpret_cast<u64*>(W + w_bytes);
    u8* X = reinterpret_cast<u8*>(G_staged + (grid_staged ? n : 0));
    u64* stage = reinterpret_cast<u64*>(X + rows * slot);

    const int l = blockIdx.x % L;
    const long long first = blockIdx.x / L, step = gridDim.x / L;
    const long long count = (groups - first + step - 1) / step;   // >= 1
    const Mod52 m = mod52(scal, l);
    const u64 p = scal[4 * l];
    const double rinv = __ddiv_rn(1.0, m.p);
    const u64* src = in + first * in_gstride + (long long)l * n;
    u64* dst = out + (first * L + l) * n;
    const long long src_step = step * in_gstride, dst_step = step * L * n;
    const u64* G = mode == 0 ? nullptr
                 : grid_staged ? G_staged : grid + (long long)l * n;
    const unsigned row_bytes = 8u * (unsigned)n;
    const bool load_grid = mode != 0 && grid_staged;

    // thread 0: the raw rows i0 .. of a batch into the staging buffers
    auto issue = [&](long long i0) {
        const int nr = (int)(count - i0 < rows ? count - i0 : rows);
        mbar_expect_tx(&bars[1], (unsigned)nr * row_bytes);
        for (int r = 0; r < nr; ++r)
            bulk_load(stage + (long long)r * n, src + (i0 + r) * src_step,
                      row_bytes, &bars[1]);
    };
    auto split = [&](const u64* raw, long long raw_step, int nr) {
        if (mode == 1)
            split_batch<true>(raw, raw_step, nr, X, slot, K, J, G, rinv, m,
                              p);
        else
            split_batch<false>(raw, raw_step, nr, X, slot, K, J, G, rinv, m,
                               p);
    };
    if (threadIdx.x == 0) {
        mbar_init(&bars[0], 1);
        mbar_init(&bars[1], 1);
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        mbar_expect_tx(&bars[0],
                       (unsigned)w_bytes + (load_grid ? row_bytes : 0u));
        bulk_load(W, w + (long long)l * w_bytes, (unsigned)w_bytes, &bars[0]);
        if (load_grid)
            bulk_load(G_staged, grid + (long long)l * n, row_bytes, &bars[0]);
        if (in_staged) issue(0);
    }
    mbar_wait(&bars[0], 0);

    int batch = 0;
    for (long long i0 = 0; i0 < count; i0 += rows, ++batch) {
        const int nr = (int)(count - i0 < rows ? count - i0 : rows);
        if (in_staged) {
            mbar_wait(&bars[1], (unsigned)(batch & 1));
            split(stage, n, nr);
        } else {
            split(src + i0 * src_step, src_step, nr);
        }
        // the planes' ordinary stores, then wgmma's reads of them (the async
        // proxy); the staging buffers are free for the next batch, whose
        // copies overlap this batch's product
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        __syncthreads();
        if (in_staged && threadIdx.x == 0 && i0 + rows < count)
            issue(i0 + rows);
        wg_product_k<KS, KSN, FS_PHASE_THREADS>(X, slot, nr, K, J, W, m,
                   [&](int row, int i, int j, double v0, double v1) {
            const int idx = i * J + j;
            ulonglong2 o;
            if (mode == 2) {
                const ulonglong2 g =
                    *reinterpret_cast<const ulonglong2*>(G + idx);
                o = make_ulonglong2(grid_mul_w(v0, g.x, rinv, m, p),
                                    grid_mul_w(v1, g.y, rinv, m, p));
            } else {
                o = make_ulonglong2(canonical(v0, m), canonical(v1, m));
            }
            *reinterpret_cast<ulonglong2*>(dst + (i0 + row) * dst_step
                                           + idx) = o;
        });
        __syncthreads();          // every warpgroup is done with the planes
    }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------
static bool kernel_side(int x) {
    return x == 16 || x == 32 || x == 64 || x == 128;
}

static int side_index(int x) {
    return x == 16 ? 0 : x == 32 ? 1 : x == 64 ? 2 : 3;
}

// 32-deep steps of a product over a side of 16, 32, 64 or 128
static int ksteps(int K) { return K <= 32 ? 1 : K >> 5; }

// launch geometry kept for each card and pair of sides
typedef int Capacity[FS_CACHED_DEVICES][4][4];

// The blocks of `kern` (`threads` threads, `smem` bytes each) the card
// holds at once, found once for each card and sides a, b, as in ntt.cu:
// set-up kept out of every later launch.
template <class Kernel>
static cudaError_t blocks_at_once(Kernel kern, int threads, long long smem,
                                  Capacity& cache, int a, int b, int* cap) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    int* slot = dev < FS_CACHED_DEVICES
        ? &cache[dev][side_index(a)][side_index(b)] : nullptr;
    *cap = slot ? *slot : 0;
    if (*cap) return cudaSuccess;
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             FS_MAX_SMEM);
    int sms = 0, per_sm = 0;
    if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, kern, threads, (size_t)smem);
    if (e != cudaSuccess) return e;
    *cap = sms * per_sm;
    if (*cap < 1) return cudaErrorInvalidConfiguration;
    if (slot) *slot = *cap;
    return cudaSuccess;
}

// as many blocks as the card holds, a multiple of L, each limb's blocks at
// most its rows
static unsigned persistent_blocks(int cap, long long groups, int L) {
    long long per_limb = cap / L;
    if (per_limb > groups) per_limb = groups;
    if (per_limb < 1) per_limb = 1;
    return (unsigned)(per_limb * L);
}

static bool bad_rows(long long rows, int L) {
    return L < 1 || rows < 0 || rows % L != 0 || rows > 0x7fffffffLL;
}

typedef void (*Kernel8)(const u64*, u64*, int, int, int, int, int, long long,
                        long long, const u64*, const u8*, const u8*,
                        const u64*, const u64*);

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
    if (!kernel_side(R) || !kernel_side(C) || bad_rows(rows, L))
        return (int)cudaErrorInvalidValue;
    const Fit f = four_step_fit(R, C);
    const Kernel8 kern = kernel8<INVERSE>(R, C);
    if (f.rows < 1 || kern == nullptr) return (int)cudaErrorInvalidValue;
    if (rows == 0) return (int)cudaSuccess;
    const long long smem = four_step_smem(R, C, f);
    static Capacity capacity;
    int cap = 0;
    const cudaError_t e = blocks_at_once(kern, FS_THREADS, smem, capacity, R,
                                         C, &cap);
    if (e != cudaSuccess) return (int)e;
    const long long groups = rows / L;
    kern<<<persistent_blocks(cap, groups, L), FS_THREADS, (size_t)smem,
           (cudaStream_t)stream>>>(
        (const u64*)in, (u64*)out, L, R, C, f.rows, f.staged, groups,
        in_gstride, (const u64*)scal, (const u8*)w_r, (const u8*)w_c,
        (const u64*)grid, (const u64*)grid_s);
    return (int)cudaGetLastError();
}

// Kernel 9's batch at sides K, J: in the shared memory of one of two
// blocks an SM, else of one block: with the grid words staged, else
// without; with an input staging buffer, else without; as many rows (up to
// FS_MAX_ROWS) as fit beside the weights, each with its operand's planes
// and buffer: the first of these that holds a row (every pair of sides the
// kernel takes has one).
struct PhaseFit {
    int rows, grid_staged, in_staged;
};

static long long phase_smem(int K, int J, PhaseFit f) {
    return FS_BARRIER_BYTES + weight_bytes(K)
           + (f.grid_staged ? 8LL * K * J : 0)
           + (long long)f.rows * ((long long)FS_NDIG * fs_np(J) * fs_kp(K)
                                  + (f.in_staged ? 8LL * K * J : 0));
}

static PhaseFit phase_fit(int K, int J) {
    for (int blocks = 2; blocks >= 1; --blocks) {
        long long budget = FS_SM_SMEM / blocks - FS_BLOCK_RESERVED;
        if (budget > FS_MAX_SMEM) budget = FS_MAX_SMEM;
        for (int grid_staged = 1; grid_staged >= 0; --grid_staged) {
            for (int in_staged = 1; in_staged >= 0; --in_staged) {
                const long long fixed =
                    phase_smem(K, J, {0, grid_staged, in_staged});
                const long long row =
                    phase_smem(K, J, {1, grid_staged, in_staged}) - fixed;
                long long rows = (budget - fixed) / row;
                if (rows > FS_MAX_ROWS) rows = FS_MAX_ROWS;
                if (rows >= 1) return {(int)rows, grid_staged, in_staged};
            }
        }
    }
    return {0, 0, 0};
}

typedef void (*Kernel9)(const u64*, u64*, int, int, int, int, int, int,
                        long long, long long, const u64*, const u8*,
                        const u64*, int);

template <int KS>
static Kernel9 kernel9_j(int ksn) {
    if (ksn == 1) return four_step_phase_kernel<KS, 1>;
    if (ksn == 2) return four_step_phase_kernel<KS, 2>;
    return four_step_phase_kernel<KS, 4>;
}

// kernel 9's instance for the steps of K and J
static Kernel9 kernel9(int K, int J) {
    const int ks = ksteps(K), ksn = ksteps(J);
    if (ks == 1) return kernel9_j<1>(ksn);
    if (ks == 2) return kernel9_j<2>(ksn);
    return kernel9_j<4>(ksn);
}

static int launch_phase(const void* in, void* out, long long rows, int L,
                        int K, int J, long long in_gstride, const void* scal,
                        const void* w, const void* grid, int mode,
                        void* stream) {
    if (!kernel_side(K) || !kernel_side(J) || bad_rows(rows, L) || mode < 0
            || mode > 2 || (mode != 0 && grid == nullptr))
        return (int)cudaErrorInvalidValue;
    const PhaseFit f = phase_fit(K, J);
    if (f.rows < 1) return (int)cudaErrorInvalidValue;
    if (rows == 0) return (int)cudaSuccess;
    const long long smem = phase_smem(K, J, f);
    const Kernel9 kern = kernel9(K, J);
    static Capacity capacity;
    int cap = 0;
    const cudaError_t e = blocks_at_once(kern, FS_PHASE_THREADS, smem,
                                         capacity, K, J, &cap);
    if (e != cudaSuccess) return (int)e;
    const long long groups = rows / L;
    kern<<<persistent_blocks(cap, groups, L), FS_PHASE_THREADS, (size_t)smem,
           (cudaStream_t)stream>>>(
        (const u64*)in, (u64*)out, L, K, J, f.rows, f.grid_staged,
        f.in_staged, groups, in_gstride, (const u64*)scal, (const u8*)w,
        (const u64*)grid, mode);
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

// kernel 9's batch at sides K, J: rows, grid staged, input staged,
// shared-memory bytes (all 0: K, J is refused)
void fhe_four_step_phase_fit(int K, int J, int* out) {
    const PhaseFit f = kernel_side(K) && kernel_side(J) ? phase_fit(K, J)
                                                        : PhaseFit{0, 0, 0};
    out[0] = f.rows;
    out[1] = f.grid_staged;
    out[2] = f.in_staged;
    out[3] = f.rows ? (int)phase_smem(K, J, f) : 0;
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

// mode 0 none, 1 pre, 2 post; scal: fold_scalars; w: the packed weights
// (L, weight_bytes(K)); grid: (L, K, J) words (mode 0: unused)
int fhe_four_step_phase(const void* in, void* out, long long rows, int L,
                        int K, int J, long long in_gstride, const void* scal,
                        const void* w, const void* grid, int mode,
                        void* stream) {
    return launch_phase(in, out, rows, L, K, J, in_gstride, scal, w, grid,
                        mode, stream);
}

}  // extern "C"
