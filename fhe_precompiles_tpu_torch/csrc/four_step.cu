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
// A'.  A, B0, A', B0' come as five base-256 digit planes (uint8, [d][i][k]),
// T and T' as words with their Shoup companions.  Canonical residues in and
// out; moduli below 2^37.  The phase kernel runs one product W @ X over a
// K x J matrix, with the grid multiplied in before it (mode 1), after it
// (mode 2) or not at all (0): the two-launch form of the transform.
//
// How.  One block owns one row.  The row comes from device memory once, is
// split into five digit planes in shared memory, and each product W @ X is
// 25 digit-pair products on the tensor cores:
// mma.sync.m16n8k32.u8.u8.s32, a warp per 16 x 8 output tile, the
// pair products of equal weight 256^(da+db) summed into one of nine s32
// accumulators (each < 2^26: a pair sum is below 255^2 * 128 < 2^23).  The
// nine sums recombine into two 64-bit words, v = lo + hi * 2^40, and
// v mod p = barrett(lo) + shoup(hi, 2^40 mod p).  The first product's
// outputs take the grid and go back to shared memory as digit planes in the
// layout the second product reads: the transpose between the two phases is
// free, it is where each output is written.  The second product's outputs
// go to device memory.  Nothing but the row's input and output crosses
// device memory; the weights (5 (R^2 + C^2) bytes a limb) and the grid come
// through L1 and L2.
//
// Layouts in shared memory.  An operand X (K x N) of a product is stored
// column by column, each column's K digits contiguous (the mma's "col"
// B operand), columns FS_PAD bytes apart beyond K so that the eight columns
// a warp reads fall in different banks.  In the R x C row: the product that
// contracts over r (K = R, N = C) reads element (r, c) at c * (R + PAD) + r;
// the one that contracts over c (K = C, N = R) reads it at
// r * (C + PAD) + c.  Forward: r-product, grid, c-product; inverse:
// c-product, grid, r-product.  Shared memory: 5 (C (R + PAD) + R (C + PAD))
// bytes, 51,200 at n = 4096, 97,280 at n = 8192.
//
// What bounds it: a row is read once and written once (16 bytes a word);
// 25 n (R + C) u8 multiply-adds on the tensor cores; and on the integer
// pipe, a Barrett step and a Shoup product for each output of each product,
// one more Shoup product for the grid.  By count the bytes term is the
// larger at n = 4096.  What the kernel really spends is latency:
// a block of 118-120 registers a thread leaves room for two blocks (16
// warps) on an SM, and a warp's 25 mma.sync a k-step wait on their A
// fragments (from L1) and on each other's accumulators.  The row's words
// are loaded FS_LOADS at a time so that their latency overlaps.  Warpgroup
// mma with both operands in shared memory, and several rows a block, are
// the way to the bound; this kernel is the simple one.
//
// Plain C interface, as in ntt.cu: raw pointers and the stream in,
// cudaGetLastError() out, no synchronisation.  R and C must be 16, 32, 64
// or 128.
#include <cuda_runtime.h>
#include "modmath.cuh"

typedef unsigned int u32;
typedef unsigned char u8;

#define FS_NDIG 5
#define FS_SUMS (2 * FS_NDIG - 1)
#define FS_PAD 16
// Threads of a block and words of the row a thread loads at once: of 128,
// 256 and 512 threads and of one and eight words in flight, these measured
// best at n = 4096 on an H100.
#define FS_THREADS 256
#define FS_LOADS 8
#define FS_MAX_SMEM 232448          // what one block may use on sm_90

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

template <bool INVERSE>
__global__ void __launch_bounds__(FS_THREADS)
four_step_kernel(const u64* __restrict__ in, u64* __restrict__ out, int L,
                 int R, int C, long long in_gstride,
                 const u64* __restrict__ scal, const u8* __restrict__ w_r,
                 const u8* __restrict__ w_c, const u64* __restrict__ grid,
                 const u64* __restrict__ grid_s) {
    extern __shared__ __align__(16) u8 smem[];
    const long long row = blockIdx.x;
    const int l = (int)(row % L), n = R * C, lc = __ffs(C) - 1;
    const LimbScalars s = limb_scalars(scal, l);
    const u64* __restrict__ src = in + (row / L) * in_gstride + (long long)l * n;
    u64* __restrict__ dst = out + row * n;
    const u64* __restrict__ G = grid + (long long)l * n;
    const u64* __restrict__ Gs = grid_s + (long long)l * n;
    const u8* __restrict__ Wr = w_r + (long long)l * FS_NDIG * R * R;
    const u8* __restrict__ Wc = w_c + (long long)l * FS_NDIG * C * C;
    const int RP = R + FS_PAD, CP = C + FS_PAD;
    const int r_plane = C * RP, c_plane = R * CP;
    u8* Xr = smem;                              // operand of the r-product
    u8* Xc = smem + FS_NDIG * r_plane;          // operand of the c-product

    load_row(src, n, [&](int idx, u64 v) {
        const int r = idx >> lc, c = idx & (C - 1);
        if (INVERSE) put_digits(Xc, c_plane, r * CP + c, v);
        else put_digits(Xr, r_plane, c * RP + r, v);
    });
    __syncthreads();
    // output (i, j) of the r-product is element (r = i, c = j), of the
    // c-product element (r = j, c = i)
    auto r_at = [&](int i, int j) { return (i << lc) + j; };
    auto c_at = [&](int i, int j) { return (j << lc) + i; };
    if (!INVERSE) {
        // Y = T (*) (A @ M), into the c-product's layout
        digit_product(Xr, R, C, Wr, s, G, Gs, r_at, [&](int i, int j, u64 v) {
            put_digits(Xc, c_plane, i * CP + j, v);
        });
        __syncthreads();
        // Z^T = B0 @ Y^T
        digit_product(Xc, C, R, Wc, s, nullptr, nullptr, c_at,
                      [&](int i, int j, u64 v) { dst[c_at(i, j)] = v; });
    } else {
        // Z^T = T'^T (*) (B0' @ M^T), into the r-product's layout
        digit_product(Xc, C, R, Wc, s, G, Gs, c_at, [&](int i, int j, u64 v) {
            put_digits(Xr, r_plane, i * RP + j, v);
        });
        __syncthreads();
        // X = A' @ Z
        digit_product(Xr, R, C, Wr, s, nullptr, nullptr, r_at,
                      [&](int i, int j, u64 v) { dst[r_at(i, j)] = v; });
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

template <bool INVERSE>
static int launch_four_step(const void* in, void* out, long long rows, int L,
                            int R, int C, long long in_gstride,
                            const void* scal, const void* w_r, const void* w_c,
                            const void* grid, const void* grid_s,
                            void* stream) {
    if (!kernel_side(R) || !kernel_side(C)) return (int)cudaErrorInvalidValue;
    const long long smem =
        (long long)FS_NDIG * (C * (R + FS_PAD) + R * (C + FS_PAD));
    const int rc = prepare_launch(four_step_kernel<INVERSE>, smem, rows, L);
    if (rc != (int)cudaSuccess || rows == 0) return rc;
    four_step_kernel<INVERSE><<<(unsigned)rows, FS_THREADS, (size_t)smem,
                                (cudaStream_t)stream>>>(
        (const u64*)in, (u64*)out, L, R, C, in_gstride, (const u64*)scal,
        (const u8*)w_r, (const u8*)w_c, (const u64*)grid, (const u64*)grid_s);
    return (int)cudaGetLastError();
}

extern "C" {

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
