// A pooled block's add or sub group in one pass, for Hopper (sm_90a).
//
// pooled_addsub_kernel replaces no TPU kernel.  The JAX package runs a pooled
// group inside one jitted program, where XLA fuses the operand gathers into
// the elementwise add; the port ran it as plain torch: two index_select
// gathers, addmod / submod as four or five elementwise kernels and a cat of
// the batches, some 15 to 19 ciphertexts of traffic a request.
//
// Requests name their operands by index into a pool of P ciphertexts
// (P, 2, k, n), and request r's result is (pool[ia[r]] + pool[ib[r]]) mod q_j,
// or the difference, limb by limb.  The work is bound by bytes: a request
// reads two rows of 2 k n words and writes one, and does one add and one
// conditional subtract a word.  So the kernel reads each operand word once,
// straight from the pool, and writes each result word once:
//   * blockIdx.y takes a request row (a loop where there are more rows than a
//     grid dimension holds) and blockIdx.x a stretch of its 2 k n words; the
//     row's two indices are read once a thread, from one address a block;
//   * each thread moves 16-byte vectors, VECS of them in flight, all loads
//     issued before any arithmetic; n is even, so the two words of a vector
//     lie in one limb, found from the vector's offset in the row;
//   * the moduli (k <= MAX_K) arrive in the launch parameters;
//   * the results are stored evict-first (__stcs): no later kernel of the
//     block reads them, so they do not push the pool out of the L2.  On an
//     H100 that took a group of 4,500 adds on a pool of 256 from 0.411 to
//     0.387 ms and left one on a pool of 10,240 (not L2-resident) as it was.
// An index outside [0, P) stops the kernel with a trap, like index_select's
// device assert: the kernel never reads outside the pool.  The stream checks
// its indices on the host before the upload.
//
// Plain C interface: the launcher takes raw device pointers and the stream,
// launches without synchronising (nothing for zero rows), and returns
// cudaGetLastError().
#include <cuda_runtime.h>
#include "modmath.cuh"

#define MAX_K 3          // ciphertext limbs
#define THREADS 256
#define VECS 4           // 16-byte vectors a thread

struct PooledMods {
    u64 q[MAX_K];
};

__device__ __forceinline__ u64 limb_modulus(const PooledMods& m,
                                            unsigned limb) {
    u64 p = m.q[0];
#pragma unroll
    for (unsigned j = 1; j < MAX_K; ++j)
        p = limb == j ? m.q[j] : p;
    return p;
}

template <bool SUB>
__device__ __forceinline__ u64 add_or_sub(u64 a, u64 b, u64 p) {
    return SUB ? submod(a, b, p) : addmod(a, b, p);
}

template <bool SUB>
__global__ void __launch_bounds__(THREADS)
pooled_addsub_kernel(const u64* __restrict__ pool,
                     const long long* __restrict__ ia,
                     const long long* __restrict__ ib, u64* __restrict__ out,
                     long long rows, unsigned long long pool_rows,
                     unsigned k, unsigned n, PooledMods m) {
    const unsigned row_words = 2u * k * n;     // < 2^31: the wrapper checks
    const unsigned row_vecs = row_words / 2u;
    const unsigned v0 = blockIdx.x * (THREADS * VECS) + threadIdx.x;
    for (long long r = blockIdx.y; r < rows; r += gridDim.y) {
        const unsigned long long xa = (unsigned long long)ia[r];
        const unsigned long long xb = (unsigned long long)ib[r];
        if (xa >= pool_rows || xb >= pool_rows)     // a negative one too
            __trap();
        const ulonglong2* pa =
            reinterpret_cast<const ulonglong2*>(pool + xa * row_words);
        const ulonglong2* pb =
            reinterpret_cast<const ulonglong2*>(pool + xb * row_words);
        ulonglong2* po = reinterpret_cast<ulonglong2*>(
            out + (unsigned long long)r * row_words);
        ulonglong2 va[VECS], vb[VECS];
#pragma unroll
        for (int u = 0; u < VECS; ++u) {
            const unsigned v = v0 + u * THREADS;
            if (v < row_vecs) {
                va[u] = __ldg(pa + v);
                vb[u] = __ldg(pb + v);
            }
        }
#pragma unroll
        for (int u = 0; u < VECS; ++u) {
            const unsigned v = v0 + u * THREADS;
            if (v < row_vecs) {
                const u64 p = limb_modulus(m, (2u * v / n) % k);
                ulonglong2 o;
                o.x = add_or_sub<SUB>(va[u].x, vb[u].x, p);
                o.y = add_or_sub<SUB>(va[u].y, vb[u].y, p);
                __stcs(po + v, o);      // evict-first: read by no kernel here
            }
        }
    }
}

extern "C" {

int fhe_pooled_max_k() { return MAX_K; }

// pool (pool_rows, 2, k, n), out (rows, 2, k, n): contiguous, 16-byte
// aligned; ia, ib (rows,) int64; q the k moduli on the host; n even and
// 2 k n < 2^31.  The wrapper checks all of it.
int fhe_pooled_addsub(const void* pool, const void* ia, const void* ib,
                      void* out, long long rows, long long pool_rows, int k,
                      int n, const unsigned long long* q, int sub,
                      void* stream) {
    if (rows <= 0)
        return (int)cudaSuccess;
    PooledMods m = {};
    for (int j = 0; j < k && j < MAX_K; ++j)
        m.q[j] = q[j];
    const unsigned row_vecs = (unsigned)k * (unsigned)n;
    const dim3 grid((row_vecs + THREADS * VECS - 1) / (THREADS * VECS),
                    (unsigned)(rows < 65535 ? rows : 65535));
    auto kern = sub ? pooled_addsub_kernel<true> : pooled_addsub_kernel<false>;
    kern<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const u64*)pool, (const long long*)ia, (const long long*)ib,
        (u64*)out, rows, (unsigned long long)pool_rows, (unsigned)k,
        (unsigned)n, m);
    return (int)cudaGetLastError();
}

}  // extern "C"
