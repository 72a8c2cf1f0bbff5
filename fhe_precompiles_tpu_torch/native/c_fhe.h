/* c_fhe.h -- public C API of the port's FHE precompile library.
 *
 * libc_fhe.so exports exactly this 51-symbol surface, the reference's
 * staticlib ABI (its src/c_fhe.rs:61-141): 49 c_fhe_* precompiles plus
 * fhe_free and fhe_error.  The compute path is the port's Python runtime
 * in an embedded CPython interpreter: by default
 * fhe_precompiles_tpu_torch.testnet.one.FHE, the torch engine on the CUDA
 * card.  Without a card every call returns 7; nothing falls back to the
 * CPU.  A Python host may name another app with
 * fhe_precompiles_tpu_torch.native.use_app(app) before its first call.
 *
 * Build: fhe_precompiles_tpu_torch.native.build() writes
 * fhe_precompiles_tpu_torch/_build/libc_fhe.so; link a host with
 *   gcc host.c -I<this directory> -L<_build> -lc_fhe -Wl,-rpath,<_build>
 *
 * Contract (identical to the reference):
 *   - return 0 on success; *output is a malloc'd buffer of *output_length
 *     bytes the CALLER must release with fhe_free().
 *   - nonzero return = stable error code 1..7 (see fhe_error()); *output
 *     is NULL and *output_length is 0.
 *   - every function is thread-safe (calls enter the interpreter one at a
 *     time through the GIL).
 *
 * Calldata formats (src/pack.rs parity):
 *   binary ops   [u32 BE off1][u32 BE off2][public_key][a][b]
 *                  off1 = 8 + len(public_key), off2 = off1 + len(a)
 *   encrypt_*    [u32 BE off1][scalar BE][public_data]   off1 = 4 + len(scalar)
 *   reencrypt_*  binary-op framing with (target pk, ciphertext, public_data)
 *   decrypt_*    bare serialized ciphertext; OUTPUT is the scalar's
 *                big-endian bytes (8 B for u64/i64/frac64, 32 B for u256)
 *   public_key_bytes   input ignored; returns the network public key blob
 */
#ifndef FHE_PRECOMPILES_TPU_TORCH_C_FHE_H
#define FHE_PRECOMPILES_TPU_TORCH_C_FHE_H

#include <stddef.h>
#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

/* Release a buffer returned through `output` by any precompile, or a
 * string returned by fhe_error(). */
void fhe_free(const uint8_t *bytes);

/* Error code -> malloc'd human-readable C string (free with fhe_free):
 * 1 Unexpected end of file      2 Platform architecture invalid
 * 3 Invalid encoding            4 Overflow in FHE program
 * 5 Invalid decryption          6 Invalid encryption
 * 7 Base sunscreen error        (anything else: "Unknown error")       */
const char *fhe_error(int32_t error_code);

#define FHE_PRECOMPILE_DECLARE(name)                                   \
  int32_t c_fhe_##name(const uint8_t *bytes, size_t bytes_length,      \
                       uint8_t **output, int64_t *output_length);

#define FHE_PRECOMPILE_LIST(X)                                               \
  X(add_cipheru256_cipheru256) X(add_cipheru256_u256) X(add_u256_cipheru256) \
  X(sub_cipheru256_cipheru256) X(sub_cipheru256_u256) X(sub_u256_cipheru256) \
  X(mul_cipheru256_cipheru256) X(mul_cipheru256_u256) X(mul_u256_cipheru256) \
  X(add_cipheru64_cipheru64) X(add_cipheru64_u64) X(add_u64_cipheru64)       \
  X(sub_cipheru64_cipheru64) X(sub_cipheru64_u64) X(sub_u64_cipheru64)       \
  X(mul_cipheru64_cipheru64) X(mul_cipheru64_u64) X(mul_u64_cipheru64)       \
  X(add_cipheri64_cipheri64) X(add_cipheri64_i64) X(add_i64_cipheri64)       \
  X(sub_cipheri64_cipheri64) X(sub_cipheri64_i64) X(sub_i64_cipheri64)       \
  X(mul_cipheri64_cipheri64) X(mul_cipheri64_i64) X(mul_i64_cipheri64)       \
  X(add_cipherfrac64_cipherfrac64) X(add_cipherfrac64_frac64)                \
  X(add_frac64_cipherfrac64) X(sub_cipherfrac64_cipherfrac64)                \
  X(sub_cipherfrac64_frac64) X(sub_frac64_cipherfrac64)                      \
  X(mul_cipherfrac64_cipherfrac64) X(mul_cipherfrac64_frac64)                \
  X(mul_frac64_cipherfrac64)                                                 \
  X(encrypt_u256) X(encrypt_u64) X(encrypt_i64) X(encrypt_frac64)            \
  X(reencrypt_u256) X(reencrypt_u64) X(reencrypt_i64) X(reencrypt_frac64)    \
  X(decrypt_u256) X(decrypt_u64) X(decrypt_i64) X(decrypt_frac64)            \
  X(public_key_bytes)

FHE_PRECOMPILE_LIST(FHE_PRECOMPILE_DECLARE)

#undef FHE_PRECOMPILE_DECLARE

#ifdef __cplusplus
}  /* extern "C" */
#endif

#endif /* FHE_PRECOMPILES_TPU_TORCH_C_FHE_H */
