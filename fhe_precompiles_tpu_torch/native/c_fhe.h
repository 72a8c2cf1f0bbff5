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
 * libc_fhe_cpu.so exports the same 51 symbols computed on the CPU, with
 * no Python and no card: precompiles.cpp over the C++ host engine
 * (host_engine.cpp), built by fhe_precompiles_tpu_torch.native.build_cpu()
 * into _build/, with its static form _build/libc_fhe_cpu.a.  It also
 * exports fhe_tpu_init_keys, fhe_tpu_use_libzstd and fhe_tpu_zstd_canonical
 * (declared below), by which a host names its network keys and its zstd
 * build before its first call (native/cpu_exports.map).  Link
 *   gcc host.c -I<this directory> -L<_build> -lc_fhe_cpu -Wl,-rpath,<_build>
 * or, statically,
 *   gcc host.c <_build>/libc_fhe_cpu.a -l:libzstd.so.1 -ldl -lpthread \
 *       -lstdc++ -lm
 * The library a host links names the device: -lc_fhe computes on the
 * card, -lc_fhe_cpu on the CPU, and neither falls back to the other.
 *
 * libc_fhe_native.so (the same two sources; built by
 * fhe_precompiles_tpu_torch.ops.build.build_native_codec()) exports only
 * the fhe_tpu_* codec extension declared at the end of this header and
 * fhe_free, which ByteServer(codec="native") drives; its own c_fhe_*
 * definitions stay local (native/codec_exports.map).
 *
 * Contract (identical to the reference):
 *   - return 0 on success; *output is a malloc'd buffer of *output_length
 *     bytes the CALLER must release with fhe_free().
 *   - nonzero return = stable error code 1..7 (see fhe_error()); *output
 *     is NULL and *output_length is 0.
 *   - every function is thread-safe (libc_fhe.so: calls enter the
 *     interpreter one at a time through the GIL; libc_fhe_cpu.so: a const
 *     context and per-thread scratch).
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

/* ------------------------------------------------------------------------
 * Batched codec extension (libc_fhe_native.so; NOT part of the 51-symbol
 * reference surface, and not exported by libc_fhe.so; libc_fhe_cpu.so
 * exports fhe_tpu_init_keys, fhe_tpu_use_libzstd and
 * fhe_tpu_zstd_canonical of it).
 *
 * These split each precompile at the decode/compute boundary so a serving
 * host can run the codec (zstd + bincode/SEAL + plaintext encoding + all
 * wire checks) in C++ worker threads while batching the FHE compute on an
 * accelerator — with the same error codes and check order as the one-shot
 * c_fhe_* path, so per-request (code, payload) stays byte-identical.
 *
 * All array buffers are caller-allocated u64, row-major; dims come from
 * fhe_tpu_params(): ciphertexts are (2, k_ct, n), encoded plaintext polys
 * and decrypted polys are (n,), relin keys are (k_ct, 2, k_key, n).
 * ---------------------------------------------------------------------- */

/* Bind the library to in-memory network key blobs (the keyio.py wire
 * format).  Without this call the library reads the package's
 * data/network.{pub,pri}.  Must agree with any earlier initialization
 * (the embedded keys or a prior call): returns 3 on key mismatch. */
int32_t fhe_tpu_init_keys(const uint8_t *pub, size_t pub_len,
                          const uint8_t *pri, size_t pri_len);

/* Active parameter set: ring size n, ciphertext limbs k_ct, key limbs
 * k_key, plain modulus t. */
int32_t fhe_tpu_params(uint64_t *n, uint64_t *k_ct, uint64_t *k_key,
                       uint64_t *t);

/* Swap in a different zstd build at runtime.  The candidate is dlopen'd
 * and BYTE-VERIFIED against the checked-in CANONICAL frame hashes
 * (zstd_canonical.h; canonical build = zstd 1.5.7, the build the
 * consensus golden hashes were pinned with) before the dispatch table
 * swaps — the frames are consensus-critical, so a library that
 * compresses differently is rejected.  This both enables the ~1.45x
 * faster 1.5.7 wheel builds on the encode path AND is the remediation
 * when the linked build itself is non-canonical (zstd builds diverge on
 * sparse-noise ciphertext payloads, which are attacker-steerable through
 * op outputs).  path == NULL or "system" restores the linked library
 * (allowed even when non-canonical — explicit operator choice).
 * Returns 0 ok, 1 dlopen failure, 2 missing symbols, 3 not canonical.
 * Call before worker threads for a clean swap (a mid-flight call is
 * still memory-safe). */
int32_t fhe_tpu_use_libzstd(const char *path);

/* 1 if the ACTIVE zstd dispatch reproduces the canonical consensus
 * frames, 0 if not (validators should alarm on 0; init also prints a
 * one-line stderr warning when keys are first bound non-canonically). */
int32_t fhe_tpu_zstd_canonical(void);

/* Decode one binary-op calldata blob (name = the c_fhe_* suffix, e.g.
 * "mul_cipheru64_cipheru64").  On 0: *shape = 0 cc / 1 cp / 2 pc, *op =
 * 0 add / 1 sub / 2 mul; cc fills ct<-a and other<-b (each only if its
 * size == 2; sizes reported via ct_size/other_size — a size != 2 is
 * legal data the caller must route to the one-shot path); cp/pc fill
 * ct<-the ciphertext operand and other<-the encoded (n,) plaintext poly
 * (other_size = 0).  *pk_handle receives an owned reference: release
 * with fhe_tpu_pk_release; group batches by fhe_tpu_pk_digest. */
int32_t fhe_tpu_unpack_binary(const char *name, const uint8_t *data,
                              size_t data_len, uint64_t *ct, uint64_t *other,
                              int32_t *shape, int32_t *op, uint64_t *ct_size,
                              uint64_t *other_size, void **pk_handle);

/* Identity of the parsed key's cache entry while the handle is held
 * (equal ids => byte-identical pk blobs; a key evicted and parsed again
 * gets a second entry and id). */
int32_t fhe_tpu_pk_id(void *pk_handle, uint64_t *id);

/* The BLAKE2b-256 digest of the pk blob's bytes (32 bytes into digest):
 * equal for equal bytes, across evictions too. */
int32_t fhe_tpu_pk_digest(void *pk_handle, uint8_t *digest);

/* Copy the key's relinearization block (k_ct, 2, k_key, n); 7 if the key
 * carries none. */
int32_t fhe_tpu_pk_relin(void *pk_handle, uint64_t *rk_out);

void fhe_tpu_pk_release(void *pk_handle);

/* Raw (size, k_ct, n) residues -> the serialized ciphertext bytes every
 * op emits (malloc'd; release with fhe_free). */
int32_t fhe_tpu_pack_ciphertext(const uint64_t *data, uint64_t size,
                                uint8_t **out, int64_t *out_len);

/* Decode one encrypt_<tname> calldata blob: writes the encoded (n,)
 * plaintext poly and the 64-byte deterministic seed (fhe.rs:600-611).
 * The caller runs the seeded encrypt under the NETWORK public key. */
int32_t fhe_tpu_unpack_encrypt(const char *tname, const uint8_t *data,
                               size_t data_len, uint64_t *m,
                               uint8_t *seed64);

/* Decode one decrypt_* calldata blob (bare ciphertext): fills ct iff its
 * size == 2 (other sizes: fall back to the one-shot path). */
int32_t fhe_tpu_unpack_decrypt(const uint8_t *data, size_t data_len,
                               uint64_t *ct, uint64_t *ct_size);

/* Decrypted (n,) mod-t poly -> big-endian scalar bytes of <tname>
 * (malloc'd; release with fhe_free).  Any decode failure returns 5. */
int32_t fhe_tpu_decode_scalar(const char *tname, const uint64_t *poly,
                              uint8_t **out, int64_t *out_len);

/* Decode one reencrypt_* calldata blob: fills ct (iff size == 2) for the
 * batched network-key decrypt and hands out the TARGET pk.  After the
 * device decrypt, fhe_tpu_reencrypt_finish turns the (n,) poly into the
 * re-encoded plaintext + the full-input-bound 64-byte seed (5 on decode
 * failure, 6 on encode failure); the caller then batch-encrypts under
 * the target keys (fhe_tpu_pk_data), grouped by fhe_tpu_pk_digest. */
int32_t fhe_tpu_unpack_reencrypt(const uint8_t *data, size_t data_len,
                                 uint64_t *ct, uint64_t *ct_size,
                                 void **pk_handle);
int32_t fhe_tpu_reencrypt_finish(const char *tname, const uint8_t *data,
                                 size_t data_len, const uint64_t *poly,
                                 uint64_t *m, uint8_t *seed64);

/* The parsed key's (2, k_key, n) public-key data. */
int32_t fhe_tpu_pk_data(void *pk_handle, uint64_t *pk_out);

#ifdef __cplusplus
}  /* extern "C" */
#endif

#endif /* FHE_PRECOMPILES_TPU_TORCH_C_FHE_H */
