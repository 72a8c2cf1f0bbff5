/* The ThreadSanitizer drive of the port's C++ byte path, the port's copy of
 * the C driver in the JAX package's tools/sanitize_native.sh (phase 3).
 * No Python in the process: TSan and CPython do not mix.
 *
 *   tsan_driver --keys PUB PRI --cases FILE --zstd PATH
 *
 * 1. Four threads run every CALL case of the case file (sanitize_cases.h:
 *    the 49 precompiles, malformed inputs, size-mismatched add/sub) through
 *    the one App singleton, each from its own starting point, each output
 *    held to the expected bytes: the key cache, the thread-local zstd
 *    contexts and the scratch arenas under the race detector.
 * 2. Four tpu_workers run the batched-codec path of ByteServer's decode
 *    threads on one shared key: fhe_tpu_unpack_binary hands out counted key
 *    handles from the shared cache; pk_id / pk_digest / pk_relin / pk_data
 *    / release and pack_ciphertext run at once against one cache entry,
 *    then unpack_encrypt and decode_scalar.  Beside them a swapper calls
 *    fhe_tpu_use_libzstd with PATH (the linked libzstd.so.1, found by the
 *    caller) and with "system".  Under a sanitizer runtime the library
 *    refuses a dlopen'd build before it touches the dispatch (code 1:
 *    RTLD_DEEPBIND is fatal there), so what races the workers is the
 *    store of the linked table and the refused probe; any other code fails.
 *
 * Prints TSAN DRIVE PASSED and exits 0; a race report halts the process.
 */
#include <pthread.h>
#include <stdio.h>
#include <string.h>

#include "sanitize_cases.h"

const char *__tsan_default_options(void) { return "halt_on_error=1"; }

#define THREADS 4
#define TPU_ROUNDS 6
#define SWAPS 20

static CaseFile g_cf;
static const char *g_zstd_path;
static int g_bad[THREADS];

static void *call_worker(void *arg) {
  long id = (long)arg;
  uint32_t n = g_cf.count, start = (uint32_t)(id * n / THREADS);
  for (uint32_t j = 0; j < n; ++j) {
    uint32_t i = (start + j) % n;
    if (g_cf.cases[i].kind == CASE_CALL) g_bad[id] += run_case(&g_cf, i);
  }
  return NULL;
}

/* pack_two_arguments for encrypt_u64: [u32 BE off1=12][u64 BE v][pd] */
static void enc_input(uint64_t v, uint8_t out[13]) {
  out[0] = 0; out[1] = 0; out[2] = 0; out[3] = 12;
  for (int i = 0; i < 8; ++i) out[4 + i] = (uint8_t)(v >> (56 - 8 * i));
  out[12] = 0x61;
}

static uint8_t *g_pk; static int64_t g_pk_len;
static uint8_t *g_ct[THREADS]; static int64_t g_ct_len[THREADS];
static uint8_t g_digest[32];

static void *tpu_worker(void *arg) {
  long id = (long)arg;
  uint64_t kn = g_cf.k * g_cf.n;
  uint64_t *ct = xmalloc(2 * kn * 8);
  uint64_t *other = xmalloc(2 * kn * 8);
  uint64_t *rk = xmalloc(g_cf.k * 2 * g_cf.kk * g_cf.n * 8);
  uint64_t *pkb = xmalloc(2 * g_cf.kk * g_cf.n * 8);
  uint64_t *m = xmalloc(g_cf.n * 8);
  long nb = (id + 1) % THREADS;
  uint32_t off1 = 8 + (uint32_t)g_pk_len;
  uint32_t off2 = off1 + (uint32_t)g_ct_len[id];
  size_t len = (size_t)off2 + (size_t)g_ct_len[nb];
  uint8_t *buf = xmalloc(len);
  buf[0]=off1>>24; buf[1]=off1>>16; buf[2]=off1>>8; buf[3]=off1;
  buf[4]=off2>>24; buf[5]=off2>>16; buf[6]=off2>>8; buf[7]=off2;
  memcpy(buf + 8, g_pk, g_pk_len);
  memcpy(buf + off1, g_ct[id], g_ct_len[id]);
  memcpy(buf + off2, g_ct[nb], g_ct_len[nb]);
  for (int round = 0; round < TPU_ROUNDS; ++round) {
    int32_t shape, op; uint64_t cs, os, kid; void *pk = NULL;
    uint8_t digest[32], in13[13], seed[64];
    uint8_t *out = NULL; int64_t out_len = 0;
    if (fhe_tpu_unpack_binary("mul_cipheru64_cipheru64", buf, len, ct, other,
                              &shape, &op, &cs, &os, &pk) != 0 ||
        shape != 0 || op != 2 || cs != 2 || os != 2) {
      fprintf(stderr, "tpu_worker %ld: unpack_binary\n", id);
      exit(1);
    }
    if (fhe_tpu_pk_id(pk, &kid) != 0 || fhe_tpu_pk_digest(pk, digest) != 0 ||
        memcmp(digest, g_digest, 32) != 0 || fhe_tpu_pk_relin(pk, rk) != 0 ||
        fhe_tpu_pk_data(pk, pkb) != 0) {
      fprintf(stderr, "tpu_worker %ld: key handle\n", id);
      exit(1);
    }
    fhe_tpu_pk_release(pk);
    /* the unpacked operand packs back to the bytes it came from */
    if (fhe_tpu_pack_ciphertext(ct, 2, &out, &out_len) != 0 ||
        out_len != g_ct_len[id] || memcmp(out, g_ct[id], out_len) != 0) {
      fprintf(stderr, "tpu_worker %ld: pack_ciphertext\n", id);
      exit(1);
    }
    fhe_free(out);
    enc_input(40 + id, in13);
    if (fhe_tpu_unpack_encrypt("u64", in13, 13, m, seed) != 0 ||
        fhe_tpu_decode_scalar("u64", m, &out, &out_len) != 0 ||
        out_len != 8 || memcmp(out, in13 + 4, 8) != 0) {
      fprintf(stderr, "tpu_worker %ld: encrypt decode\n", id);
      exit(1);
    }
    fhe_free(out);
  }
  free(ct); free(other); free(rk); free(pkb); free(m); free(buf);
  return NULL;
}

static void *swapper(void *arg) {
  (void)arg;
  for (int i = 0; i < SWAPS; ++i) {
    int32_t a = fhe_tpu_use_libzstd(g_zstd_path);
    int32_t b = fhe_tpu_use_libzstd("system");
    if (a != 1 || b != 0) {
      fprintf(stderr, "swapper: use_libzstd codes %d and %d, expected 1 "
              "(a dlopen'd build under a sanitizer) and 0\n", a, b);
      exit(1);
    }
  }
  return NULL;
}

int main(int argc, char **argv) {
  if (argc != 8 || strcmp(argv[1], "--keys") != 0 ||
      strcmp(argv[4], "--cases") != 0 || strcmp(argv[6], "--zstd") != 0) {
    fprintf(stderr,
            "usage: tsan_driver --keys PUB PRI --cases FILE --zstd PATH\n");
    return 2;
  }
  if (init_keys_from(argv[2], argv[3]) != 0) return 2;
  g_cf = read_cases(argv[5]);
  g_zstd_path = argv[7];
  if (check_params(&g_cf) != 0) return 1;

  pthread_t th[THREADS], sw;
  for (long i = 0; i < THREADS; ++i)
    pthread_create(&th[i], NULL, call_worker, (void *)i);
  int bad = 0;
  for (long i = 0; i < THREADS; ++i) {
    pthread_join(th[i], NULL);
    bad += g_bad[i];
  }
  if (bad != 0) {
    fprintf(stderr, "%d case runs differ\n", bad);
    return 1;
  }
  uint32_t calls = 0;
  for (uint32_t i = 0; i < g_cf.count; ++i)
    calls += g_cf.cases[i].kind == CASE_CALL;
  printf("call cases: %u on each of %d threads, all equal\n", calls, THREADS);

  if (c_fhe_public_key_bytes(NULL, 0, &g_pk, &g_pk_len) != 0) return 1;
  for (long i = 0; i < THREADS; ++i) {
    uint8_t in[13];
    enc_input(3 + i, in);
    if (c_fhe_encrypt_u64(in, 13, &g_ct[i], &g_ct_len[i]) != 0) return 1;
  }
  {
    /* the key's digest, once, before the threads share its entry */
    uint32_t off1 = 8 + (uint32_t)g_pk_len, off2 = off1 + g_ct_len[0];
    size_t len = off2 + g_ct_len[0];
    uint8_t *buf = xmalloc(len);
    uint64_t kn = g_cf.k * g_cf.n, cs, os;
    uint64_t *ct = xmalloc(2 * kn * 8), *other = xmalloc(2 * kn * 8);
    int32_t shape, op;
    void *pk = NULL;
    buf[0]=off1>>24; buf[1]=off1>>16; buf[2]=off1>>8; buf[3]=off1;
    buf[4]=off2>>24; buf[5]=off2>>16; buf[6]=off2>>8; buf[7]=off2;
    memcpy(buf + 8, g_pk, g_pk_len);
    memcpy(buf + off1, g_ct[0], g_ct_len[0]);
    memcpy(buf + off2, g_ct[0], g_ct_len[0]);
    if (fhe_tpu_unpack_binary("add_cipheru64_cipheru64", buf, len, ct, other,
                              &shape, &op, &cs, &os, &pk) != 0 ||
        fhe_tpu_pk_digest(pk, g_digest) != 0)
      return 1;
    fhe_tpu_pk_release(pk);
    free(buf); free(ct); free(other);
  }
  for (long i = 0; i < THREADS; ++i)
    pthread_create(&th[i], NULL, tpu_worker, (void *)i);
  pthread_create(&sw, NULL, swapper, NULL);
  for (long i = 0; i < THREADS; ++i) pthread_join(th[i], NULL);
  pthread_join(sw, NULL);
  printf("tpu_workers: %d rounds on each of %d threads; swapper: %d swaps "
         "of %s (refused, code 1) and system (0)\n",
         TPU_ROUNDS, THREADS, SWAPS, g_zstd_path);
  for (long i = 0; i < THREADS; ++i) fhe_free(g_ct[i]);
  fhe_free(g_pk);
  printf("TSAN DRIVE PASSED\n");
  return 0;
}
