/* Standalone C host test: links the port's C ABI as a node would (the
 * reference's staticlib consumer model, Cargo.toml:7), either library.
 *
 *   python3 -c 'from fhe_precompiles_tpu_torch import native; \
 *               print(native.build_host_test())'          # -lc_fhe
 *   ./host_test              # on a machine with a CUDA card
 *   ./host_test --no-card    # on a machine without one
 *
 *   native.build_host_test("cpu")          # -lc_fhe_cpu: host_test_cpu
 *   native.build_host_test("cpu_static")   # libc_fhe_cpu.a: host_test_cpu_static
 *   ./host_test_cpu                        # any machine
 *   ./host_test_cpu_static --keys network.pub network.pri
 *
 * Default mode: public_key_bytes, encrypt_u256 -> decrypt_u256 round trip,
 * the error path and four host threads, all through the C ABI; prints HOST
 * TEST PASSED.  Against libc_fhe.so (an embedded interpreter, the torch
 * engine) it needs the card; against libc_fhe_cpu.so it computes on the
 * CPU.  With --no-card (libc_fhe.so, no card): every one of the 49
 * precompiles must return 7 (nothing falls back); prints NO-CARD TEST
 * PASSED.  With --keys PUB PRI (the CPU library, compiled with
 * -DFHE_CPU_LIBRARY): hands the two key files' bytes to fhe_tpu_init_keys
 * before the first call, then runs the default mode.  A static host needs
 * it: the library finds its data/ directory relative to the shared object
 * it was loaded from, and a static host has none.
 */
#include <pthread.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include "c_fhe.h"

static void *thread_worker(void *arg) {
  uint8_t *out = NULL;
  int64_t out_len = 0;
  int32_t code = c_fhe_public_key_bytes(NULL, 0, &out, &out_len);
  if (code == 0 && out_len > 0) {
    fhe_free(out);
    *(int *)arg = 0;
  }
  return NULL;
}

static int no_card(void) {
  uint8_t input[4 + 32 + 3] = {0};
  input[3] = 36;
  int calls = 0, bad = 0;
#define CALL_EXPECT_7(name)                                                \
  {                                                                        \
    uint8_t *out = NULL;                                                   \
    int64_t out_len = 0;                                                   \
    int32_t code = c_fhe_##name(input, sizeof(input), &out, &out_len);     \
    ++calls;                                                               \
    if (code != 7 || out != NULL || out_len != 0) {                        \
      fprintf(stderr, "%s: code %d, expected 7\n", #name, code);           \
      ++bad;                                                               \
    }                                                                      \
  }
  FHE_PRECOMPILE_LIST(CALL_EXPECT_7)
#undef CALL_EXPECT_7
  if (bad != 0 || calls != 49) {
    return 1;
  }
  printf("no card: code 7 from all %d precompiles\n", calls);
  printf("NO-CARD TEST PASSED\n");
  return 0;
}

#ifdef FHE_CPU_LIBRARY
static uint8_t *read_file(const char *path, size_t *len) {
  FILE *f = fopen(path, "rb");
  if (f == NULL) {
    return NULL;
  }
  uint8_t *buf = NULL;
  long size = -1;
  if (fseek(f, 0, SEEK_END) == 0 && (size = ftell(f)) > 0 &&
      fseek(f, 0, SEEK_SET) == 0 && (buf = malloc((size_t)size)) != NULL &&
      fread(buf, 1, (size_t)size, f) != (size_t)size) {
    free(buf);
    buf = NULL;
  }
  fclose(f);
  *len = size > 0 ? (size_t)size : 0;
  return buf;
}

static int init_keys(const char *pub_path, const char *pri_path) {
  size_t pub_len = 0, pri_len = 0;
  uint8_t *pub = read_file(pub_path, &pub_len);
  uint8_t *pri = read_file(pri_path, &pri_len);
  int32_t code = (pub && pri) ? fhe_tpu_init_keys(pub, pub_len, pri, pri_len)
                              : -1;
  free(pub);
  free(pri);
  if (code != 0) {
    fprintf(stderr, "fhe_tpu_init_keys(%s, %s): %d\n", pub_path, pri_path,
            code);
    return 1;
  }
  printf("keys from %s, %s\n", pub_path, pri_path);
  return 0;
}
#endif

int main(int argc, char **argv) {
  if (argc > 1 && strcmp(argv[1], "--no-card") == 0) {
    return no_card();
  }
  if (argc > 1 && strcmp(argv[1], "--keys") == 0) {
#ifdef FHE_CPU_LIBRARY
    if (argc != 4 || init_keys(argv[2], argv[3]) != 0) {
      return 1;
    }
#else
    fprintf(stderr, "--keys needs the CPU library (-DFHE_CPU_LIBRARY)\n");
    return 2;
#endif
  }
  uint8_t *out = NULL;
  int64_t out_len = 0;

  int32_t code = c_fhe_public_key_bytes(NULL, 0, &out, &out_len);
  if (code != 0 || out_len <= 0) {
    fprintf(stderr, "public_key_bytes failed: code %d\n", code);
    return 1;
  }
  printf("public_key_bytes: %lld bytes\n", (long long)out_len);
  fhe_free(out);

  /* pack_two_arguments(U256(12), bytes[1,2,3]): [u32 BE 36][32B BE][3B] */
  uint8_t input[4 + 32 + 3] = {0};
  input[3] = 36;        /* offset_1 = 4 + 32 */
  input[4 + 31] = 12;   /* value 12 big-endian */
  input[36] = 1; input[37] = 2; input[38] = 3;

  code = c_fhe_encrypt_u256(input, sizeof(input), &out, &out_len);
  if (code != 0) {
    fprintf(stderr, "encrypt failed: code %d\n", code);
    return 1;
  }
  printf("encrypt_u256: %lld bytes\n", (long long)out_len);

  uint8_t *plain = NULL;
  int64_t plain_len = 0;
  code = c_fhe_decrypt_u256(out, (size_t)out_len, &plain, &plain_len);
  fhe_free(out);
  if (code != 0 || plain_len != 32 || plain[31] != 12) {
    fprintf(stderr, "decrypt failed: code=%d len=%lld\n", code,
            (long long)plain_len);
    return 1;
  }
  printf("decrypt_u256 round-trip: 12 == %d\n", plain[31]);
  fhe_free(plain);

  /* error path: truncated input must give code 1 (UnexpectedEOF) */
  code = c_fhe_encrypt_u256(input, 2, &out, &out_len);
  if (code != 1) {
    fprintf(stderr, "expected UnexpectedEOF, got %d\n", code);
    return 1;
  }
  const char *msg = fhe_error(code);
  printf("error path OK: %s\n", msg);
  fhe_free((const uint8_t *)msg);

  /* threaded calls: an embedded interpreter must release the GIL after
   * init so other host threads can enter (deadlocks if it does not). */
  pthread_t threads[4];
  int results[4] = {1, 1, 1, 1};
  for (int i = 0; i < 4; ++i) {
    pthread_create(&threads[i], NULL, thread_worker, &results[i]);
  }
  for (int i = 0; i < 4; ++i) {
    pthread_join(threads[i], NULL);
    if (results[i] != 0) {
      fprintf(stderr, "thread %d failed\n", i);
      return 1;
    }
  }
  printf("threaded calls OK\n");
  printf("HOST TEST PASSED\n");
  return 0;
}
