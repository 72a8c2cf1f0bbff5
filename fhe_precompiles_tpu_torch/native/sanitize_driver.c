/* The ASan+UBSan drive of the port's C++ byte path: every case of a case
 * file (sanitize_cases.h, written by native/sanitize.py) through the
 * c_fhe_* precompiles and the fhe_tpu_* codec calls of
 * ByteServer(codec="native"), each held to the code and bytes the file
 * expects (the port's FheApp: its golden model on the CPU, the torch engine
 * on the card).  The library is precompiles.cpp over host_engine.cpp,
 * compiled with -fsanitize=address,undefined (ops/build.py
 * build_sanitized_objects("asan")) and linked in statically, so the host
 * engine is reached through the byte path.
 *
 *   sanitize_driver --keys PUB PRI --cases FILE
 *
 * Prints ASAN DRIVE PASSED and exits 0 if every case is equal; a sanitizer
 * report aborts the process.
 */
#include <stdio.h>
#include <string.h>

#include "sanitize_cases.h"

/* The App singleton and its key cache live for the process: not leaks. */
const char *__asan_default_options(void) { return "detect_leaks=0"; }
const char *__ubsan_default_options(void) {
  return "print_stacktrace=1:halt_on_error=1";
}

/* The asan objects carry the fuzzer's trace-pc edges; nothing counts them
 * here. */
void __sanitizer_cov_trace_pc(void) {}

int main(int argc, char **argv) {
  if (argc != 6 || strcmp(argv[1], "--keys") != 0 ||
      strcmp(argv[4], "--cases") != 0) {
    fprintf(stderr, "usage: sanitize_driver --keys PUB PRI --cases FILE\n");
    return 2;
  }
  if (init_keys_from(argv[2], argv[3]) != 0) return 2;
  CaseFile cf = read_cases(argv[5]);
  if (check_params(&cf) != 0) return 1;
  unsigned by_kind[CASE_KINDS] = {0};
  int bad = 0;
  for (uint32_t i = 0; i < cf.count; ++i) {
    bad += run_case(&cf, i);
    ++by_kind[cf.cases[i].kind];
  }
  for (int k = 0; k < CASE_KINDS; ++k)
    printf("%s: %u\n", CASE_KIND_NAMES[k], by_kind[k]);
  if (bad != 0) {
    fprintf(stderr, "%d of %u cases differ\n", bad, cf.count);
    return 1;
  }
  printf("%u cases equal\nASAN DRIVE PASSED\n", cf.count);
  return 0;
}
