// Coverage-guided fuzzer for the port's pure-native C ABI (precompiles.cpp).
//
// The port's copy of the JAX package's fhe_precompiles_tpu/native/
// fuzz_native.cpp.  The consensus surface must not be crashable from wire
// bytes (the reference's length-check error paths, pack.rs:153-266), so
// this class of bug gets a continuing, coverage-guided hunt rather than a
// fixed corpus.
//
// g++ has no libFuzzer, so the harness is self-contained: gcc's
// -fsanitize-coverage=trace-pc instrumentation of the library objects
// feeds an AFL-style edge bitmap; a havoc mutator grows the corpus greedily
// on new coverage; ASan+UBSan turn latent memory bugs into hard failures.
// Built and run by fhe_precompiles_tpu_torch/native/fuzz.py
// (python -m fhe_precompiles_tpu_torch.native.fuzz [SECONDS]).
//
// What differs from the reference's harness:
//   - it reads no environment: the sanitizer options are compiled in
//     (__asan_default_options and __ubsan_default_options below), and the
//     network keys come in as --keys PUB PRI, handed to fhe_tpu_init_keys
//     before the first call (a statically linked binary's dladdr finds no
//     data/ directory);
//   - its seeds come from the writable corpus directory and from
//     read-only seed directories (--seeds DIR, repeatable), each replayed
//     before the mutation loop; new-coverage inputs go to the corpus
//     directory only;
//   - every input is written to <corpus>/last_input.bin before it runs, so
//     that a sanitizer abort leaves its reproducer;
//   - the handle accessors include fhe_tpu_pk_digest.
//
// Usage:
//   fuzz_native --corpus DIR [--seeds DIR]... --seconds N --rng N
//               --keys PUB PRI
//
// Input format: [1 byte precompile index][calldata...], the index into
// c_fhe.h's FHE_PRECOMPILE_LIST order; selector values >= 49 route to the
// batched-codec (fhe_tpu_*) families.
#include <dirent.h>
#include <fcntl.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <sys/stat.h>
#include <time.h>
#include <unistd.h>

#include <algorithm>
#include <string>
#include <vector>

#include "c_fhe.h"

// The App singleton and its key cache live for the process: not leaks.
extern "C" const char* __asan_default_options() { return "detect_leaks=0"; }
extern "C" const char* __ubsan_default_options() {
  return "print_stacktrace=1:halt_on_error=1";
}

typedef int32_t (*fhe_fn)(const uint8_t*, size_t, uint8_t**, int64_t*);
#define FUZZ_ENTRY(name) c_fhe_##name,
static const fhe_fn FNS[] = {FHE_PRECOMPILE_LIST(FUZZ_ENTRY)};
#undef FUZZ_ENTRY
static const size_t NFNS = sizeof(FNS) / sizeof(FNS[0]);

// ---- batched-codec (fhe_tpu_*) targets ---------------------------------
// ByteServer(codec="native") parses the SAME untrusted calldata through a
// second code path (decode split from compute, pk handles, reencrypt-finish
// re-encode): selector values >= NFNS route there.  input[1] picks the
// op/type name; calldata starts at input[2] (families taking a name) or
// input[1] (families that don't).
static const size_t NTPU = 7;
static const char* TPU_TNAMES[4] = {"u256", "u64", "i64", "frac64"};
static char g_bin_names[36][48];
static uint64_t g_n, g_kct, g_kkey, g_t;
static uint64_t *g_ct3, *g_other, *g_rk, *g_poly, *g_m, *g_pkbuf;
static bool g_tpu_ready = false;

static void tpu_init() {
  static bool tried = false;
  if (tried) return;
  tried = true;
  if (fhe_tpu_params(&g_n, &g_kct, &g_kkey, &g_t) != 0) return;
  const char* OPS[3] = {"add", "sub", "mul"};
  size_t idx = 0;
  for (int o = 0; o < 3; ++o)
    for (int ty = 0; ty < 4; ++ty) {
      const char* t = TPU_TNAMES[ty];
      snprintf(g_bin_names[idx++], 48, "%s_cipher%s_cipher%s", OPS[o], t, t);
      snprintf(g_bin_names[idx++], 48, "%s_cipher%s_%s", OPS[o], t, t);
      snprintf(g_bin_names[idx++], 48, "%s_%s_cipher%s", OPS[o], t, t);
    }
  g_ct3 = (uint64_t*)calloc(3 * g_kct * g_n, 8);
  g_other = (uint64_t*)calloc(2 * g_kct * g_n, 8);
  g_rk = (uint64_t*)calloc(g_kct * 2 * g_kkey * g_n, 8);
  g_poly = (uint64_t*)calloc(g_n, 8);
  g_m = (uint64_t*)calloc(g_n, 8);
  g_pkbuf = (uint64_t*)calloc(2 * g_kkey * g_n, 8);
  g_tpu_ready = g_ct3 && g_other && g_rk && g_poly && g_m && g_pkbuf;
}

static void fill_poly(uint64_t* dst, size_t count,
                      const std::vector<uint8_t>& in, size_t off) {
  size_t src = in.size() > off ? in.size() - off : 0;
  for (size_t i = 0; i < count; ++i)
    dst[i] = src ? (uint64_t)in[off + (i % src)] * 0x0101010101ULL : 0;
}

static void touch_pk(void* pk) {  // exercise every handle accessor
  uint64_t id;
  uint8_t digest[32];
  fhe_tpu_pk_id(pk, &id);
  fhe_tpu_pk_digest(pk, digest);
  fhe_tpu_pk_relin(pk, g_rk);
  fhe_tpu_pk_data(pk, g_pkbuf);
  fhe_tpu_pk_release(pk);
}

static void run_tpu(size_t family, const std::vector<uint8_t>& in) {
  tpu_init();
  if (!g_tpu_ready) return;
  uint8_t sub = in.size() > 1 ? in[1] : 0;
  const uint8_t* d2 = in.size() > 2 ? in.data() + 2 : nullptr;
  size_t l2 = in.size() > 2 ? in.size() - 2 : 0;
  const uint8_t* d1 = in.size() > 1 ? in.data() + 1 : nullptr;
  size_t l1 = in.size() > 1 ? in.size() - 1 : 0;
  uint8_t* out = nullptr;
  int64_t out_len = 0;
  uint8_t seed[64];
  uint64_t ct_size = 0, other_size = 0;
  int32_t shape = 0, op = 0;
  void* pk = nullptr;
  switch (family) {
    case 0:
      if (fhe_tpu_unpack_binary(g_bin_names[sub % 36], d2, l2, g_ct3,
                                g_other, &shape, &op, &ct_size, &other_size,
                                &pk) == 0)
        touch_pk(pk);
      break;
    case 1:
      fhe_tpu_unpack_encrypt(TPU_TNAMES[sub % 4], d2, l2, g_m, seed);
      break;
    case 2:
      fhe_tpu_unpack_decrypt(d1, l1, g_ct3, &ct_size);
      break;
    case 3:
      if (fhe_tpu_unpack_reencrypt(d1, l1, g_ct3, &ct_size, &pk) == 0)
        touch_pk(pk);
      break;
    case 4:
      fill_poly(g_poly, g_n, in, 2);
      fhe_tpu_reencrypt_finish(TPU_TNAMES[sub % 4], d2, l2, g_poly, g_m,
                               seed);
      break;
    case 5:
      fill_poly(g_poly, g_n, in, 2);
      if (fhe_tpu_decode_scalar(TPU_TNAMES[sub % 4], g_poly, &out,
                                &out_len) == 0 && out)
        fhe_free(out);
      break;
    case 6:
      fill_poly(g_ct3, 3 * g_kct * g_n, in, 2);
      if (fhe_tpu_pack_ciphertext(g_ct3, 2 + (sub & 1), &out,
                                  &out_len) == 0 && out)
        fhe_free(out);
      break;
  }
}

// ---- AFL-style edge coverage via -fsanitize-coverage=trace-pc ----------
static const size_t MAP_BITS = 16;
static const size_t MAP_SIZE = 1u << MAP_BITS;
static uint8_t g_global[MAP_SIZE];
static uint8_t g_local[MAP_SIZE];
static uintptr_t g_prev_pc;

extern "C" void __sanitizer_cov_trace_pc() {
  uintptr_t pc = (uintptr_t)__builtin_return_address(0) >> 2;
  g_local[(pc ^ (g_prev_pc << 5)) & (MAP_SIZE - 1)] = 1;
  g_prev_pc = pc;
}

static bool merge_coverage() {  // true if the last run saw new edges
  bool fresh = false;
  for (size_t i = 0; i < MAP_SIZE; ++i) {
    if (g_local[i] && !g_global[i]) {
      g_global[i] = 1;
      fresh = true;
    }
  }
  return fresh;
}

static size_t coverage_count() {
  size_t c = 0;
  for (size_t i = 0; i < MAP_SIZE; ++i) c += g_global[i];
  return c;
}

// ---- execution ----------------------------------------------------------
static int g_last_fd = -1;  // <corpus>/last_input.bin

static void record_input(const std::vector<uint8_t>& input) {
  if (ftruncate(g_last_fd, 0) != 0 ||
      pwrite(g_last_fd, input.data(), input.size(), 0) !=
          (ssize_t)input.size()) {
    perror("fuzz_native: last_input.bin");
    exit(2);
  }
}

static void run_one(const std::vector<uint8_t>& input) {
  if (input.empty()) return;
  record_input(input);
  size_t sel = input[0] % (NFNS + NTPU);
  memset(g_local, 0, MAP_SIZE);
  g_prev_pc = 0;
  if (sel >= NFNS) {
    run_tpu(sel - NFNS, input);
    return;
  }
  fhe_fn fn = FNS[sel];
  uint8_t* out = nullptr;
  int64_t out_len = 0;
  int32_t code = fn(input.data() + 1, input.size() - 1, &out, &out_len);
  if (code == 0 && out != nullptr) fhe_free(out);
}

// ---- mutation engine ----------------------------------------------------
static uint64_t g_rng = 0x9e3779b97f4a7c15ULL;
static uint64_t rnd() {
  g_rng ^= g_rng << 13;
  g_rng ^= g_rng >> 7;
  g_rng ^= g_rng << 17;
  return g_rng;
}

static void mutate(std::vector<uint8_t>* d,
                   const std::vector<std::vector<uint8_t>>& corpus) {
  int stack = 1 + (int)(rnd() % 4);
  for (int s = 0; s < stack; ++s) {
    if (d->empty()) {
      d->push_back((uint8_t)rnd());
      continue;
    }
    switch (rnd() % 8) {
      case 0:  // bit flip
        (*d)[rnd() % d->size()] ^= (uint8_t)(1u << (rnd() % 8));
        break;
      case 1:  // random byte
        (*d)[rnd() % d->size()] = (uint8_t)rnd();
        break;
      case 2: {  // delete range
        size_t a = rnd() % d->size();
        size_t len = 1 + rnd() % 64;
        if (a + len > d->size()) len = d->size() - a;
        d->erase(d->begin() + a, d->begin() + a + len);
        break;
      }
      case 3: {  // insert random bytes
        size_t a = rnd() % (d->size() + 1);
        size_t len = 1 + rnd() % 32;
        std::vector<uint8_t> ins(len);
        for (auto& b : ins) b = (uint8_t)rnd();
        d->insert(d->begin() + a, ins.begin(), ins.end());
        break;
      }
      case 4:  // truncate
        d->resize(1 + rnd() % d->size());
        break;
      case 5: {  // u32 BE offset-ish value at a random position
        if (d->size() >= 5) {
          size_t a = 1 + rnd() % (d->size() - 4);
          uint32_t v = (uint32_t)(rnd() % (2 * d->size()));
          (*d)[a] = (uint8_t)(v >> 24);
          (*d)[a + 1] = (uint8_t)(v >> 16);
          (*d)[a + 2] = (uint8_t)(v >> 8);
          (*d)[a + 3] = (uint8_t)v;
        }
        break;
      }
      case 6: {  // splice with another corpus item
        if (!corpus.empty()) {
          const auto& other = corpus[rnd() % corpus.size()];
          if (!other.empty()) {
            size_t a = rnd() % d->size();
            size_t b = rnd() % other.size();
            size_t len = 1 + rnd() % 256;
            if (b + len > other.size()) len = other.size() - b;
            size_t end = a + len > d->size() ? d->size() : a + len;
            std::copy(other.begin() + b, other.begin() + b + (end - a),
                      d->begin() + a);
          }
        }
        break;
      }
      case 7:  // retarget precompile
        (*d)[0] = (uint8_t)rnd();
        break;
    }
    if (d->size() > (1u << 19)) d->resize(1u << 19);  // cap input size
  }
}

// ---- corpus io ----------------------------------------------------------
static std::vector<uint8_t> read_file(const std::string& path, bool* ok) {
  std::vector<uint8_t> buf;
  *ok = false;
  FILE* f = fopen(path.c_str(), "rb");
  if (!f) return buf;
  if (fseek(f, 0, SEEK_END) == 0) {
    long sz = ftell(f);
    if (sz >= 0 && fseek(f, 0, SEEK_SET) == 0) {
      buf.resize((size_t)sz);
      *ok = buf.empty() || fread(buf.data(), 1, buf.size(), f) == buf.size();
    }
  }
  fclose(f);
  return buf;
}

// Every *.bin file of `dir` but last_input.bin, in name order; exits if the
// directory or a file cannot be read.
static std::vector<std::vector<uint8_t>> load_dir(const char* dir) {
  std::vector<std::string> names;
  DIR* d = opendir(dir);
  if (!d) {
    fprintf(stderr, "fuzz_native: cannot open %s\n", dir);
    exit(2);
  }
  struct dirent* e;
  while ((e = readdir(d)) != nullptr) {
    std::string name = e->d_name;
    if (name.size() > 4 && name.compare(name.size() - 4, 4, ".bin") == 0 &&
        name != "last_input.bin")
      names.push_back(name);
  }
  closedir(d);
  std::sort(names.begin(), names.end());
  std::vector<std::vector<uint8_t>> out;
  for (const auto& name : names) {
    bool ok;
    std::vector<uint8_t> buf = read_file(std::string(dir) + "/" + name, &ok);
    if (!ok) {
      fprintf(stderr, "fuzz_native: cannot read %s/%s\n", dir, name.c_str());
      exit(2);
    }
    if (!buf.empty()) out.push_back(std::move(buf));
  }
  return out;
}

static void save_input(const char* dir, const std::vector<uint8_t>& d,
                       size_t serial) {
  char path[4096];
  snprintf(path, sizeof(path), "%s/cov_%06zu_%zu.bin", dir, serial,
           d.size());
  FILE* f = fopen(path, "wb");
  if (!f) return;
  fwrite(d.data(), 1, d.size(), f);
  fclose(f);
}

static int init_keys(const char* pub_path, const char* pri_path) {
  bool ok_pub, ok_pri;
  std::vector<uint8_t> pub = read_file(pub_path, &ok_pub);
  std::vector<uint8_t> pri = read_file(pri_path, &ok_pri);
  int32_t code = ok_pub && ok_pri
                     ? fhe_tpu_init_keys(pub.data(), pub.size(), pri.data(),
                                         pri.size())
                     : -1;
  if (code != 0)
    fprintf(stderr, "fuzz_native: fhe_tpu_init_keys(%s, %s): %d\n", pub_path,
            pri_path, code);
  return code;
}

static int usage() {
  fprintf(stderr,
          "usage: fuzz_native --corpus DIR [--seeds DIR]... --seconds N "
          "--rng N --keys PUB PRI\n");
  return 2;
}

int main(int argc, char** argv) {
  const char* dir = nullptr;
  const char* pub = nullptr;
  const char* pri = nullptr;
  std::vector<const char*> seed_dirs;
  long budget = -1;
  bool have_rng = false;
  for (int i = 1; i < argc; ++i) {
    std::string a = argv[i];
    if (a == "--corpus" && i + 1 < argc) {
      dir = argv[++i];
    } else if (a == "--seeds" && i + 1 < argc) {
      seed_dirs.push_back(argv[++i]);
    } else if (a == "--seconds" && i + 1 < argc) {
      budget = atol(argv[++i]);
    } else if (a == "--rng" && i + 1 < argc) {
      g_rng ^= (uint64_t)atoll(argv[++i]);
      have_rng = true;
    } else if (a == "--keys" && i + 2 < argc) {
      pub = argv[++i];
      pri = argv[++i];
    } else {
      return usage();
    }
  }
  if (!dir || !pub || budget < 0 || !have_rng) return usage();
  if (init_keys(pub, pri) != 0) return 2;
  mkdir(dir, 0755);
  std::string last = std::string(dir) + "/last_input.bin";
  g_last_fd = open(last.c_str(), O_WRONLY | O_CREAT | O_TRUNC, 0644);
  if (g_last_fd < 0) {
    perror(last.c_str());
    return 2;
  }

  // replay every seed first (regression pass + baseline coverage)
  std::vector<std::vector<uint8_t>> corpus = load_dir(dir);
  fprintf(stderr, "fuzz_native: replayed %zu inputs from %s\n", corpus.size(),
          dir);
  for (const auto& item : corpus) {
    run_one(item);
    merge_coverage();
  }
  for (const char* sd : seed_dirs) {
    std::vector<std::vector<uint8_t>> seeds = load_dir(sd);
    for (const auto& item : seeds) {
      run_one(item);
      merge_coverage();
    }
    fprintf(stderr, "fuzz_native: replayed %zu inputs from %s\n",
            seeds.size(), sd);
    for (auto& item : seeds) corpus.push_back(std::move(item));
  }
  fprintf(stderr, "fuzz_native: %zu seed inputs, %lds budget\n",
          corpus.size(), budget);
  fprintf(stderr, "fuzz_native: baseline coverage %zu edges\n",
          coverage_count());

  time_t start = time(nullptr);
  size_t iters = 0, found = 0;
  while (time(nullptr) - start < budget) {
    std::vector<uint8_t> input;
    if (!corpus.empty() && (rnd() % 16) != 0)
      input = corpus[rnd() % corpus.size()];
    else
      input.assign(1 + rnd() % 64, 0);
    mutate(&input, corpus);
    run_one(input);
    if (merge_coverage()) {
      save_input(dir, input, corpus.size());
      corpus.push_back(std::move(input));
      ++found;
    }
    ++iters;
  }
  fprintf(stderr,
          "fuzz_native: %zu iterations, %zu new-coverage inputs, "
          "%zu edges total, no crashes\n",
          iters, found, coverage_count());
  return 0;
}
