/* sanitize_cases.h -- the case file of the port's sanitizer drives
 * (sanitize_driver.c under ASan+UBSan, tsan_driver.c under TSan), written by
 * fhe_precompiles_tpu_torch/native/sanitize.py, and the code that runs one
 * case through the C ABI and holds it to what the file expects.
 *
 * File layout (little endian):
 *   "FHECASES" u32 version(1) u64 n u64 k_ct u64 k_key u64 t u32 count
 *   count records:
 *     u32 kind, blob name, blob data, blob aux, i32 want_code,
 *     u32 n_out, n_out blobs            blob = u64 length + bytes
 *
 * Kinds (what runs, and the outputs expected when want_code is 0):
 *   CALL              c_fhe_<name>(data)        [bytes]
 *   UNPACK_BINARY     fhe_tpu_unpack_binary     [meta, ct, other, digest,
 *                                                relin, pk data]
 *                     meta = i32 shape, i32 op, u64 ct_size, u64 other_size;
 *                     an empty ct / other is not compared (a size other
 *                     than 2 leaves the buffer as it was); an empty relin
 *                     means fhe_tpu_pk_relin must return 7
 *   UNPACK_ENCRYPT    fhe_tpu_unpack_encrypt(name = type)   [m, seed]
 *   UNPACK_DECRYPT    fhe_tpu_unpack_decrypt    [u64 size, ct]
 *   UNPACK_REENCRYPT  fhe_tpu_unpack_reencrypt  [u64 size, ct, digest,
 *                                                pk data]
 *   REENCRYPT_FINISH  fhe_tpu_reencrypt_finish(name = type, aux = poly)
 *                                               [m, seed]
 *   DECODE_SCALAR     fhe_tpu_decode_scalar(name = type, aux = poly) [bytes]
 *   PACK_CIPHERTEXT   fhe_tpu_pack_ciphertext(aux = residues)       [bytes]
 * A non-zero want_code expects that code, and no output buffer from the
 * calls that hand one out.
 */
#ifndef FHE_PRECOMPILES_TPU_TORCH_SANITIZE_CASES_H
#define FHE_PRECOMPILES_TPU_TORCH_SANITIZE_CASES_H

#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#include "c_fhe.h"

enum {
  CASE_CALL,
  CASE_UNPACK_BINARY,
  CASE_UNPACK_ENCRYPT,
  CASE_UNPACK_DECRYPT,
  CASE_UNPACK_REENCRYPT,
  CASE_REENCRYPT_FINISH,
  CASE_DECODE_SCALAR,
  CASE_PACK_CIPHERTEXT,
  CASE_KINDS
};
static const char *const CASE_KIND_NAMES[CASE_KINDS] = {
    "call",          "unpack_binary",    "unpack_encrypt", "unpack_decrypt",
    "unpack_reencrypt", "reencrypt_finish", "decode_scalar",
    "pack_ciphertext"};

typedef struct {
  uint8_t *p;
  uint64_t len;
} Blob;

typedef struct {
  uint32_t kind;
  Blob name; /* NUL-terminated */
  Blob data;
  Blob aux;
  int32_t want;
  uint32_t n_out;
  Blob *out;
} Case;

typedef struct {
  uint64_t n, k, kk, t;
  uint32_t count;
  Case *cases;
} CaseFile;

typedef int32_t (*precompile_fn)(const uint8_t *, size_t, uint8_t **,
                                 int64_t *);
#define CASE_FN_ENTRY(name) {#name, c_fhe_##name},
static const struct {
  const char *name;
  precompile_fn fn;
} PRECOMPILES[] = {FHE_PRECOMPILE_LIST(CASE_FN_ENTRY)};
#undef CASE_FN_ENTRY
#define N_PRECOMPILES (sizeof(PRECOMPILES) / sizeof(PRECOMPILES[0]))

static void *xmalloc(size_t size) {
  void *p = malloc(size ? size : 1);
  if (p == NULL) {
    fprintf(stderr, "out of memory (%zu bytes)\n", size);
    exit(2);
  }
  return p;
}

static int read_exact(FILE *f, void *dst, size_t len) {
  return len == 0 || fread(dst, 1, len, f) == len;
}

static int read_blob(FILE *f, Blob *b, int len32) {
  uint32_t l32 = 0;
  b->len = 0;
  if (len32 ? !read_exact(f, &l32, 4) : !read_exact(f, &b->len, 8)) return 0;
  if (len32) b->len = l32;
  if (b->len > ((uint64_t)1 << 32)) return 0;
  b->p = (uint8_t *)xmalloc((size_t)b->len + 1);
  b->p[b->len] = 0;
  return read_exact(f, b->p, (size_t)b->len);
}

/* Reads `path`; exits with a message if it is not a case file. */
static CaseFile read_cases(const char *path) {
  CaseFile cf;
  char magic[8];
  uint32_t version = 0;
  FILE *f = fopen(path, "rb");
  if (f == NULL || !read_exact(f, magic, 8) ||
      memcmp(magic, "FHECASES", 8) != 0 || !read_exact(f, &version, 4) ||
      version != 1 || !read_exact(f, &cf.n, 8) || !read_exact(f, &cf.k, 8) ||
      !read_exact(f, &cf.kk, 8) || !read_exact(f, &cf.t, 8) ||
      !read_exact(f, &cf.count, 4)) {
    fprintf(stderr, "%s: not a case file\n", path);
    exit(2);
  }
  cf.cases = (Case *)xmalloc(sizeof(Case) * cf.count);
  for (uint32_t i = 0; i < cf.count; ++i) {
    Case *c = &cf.cases[i];
    int ok = read_exact(f, &c->kind, 4) && c->kind < CASE_KINDS &&
             read_blob(f, &c->name, 1) && read_blob(f, &c->data, 0) &&
             read_blob(f, &c->aux, 0) && read_exact(f, &c->want, 4) &&
             read_exact(f, &c->n_out, 4) && c->n_out <= 8;
    if (ok) {
      c->out = (Blob *)xmalloc(sizeof(Blob) * (c->n_out ? c->n_out : 1));
      for (uint32_t j = 0; ok && j < c->n_out; ++j)
        ok = read_blob(f, &c->out[j], 0);
    }
    if (!ok) {
      fprintf(stderr, "%s: record %u is malformed\n", path, i);
      exit(2);
    }
  }
  fclose(f);
  return cf;
}

static precompile_fn find_precompile(const char *name) {
  for (size_t i = 0; i < N_PRECOMPILES; ++i)
    if (strcmp(PRECOMPILES[i].name, name) == 0) return PRECOMPILES[i].fn;
  return NULL;
}

/* Reports a difference of case `i`; returns 1 (for counting). */
static int case_fail(uint32_t i, const Case *c, const char *what) {
  fprintf(stderr, "case %u (%s %s): %s\n", i, CASE_KIND_NAMES[c->kind],
          (const char *)c->name.p, what);
  return 1;
}

static int same(const void *got, uint64_t got_len, const Blob *want) {
  return got_len == want->len &&
         (want->len == 0 || memcmp(got, want->p, (size_t)want->len) == 0);
}

/* Compares `len` bytes at `got` with `want` unless `want` is empty. */
static int same_if_given(const void *got, uint64_t len, const Blob *want) {
  return want->len == 0 || (want->len <= len && same(got, want->len, want));
}

/* Runs case `i` of `cf` through the library; returns 0 if the code and
 * every output are as expected, else 1 (with a message on stderr). */
static int run_case(const CaseFile *cf, uint32_t i) {
  const Case *c = &cf->cases[i];
  const char *name = (const char *)c->name.p;
  const uint64_t kn = cf->k * cf->n;
  uint8_t *out = NULL;
  int64_t out_len = 0;
  uint8_t seed[64], digest[32];
  int32_t code;
  int bad = 0;
  switch (c->kind) {
    case CASE_CALL: {
      precompile_fn fn = find_precompile(name);
      if (fn == NULL) return case_fail(i, c, "no such precompile");
      code = fn(c->data.p, (size_t)c->data.len, &out, &out_len);
      if (code != c->want) {
        char msg[64];
        snprintf(msg, sizeof msg, "code %d, expected %d", code, c->want);
        bad = case_fail(i, c, msg);
      } else if (code == 0 && !same(out, (uint64_t)out_len, &c->out[0])) {
        bad = case_fail(i, c, "output bytes differ");
      } else if (code != 0 && (out != NULL || out_len != 0)) {
        bad = case_fail(i, c, "an error handed out a buffer");
      }
      if (out != NULL) fhe_free(out);
      if (code != 0) {
        const char *msg = fhe_error(code);
        if (msg == NULL || msg[0] == 0) bad |= case_fail(i, c, "fhe_error");
        fhe_free((const uint8_t *)msg);
      }
      return bad;
    }
    case CASE_UNPACK_BINARY:
    case CASE_UNPACK_REENCRYPT: {
      uint64_t *ct = (uint64_t *)xmalloc(2 * kn * 8);
      uint64_t *other = (uint64_t *)xmalloc(2 * kn * 8);
      uint64_t *rk = (uint64_t *)xmalloc(cf->k * 2 * cf->kk * cf->n * 8);
      uint64_t *pkd = (uint64_t *)xmalloc(2 * cf->kk * cf->n * 8);
      int32_t meta32[2] = {0, 0};
      uint64_t sizes[2] = {0, 0};
      void *pk = NULL;
      const Blob *w_ct, *w_digest, *w_pk;
      if (c->kind == CASE_UNPACK_BINARY) {
        code = fhe_tpu_unpack_binary(name, c->data.p, (size_t)c->data.len, ct,
                                     other, &meta32[0], &meta32[1], &sizes[0],
                                     &sizes[1], &pk);
      } else {
        code = fhe_tpu_unpack_reencrypt(c->data.p, (size_t)c->data.len, ct,
                                        &sizes[0], &pk);
      }
      if (code != c->want) {
        bad = case_fail(i, c, "code differs");
      } else if (code == 0) {
        if (c->kind == CASE_UNPACK_BINARY) {
          uint8_t meta[24];
          memcpy(meta, meta32, 8);
          memcpy(meta + 8, sizes, 16);
          if (!same(meta, 24, &c->out[0]))
            bad |= case_fail(i, c, "shape, op or sizes differ");
          if (!same_if_given(other, 2 * kn * 8, &c->out[2]))
            bad |= case_fail(i, c, "other operand differs");
          w_ct = &c->out[1];
          w_digest = &c->out[3];
          w_pk = &c->out[5];
          int32_t rc = fhe_tpu_pk_relin(pk, rk);
          if (c->out[4].len == 0 ? rc != 7
                                 : rc != 0 || !same(rk, c->out[4].len,
                                                    &c->out[4]))
            bad |= case_fail(i, c, "relinearization key differs");
        } else {
          if (!same(sizes, 8, &c->out[0]))
            bad |= case_fail(i, c, "size differs");
          w_ct = &c->out[1];
          w_digest = &c->out[2];
          w_pk = &c->out[3];
        }
        uint64_t id = 0;
        if (!same_if_given(ct, 2 * kn * 8, w_ct))
          bad |= case_fail(i, c, "ciphertext differs");
        if (fhe_tpu_pk_digest(pk, digest) != 0 || !same(digest, 32, w_digest))
          bad |= case_fail(i, c, "key digest differs");
        if (fhe_tpu_pk_data(pk, pkd) != 0 ||
            !same(pkd, w_pk->len, w_pk))
          bad |= case_fail(i, c, "key data differs");
        if (fhe_tpu_pk_id(pk, &id) != 0)
          bad |= case_fail(i, c, "fhe_tpu_pk_id");
        fhe_tpu_pk_release(pk);
      }
      free(ct);
      free(other);
      free(rk);
      free(pkd);
      return bad;
    }
    case CASE_UNPACK_ENCRYPT:
    case CASE_REENCRYPT_FINISH: {
      uint64_t *m = (uint64_t *)xmalloc(cf->n * 8);
      if (c->kind == CASE_UNPACK_ENCRYPT) {
        code = fhe_tpu_unpack_encrypt(name, c->data.p, (size_t)c->data.len, m,
                                      seed);
      } else if (c->aux.len != cf->n * 8) {
        free(m);
        return case_fail(i, c, "poly of the wrong length");
      } else {
        code = fhe_tpu_reencrypt_finish(name, c->data.p, (size_t)c->data.len,
                                        (const uint64_t *)c->aux.p, m, seed);
      }
      if (code != c->want) {
        bad = case_fail(i, c, "code differs");
      } else if (code == 0 && (!same(m, cf->n * 8, &c->out[0]) ||
                               !same(seed, 64, &c->out[1]))) {
        bad = case_fail(i, c, "plaintext or seed differs");
      }
      free(m);
      return bad;
    }
    case CASE_UNPACK_DECRYPT: {
      uint64_t *ct = (uint64_t *)xmalloc(2 * kn * 8);
      uint64_t size = 0;
      code = fhe_tpu_unpack_decrypt(c->data.p, (size_t)c->data.len, ct, &size);
      if (code != c->want) {
        bad = case_fail(i, c, "code differs");
      } else if (code == 0 && (!same(&size, 8, &c->out[0]) ||
                               !same_if_given(ct, 2 * kn * 8, &c->out[1]))) {
        bad = case_fail(i, c, "size or ciphertext differs");
      }
      free(ct);
      return bad;
    }
    case CASE_DECODE_SCALAR:
    case CASE_PACK_CIPHERTEXT:
      if (c->kind == CASE_DECODE_SCALAR) {
        if (c->aux.len != cf->n * 8)
          return case_fail(i, c, "poly of the wrong length");
        code = fhe_tpu_decode_scalar(name, (const uint64_t *)c->aux.p, &out,
                                     &out_len);
      } else {
        if (c->aux.len == 0 || c->aux.len % (kn * 8) != 0)
          return case_fail(i, c, "residues of the wrong length");
        code = fhe_tpu_pack_ciphertext((const uint64_t *)c->aux.p,
                                       c->aux.len / (kn * 8), &out, &out_len);
      }
      if (code != c->want) {
        bad = case_fail(i, c, "code differs");
      } else if (code == 0 && !same(out, (uint64_t)out_len, &c->out[0])) {
        bad = case_fail(i, c, "output bytes differ");
      }
      if (out != NULL) fhe_free(out);
      return bad;
  }
  return case_fail(i, c, "unknown kind");
}

/* Checks fhe_tpu_params against the file's header; returns 0 if equal. */
static int check_params(const CaseFile *cf) {
  uint64_t n = 0, k = 0, kk = 0, t = 0;
  if (fhe_tpu_params(&n, &k, &kk, &t) != 0 || n != cf->n || k != cf->k ||
      kk != cf->kk || t != cf->t) {
    fprintf(stderr,
            "fhe_tpu_params: (%llu, %llu, %llu, %llu), the cases expect "
            "(%llu, %llu, %llu, %llu)\n",
            (unsigned long long)n, (unsigned long long)k,
            (unsigned long long)kk, (unsigned long long)t,
            (unsigned long long)cf->n, (unsigned long long)cf->k,
            (unsigned long long)cf->kk, (unsigned long long)cf->t);
    return 1;
  }
  return 0;
}

static uint8_t *read_whole(const char *path, size_t *len) {
  FILE *f = fopen(path, "rb");
  uint8_t *buf = NULL;
  long size = -1;
  if (f == NULL) return NULL;
  if (fseek(f, 0, SEEK_END) == 0 && (size = ftell(f)) > 0 &&
      fseek(f, 0, SEEK_SET) == 0) {
    buf = (uint8_t *)xmalloc((size_t)size);
    if (fread(buf, 1, (size_t)size, f) != (size_t)size) {
      free(buf);
      buf = NULL;
    }
  }
  fclose(f);
  *len = size > 0 ? (size_t)size : 0;
  return buf;
}

/* Hands the two key files to fhe_tpu_init_keys; returns 0 on success. */
static int init_keys_from(const char *pub_path, const char *pri_path) {
  size_t pub_len = 0, pri_len = 0;
  uint8_t *pub = read_whole(pub_path, &pub_len);
  uint8_t *pri = read_whole(pri_path, &pri_len);
  int32_t code = (pub && pri) ? fhe_tpu_init_keys(pub, pub_len, pri, pri_len)
                              : -1;
  free(pub);
  free(pri);
  if (code != 0)
    fprintf(stderr, "fhe_tpu_init_keys(%s, %s): %d\n", pub_path, pri_path,
            code);
  return code != 0;
}

#endif /* FHE_PRECOMPILES_TPU_TORCH_SANITIZE_CASES_H */
