/* Fuzz driver for the native GT block encoder (gt_encoder.cpp) and the
 * variant pass (var_pass.cpp) under ASan/UBSan.  Same contract as
 * fuzz_accessor.c: any clean exit is acceptable; sanitizer reports and
 * raw signals are failures.
 *
 * Modes:
 *   enc  seed n_samples n_records   — random gt arrays (adversarial
 *                                     values included) through xsi_enc_*
 *   var  file.bcf skip gt_key out   — xsi_var_pass over a (possibly
 *                                     corrupt) BCF, writing to out
 */
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

extern void *xsi_enc_open(int n_samples, int block_bcf_lines,
                          int mac_threshold, int default_phasing,
                          int aet_bytes, int ws);
extern int xsi_enc_record(void *h, const int32_t *gt, int64_t ngt,
                          int n_alleles);
extern int64_t xsi_enc_serialize(void *h, uint8_t *out, int64_t cap);
extern const char *xsi_enc_error(void *h);
extern void xsi_enc_close(void *h);

extern int64_t xsi_var_pass(const char *in, uint64_t skip, const char *out,
                            const uint8_t *hdr, uint32_t l_text, int level,
                            const uint8_t *bm_prefix, uint32_t prefix_len,
                            int64_t block_length, int gt_key, int32_t *rid,
                            int32_t *pos, int32_t *rlen, int32_t *bm,
                            uint64_t *vbeg, uint64_t *vend, int64_t cap,
                            int64_t *nv, int64_t *mp);

static uint64_t s_state = 0x9E3779B97F4A7C15ull;
static uint64_t rnd(void) {
  s_state ^= s_state << 13;
  s_state ^= s_state >> 7;
  s_state ^= s_state << 17;
  return s_state;
}

static int run_enc(uint64_t seed, int n_samples, int n_records) {
  s_state ^= seed * 0xA24BAED4963EE407ull;
  static const int32_t specials[] = {0, 1, 2, 3, INT32_MIN, INT32_MIN + 1,
                                     INT32_MAX, -2, 255, 1 << 20};
  for (int ws = 0; ws <= 2; ++ws) {
    void *h = xsi_enc_open(n_samples, n_records + 1, 2, (int)(rnd() & 1),
                           (rnd() & 1) ? 2 : 4, ws);
    if (!h) return 3;
    int64_t cap2 = (int64_t)n_samples * 2;
    int32_t *gt = (int32_t *)malloc((size_t)cap2 * sizeof(int32_t));
    long long acc = 0;
    for (int r = 0; r < n_records; ++r) {
      int ploidy = (rnd() % 5 == 0) ? 1 : 2;
      int64_t ngt = (int64_t)n_samples * ploidy;
      int n_alleles = (int)(rnd() % 5);  /* 0..4 incl. invalid 0 */
      for (int64_t i = 0; i < ngt; ++i) {
        uint64_t x = rnd();
        if ((x & 0xF) == 0)
          gt[i] = specials[x % (sizeof specials / sizeof *specials)];
        else
          gt[i] = (int32_t)((x % (2u * (uint32_t)(n_alleles ? n_alleles : 1)
                                  + 2u)) + 2u) |
                  (int32_t)(x & 1);
      }
      int rc = xsi_enc_record(h, gt, ngt, n_alleles);
      acc += rc;
      if (rc != 0) (void)xsi_enc_error(h);
    }
    uint8_t *buf = NULL;
    int64_t bcap = 1 << 16;
    for (;;) {
      buf = (uint8_t *)realloc(buf, (size_t)bcap);
      int64_t n = xsi_enc_serialize(h, buf, bcap);
      if (n >= 0) {
        for (int64_t i = 0; i < n; i += 97) acc += buf[i];
        break;
      }
      if (n == -1) break;  /* open/arg error */
      bcap = -n;
    }
    printf("ws %d acc %lld\n", ws, acc);
    free(buf);
    free(gt);
    xsi_enc_close(h);
  }
  return 0;
}

static int run_var(const char *path, uint64_t skip, int gt_key,
                   const char *out) {
  enum { CAP = 1 << 16 };
  static int32_t rid[CAP], pos[CAP], rlen[CAP], bm[CAP];
  static uint64_t vb[CAP], ve[CAP];
  int64_t nv = 0, mp = 0;
  uint8_t hdr[4] = {0, 0, 0, 0};
  uint8_t prefix[8] = {0x11, 0x01, 0x13, 0, 0, 0, 0, 0};
  int64_t n = xsi_var_pass(path, skip, out, hdr, 4, 1,
                           prefix, 3, 128, gt_key, rid, pos, rlen, bm, vb,
                           ve, CAP, &nv, &mp);
  printf("var rc %lld nv %lld mp %lld\n", (long long)n, (long long)nv,
         (long long)mp);
  return 0;
}

int main(int argc, char **argv) {
  if (argc >= 5 && strcmp(argv[1], "enc") == 0)
    return run_enc(strtoull(argv[2], NULL, 10), atoi(argv[3]), atoi(argv[4]));
  if (argc >= 6 && strcmp(argv[1], "var") == 0)
    return run_var(argv[2], strtoull(argv[3], NULL, 10), atoi(argv[4]),
                   argv[5]);
  fprintf(stderr, "usage: %s enc seed n_samples n_records | "
                  "var file.bcf skip gt_key out.bcf\n", argv[0]);
  return 2;
}
