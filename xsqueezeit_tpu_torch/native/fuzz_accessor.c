/* Fuzz driver for the native XSI accessor: exercises the whole surface
 * (open, record iteration, shared-bytes access, genotype fill, allele
 * counts) on possibly-corrupt containers.  Built against the ASan/UBSan
 * library (`make sanitize fuzz_accessor_asan`) and driven by
 * tests/test_native_fuzz.py over a mutation matrix.
 *
 * Contract: ANY clean exit code is acceptable on corrupt input — open
 * failure, fill error, short iteration.  What must never happen is a
 * sanitizer report (the harness sets ASAN_OPTIONS=exitcode=99) or a
 * raw signal.  Mirrors the Python-side robustness suite
 * (tests/test_robustness.py) for the native parsers.
 */
#include <stdio.h>
#include <stdlib.h>

#include "xsi_accessor.h"

int main(int argc, char **argv) {
  if (argc < 2) {
    fprintf(stderr, "usage: %s file.xsi\n", argv[0]);
    return 2;
  }
  xsi_file_t *f = xsi_open(argv[1]);
  if (!f) {
    printf("open-error %s\n", xsi_last_error());
    return 3;
  }
  uint64_t ns = xsi_num_samples(f);
  if (ns > (1u << 22)) { /* absurd header count: stop before allocating */
    printf("absurd-samples %llu\n", (unsigned long long)ns);
    xsi_close(f);
    return 4;
  }
  (void)xsi_version(f);
  (void)xsi_num_variants(f);
  (void)xsi_num_records(f);
  (void)xsi_ploidy(f);
  for (uint64_t i = 0; i < ns && i < 4; i++) {
    const char *nm = xsi_sample_name(f, i);
    if (nm) (void)nm[0];
  }

  size_t cap = ns * 2 + 2;
  int32_t *gt = (int32_t *)malloc(cap * sizeof(int32_t));
  long long acc = 0;
  long n = 0;
  int rc_iter;
  while (n < 1000000 && (rc_iter = xsi_next_record(f)) == 1) {
    uint32_t slen = 0;
    const uint8_t *sh = xsi_record_shared(f, &slen);
    if (sh && slen) acc += sh[0] + sh[slen - 1];
    int64_t got = xsi_get_genotypes(f, gt, cap);
    if (got < 0) {
      printf("fill-error %s\n", xsi_last_error());
      break;
    }
    for (int64_t i = 0; i < got; i++) acc += gt[i];
    int32_t na = xsi_record_n_allele(f);
    if (na >= 1 && na <= 8) {
      int64_t counts[8];
      (void)xsi_fill_allele_counts_bm(f, xsi_record_bm(f), na, counts);
    }
    n++;
  }
  free(gt);
  xsi_close(f);
  printf("done records=%ld acc=%lld\n", n, acc);
  return 0;
}
