/* Fuzz driver for the batch genotype reader (gt_batch.cpp): iterate a
 * possibly-corrupt BCF to EOF or error.  Same contract as fuzz_accessor.c:
 * any clean exit is acceptable; sanitizer reports (ASAN exitcode=99) and
 * raw signals are failures.
 *
 * argv: file.bcf header_skip gt_key n_samples
 */
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>

extern void *xsi_gtb_open(const char *path, uint64_t header_skip, int gt_key,
                          int n_samples, int64_t skip_recs,
                          unsigned long long start_voff);
extern int xsi_gtb_batch(void *h, int max_recs, int32_t *gt, int64_t gt_cap,
                         int64_t *gt_off, uint8_t *shared, int64_t sh_cap,
                         int64_t *sh_off, int32_t *n_allele, int32_t *ploidy);
extern const char *xsi_gtb_error(void *h);
extern void xsi_gtb_close(void *h);

int main(int argc, char **argv) {
  if (argc < 5) {
    fprintf(stderr, "usage: %s file.bcf skip gt_key n_samples\n", argv[0]);
    return 2;
  }
  uint64_t skip = strtoull(argv[2], NULL, 10);
  int gt_key = atoi(argv[3]);
  int n_samples = atoi(argv[4]);
  if (n_samples < 0 || n_samples > (1 << 22)) return 4;
  void *h = xsi_gtb_open(argv[1], skip, gt_key, n_samples, 0, 0);
  if (!h) {
    printf("open-error\n");
    return 3;
  }
  enum { MAXR = 64 };
  int64_t gt_cap = (int64_t)n_samples * 2 * MAXR + 64;
  int64_t sh_cap = 1 << 20;
  int32_t *gt = (int32_t *)malloc((size_t)gt_cap * sizeof(int32_t));
  uint8_t *sh = (uint8_t *)malloc((size_t)sh_cap);
  int64_t gt_off[MAXR + 1], sh_off[MAXR + 1];
  int32_t na[MAXR], pl[MAXR];
  long long acc = 0;
  long total = 0;
  int rounds = 0;
  for (; rounds < 100000; rounds++) {
    int n = xsi_gtb_batch(h, MAXR, gt, gt_cap, gt_off, sh, sh_cap, sh_off,
                          na, pl);
    if (n <= 0) {
      if (n < 0) printf("batch-error %d %s\n", n, xsi_gtb_error(h));
      break;
    }
    for (int r = 0; r < n; r++) {
      for (int64_t i = gt_off[r]; i < gt_off[r + 1]; i++) acc += gt[i];
      acc += sh[sh_off[r]] + na[r] + pl[r];
      total++;
    }
  }
  printf("records %ld acc %lld\n", total, acc);
  xsi_gtb_close(h);
  free(gt);
  free(sh);
  return 0;
}
