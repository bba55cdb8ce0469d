/* Minimal C program exercising the native XSI accessor end-to-end
 * (counterpart of the reference's c_api_test/main.c). */
#include <stdio.h>
#include <stdlib.h>

#include "xsi_accessor.h"

int main(int argc, char **argv) {
  if (argc < 2) {
    fprintf(stderr, "usage: %s file.xsi\n", argv[0]);
    return 1;
  }
  xsi_file_t *f = xsi_open(argv[1]);
  if (!f) {
    fprintf(stderr, "open failed: %s\n", xsi_last_error());
    return 1;
  }
  uint64_t ns = xsi_num_samples(f);
  printf("samples=%llu variants=%llu records=%llu first=%s\n",
         (unsigned long long)ns, (unsigned long long)xsi_num_variants(f),
         (unsigned long long)xsi_num_records(f), xsi_sample_name(f, 0));

  size_t cap = ns * 2;
  int32_t *gt = malloc(cap * sizeof(int32_t));
  long long checksum = 0, n = 0;
  while (xsi_next_record(f) == 1) {
    int64_t got = xsi_get_genotypes(f, gt, cap);
    if (got < 0) {
      fprintf(stderr, "fill failed: %s\n", xsi_last_error());
      return 1;
    }
    for (int64_t i = 0; i < got; ++i) checksum += gt[i];
    n++;
  }
  printf("records_read=%lld gt_checksum=%lld\n", n, checksum);
  free(gt);
  xsi_close(f);
  return 0;
}
