/* ThreadSanitizer smoke for the bcf_emit deflate worker pool: extract a
 * small .xsi with several threads; any TSan report fails the run.
 * Usage: tsan_extract <xsi> <out.bcf> <header_file> <gt_key> <threads> */
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

int64_t xsi_extract_ranges(const char *xsi_path, const char *out_path,
                           const uint8_t *header_text, uint32_t l_text,
                           int32_t gt_key, int level,
                           const uint64_t *chunks, int n_chunks,
                           const int64_t *regions, int n_regions,
                           const int64_t *targets, int n_targets);
const char *xsi_last_error(void);

int main(int argc, char **argv) {
  if (argc != 6) return 2;
  FILE *hf = fopen(argv[3], "rb");
  if (!hf) return 3;
  fseek(hf, 0, SEEK_END);
  long hl = ftell(hf);
  fseek(hf, 0, SEEK_SET);
  uint8_t *header = malloc(hl);
  if (fread(header, 1, hl, hf) != (size_t)hl) return 4;
  fclose(hf);
  setenv("XSI_EMIT_THREADS", argv[5], 1);
  int64_t n = xsi_extract_ranges(argv[1], argv[2], header, (uint32_t)hl,
                                 atoi(argv[4]), 6, NULL, 0, NULL, 0, NULL, 0);
  free(header);
  if (n < 0) {
    fprintf(stderr, "extract failed %lld: %s\n", (long long)n,
            xsi_last_error());
    return 5;
  }
  printf("%lld records\n", (long long)n);
  return 0;
}
