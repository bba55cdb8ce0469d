/*
 * Native BCF record emitter — the host serialization half of extraction.
 *
 * The reference's decompress profile is >60% bcf_write1 (htslib,
 * the xSqueezeIt reference's include/gt_decompressor_new.hpp:315); this package's
 * Python writer shows the same shape.  This emitter moves the per-record
 * framing + BGZF deflate into C: the Python driver hands whole decoded
 * blocks (shared blobs + a typed genotype byte matrix) and the emitter
 * writes [l_shared][l_indiv][shared][GT prefix + row] members.
 *
 * BGZF framing mirrors xsqueezeit_tpu/io/bgzf.py exactly (64 KiB-bounded
 * members, raw deflate, BC subfield, fixed header fields), so the output
 * is byte-identical to the Python writer at the same zlib level.
 */
#ifndef XSI_BCF_EMIT_H
#define XSI_BCF_EMIT_H

#include <stdint.h>
#include <stddef.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef struct bcf_emit bcf_emit_t;

/* Open `path` and write the BCF magic + header text (l_text bytes,
 * NUL-terminated text included) through BGZF at `level`.  NULL on error. */
bcf_emit_t *bcf_emit_open(const char *path, const uint8_t *header_text,
                          uint32_t l_text, int level);

/* Segment variant: write_header/write_eof=0 emit a records-only BGZF body
 * (multi-process partition; segments concatenate into one valid BCF). */
bcf_emit_t *bcf_emit_open_segment(const char *path,
                                  const uint8_t *header_text, uint32_t l_text,
                                  int level, int write_header, int write_eof);

/* Append a batch of records.
 *   shared:     concatenated shared blobs
 *   sh_off:     n_rec+1 byte offsets into `shared`
 *   prefix:     the indiv prefix shared by the batch (GT key + type
 *               descriptor), prefix_len bytes
 *   gt_bytes:   row-major [n_rec, row_bytes] typed genotype values
 * Returns 0 on success, negative on error. */
int bcf_emit_records(bcf_emit_t *e, const uint8_t *shared,
                     const uint64_t *sh_off, const uint8_t *prefix,
                     uint32_t prefix_len, const uint8_t *gt_bytes,
                     int32_t n_rec, int32_t row_bytes);

/* BGZF virtual offset of the next byte to be written
 * (compressed-file-offset << 16 | pending-uncompressed-bytes).
 * Synchronous emitters only — undefined after bcf_emit_set_threads. */
uint64_t bcf_emit_tell(bcf_emit_t *e);

/* Enable an ordered deflate worker pool (n threads).  Output bytes are
 * identical at any thread count; bcf_emit_tell must not be used after
 * this.  Call once right after open; n <= 0 is a no-op.  Returns 0. */
int bcf_emit_set_threads(bcf_emit_t *e, int n);

/* Flush, write the BGZF EOF marker and close.  Returns 0 on success. */
int bcf_emit_close(bcf_emit_t *e);

#ifdef __cplusplus
}
#endif

#endif /* XSI_BCF_EMIT_H */
