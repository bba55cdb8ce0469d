/*
 * Native variant-file pass: input BCF -> `_var.bcf` records + CSI tuples.
 *
 * The compressor's second output is the variant file: every input
 * record's shared (site) block re-emitted with n_fmt=1/n_sample=1 and a
 * single FORMAT/BM pseudo-genotype pointing into the GT binary matrix
 * (reference: xcf.cpp replace_samples_by_pos_in_binary_matrix).  With
 * the block encode native, this Python-side pass became the compress
 * pipeline's serial bottleneck (profiled 0.62 s / 20k records: record
 * walk + write_raw + per-record BM packing).  This loop walks the input
 * record stream (shared BgzfReader, indiv skipped), writes the variant
 * records through bcf_emit, and returns the per-record CSI tuples
 * (rid, pos, rlen, vbeg, vend) for the Python CsiBuilder.
 *
 * BM layout: block = entry_index / block_length, offset accumulates
 * n_alleles-1 per record within the block, BM = block << 15 | offset
 * (format/constants.py BM_BLOCK_BITS; xcf.cpp:641).
 */
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

#include "bcf_emit.h"
#include "bcf_typed.h"
#include "bgzf_reader.h"

namespace {
constexpr int BM_BLOCK_BITS = 15;
}

extern "C" {

/* Walk `in_path`'s records (starting after `header_skip` uncompressed
 * bytes, or seeking straight to `start_voff` when nonzero) and write the
 * variant BCF (or a records-only body SEGMENT when write_header == 0 —
 * the distributed variant pass: each worker renders its record window,
 * process 0 concatenates; BGZF members are self-contained so segment
 * vbeg/vend voffsets shift by the preceding bytes' size << 16).
 * bm_prefix: the constant FORMAT/BM indiv prefix (typed BM key + int32
 * type descriptor); each record's indiv is prefix + int32 BM.
 * start_entry: global ordinal of the window's first record (MUST be a
 * multiple of block_length — the BM block bookkeeping derives from it);
 * max_recs > 0 bounds the window.
 *
 * Outputs (caller-allocated, `cap` records): rid/pos/rlen int32, BM
 * int32, vbeg/vend uint64 per record.  Returns the record count, or
 * negative on error: -1 open/IO, -2 malformed record, -3 BM offset
 * overflow (bm_offset needs > 15 bits), -5 cap too small.
 */
int64_t xsi_var_pass_segment(
    const char *in_path, uint64_t header_skip, const char *out_path,
    const uint8_t *header_text, uint32_t l_text, int level,
    const uint8_t *bm_prefix, uint32_t prefix_len, int64_t block_length,
    int gt_key, uint64_t start_voff, int64_t start_entry, int64_t max_recs,
    int write_header, int write_eof,
    int32_t *rid, int32_t *pos, int32_t *rlen, int32_t *bm,
    uint64_t *vbeg, uint64_t *vend, int64_t cap,
    int64_t *n_variants_out, int64_t *max_ploidy_out) {
  xsi_native::BgzfReader r(in_path);
  if (!r.ok()) return -1;
  if (start_voff) {
    if (!r.seek_virtual(start_voff)) return -1;
  } else if (!xsi_native::skip_bytes(r, header_skip)) {
    return -1;
  }
  if (start_entry % (block_length > 0 ? block_length : 1) != 0) return -2;
  bcf_emit_t *e = bcf_emit_open_segment(out_path, header_text, l_text,
                                        level, write_header, write_eof);
  if (!e) return -1;

  std::vector<uint8_t> shared, scratch;
  std::vector<uint8_t> indiv(prefix_len + 4);
  memcpy(indiv.data(), bm_prefix, prefix_len);
  int64_t n = 0, entry = start_entry, variants = 0;
  int64_t bm_block = start_entry / block_length, bm_offset = 0;
  int64_t max_ploidy = 0;
  int64_t rc_final = 0;

  for (;;) {
    if (max_recs > 0 && n >= max_recs) break;
    int frc = xsi_native::read_bcf_frame(r, &shared, &scratch);
    if (frc == 0) break;
    if (frc < 0) { rc_final = -1; break; }
    uint32_t l_shared = uint32_t(shared.size());
    uint32_t l_indiv = uint32_t(scratch.size());
    (void)l_shared;
    if (n >= cap) { rc_final = -5; break; }

    // record ploidy from the GT descriptor (max goes into the header;
    // -4 = ploidy > 2, the driver's unsupported-input error)
    if (l_indiv) {
      uint32_t ns_nf;
      memcpy(&ns_nf, shared.data() + 20, 4);
      int n_sample = int(ns_nf & 0xFFFFFF);
      bool found = false;
      int type = 0;
      int64_t len = 0;
      const uint8_t *data = nullptr;
      if (!xsi_native::find_format_field(scratch.data(),
                                         scratch.data() + scratch.size(),
                                         n_sample, gt_key, &found, &type,
                                         &len, &data)) {
        rc_final = -2;
        break;
      }
      // ploidy = the typed length regardless of value type (Python
      // gt_ploidy parity — char-typed GT still counts)
      if (found && len > 0) {
        if (len > 2) { rc_final = -4; break; }
        if (len > max_ploidy) max_ploidy = len;
      }
    }

    // BM bookkeeping (compressor.py _compress_loop semantics; window
    // form: entry starts at start_entry, a block boundary)
    if (entry && entry % block_length == 0 && entry != start_entry) {
      bm_block++;
      bm_offset = 0;
    }
    if (bm_offset >> BM_BLOCK_BITS) { rc_final = -3; break; }
    int64_t bm_v = (bm_block << BM_BLOCK_BITS) | bm_offset;

    // patch n_fmt=1 / n_sample=1
    uint32_t word = (1u << 24) | 1u;
    memcpy(shared.data() + 20, &word, 4);

    int32_t rid32, pos32, rlen32;
    memcpy(&rid32, shared.data(), 4);
    memcpy(&pos32, shared.data() + 4, 4);
    memcpy(&rlen32, shared.data() + 8, 4);
    uint32_t n_allele_info;
    memcpy(&n_allele_info, shared.data() + 16, 4);
    int64_t n_alts = int64_t(n_allele_info >> 16) - 1;
    if (n_alts < 0) n_alts = 0;

    int32_t bm32 = int32_t(bm_v);
    memcpy(indiv.data() + prefix_len, &bm32, 4);

    uint64_t vb = bcf_emit_tell(e);
    const uint64_t off[2] = {0, l_shared};
    // whole indiv rides as the batch prefix; zero row bytes (the dummy
    // row pointer is never dereferenced at row_bytes=0)
    if (bcf_emit_records(e, shared.data(), off, indiv.data(),
                         uint32_t(indiv.size()), shared.data(), 1, 0) != 0) {
      rc_final = -1;
      break;
    }
    rid[n] = rid32;
    pos[n] = pos32;
    rlen[n] = rlen32;
    bm[n] = bm32;
    vbeg[n] = vb;
    vend[n] = bcf_emit_tell(e);
    bm_offset += n_alts;
    variants += n_alts;
    entry++;
    n++;
  }

  if (bcf_emit_close(e) != 0 && rc_final == 0) rc_final = -1;
  if (n_variants_out) *n_variants_out = variants;
  if (max_ploidy_out) *max_ploidy_out = max_ploidy;
  return rc_final != 0 ? rc_final : n;
}

/* Legacy whole-file form: full header + EOF, walk to stream end. */
int64_t xsi_var_pass(const char *in_path, uint64_t header_skip,
                     const char *out_path, const uint8_t *header_text,
                     uint32_t l_text, int level, const uint8_t *bm_prefix,
                     uint32_t prefix_len, int64_t block_length, int gt_key,
                     int32_t *rid, int32_t *pos, int32_t *rlen, int32_t *bm,
                     uint64_t *vbeg, uint64_t *vend, int64_t cap,
                     int64_t *n_variants_out, int64_t *max_ploidy_out) {
  return xsi_var_pass_segment(in_path, header_skip, out_path, header_text,
                              l_text, level, bm_prefix, prefix_len,
                              block_length, gt_key, /*start_voff=*/0,
                              /*start_entry=*/0, /*max_recs=*/0,
                              /*write_header=*/1, /*write_eof=*/1,
                              rid, pos, rlen, bm, vbeg, vend, cap,
                              n_variants_out, max_ploidy_out);
}

}  // extern "C"
