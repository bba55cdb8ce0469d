/*
 * Native end-to-end extract: .xsi + _var.bcf -> .bcf, entirely in C++.
 *
 * The reference's decompression profile is dominated by host record
 * serialization (>60% bcf_write1, ~15% bcf_update_genotypes,
 * the xSqueezeIt reference's include/gt_decompressor_new.hpp:308,315) and this
 * package's Python extract showed the same shape (per-record decode +
 * emission + BGZF deflate).  This loop is the
 * NewDecompressor::decompress_inner_loop equivalent
 * (gt_decompressor_new.hpp:158-206) over the native components: the XSI
 * accessor decodes each record's genotypes straight from the compressed
 * block, the shared site bytes are re-emitted with the n_fmt/n_sample word
 * patched, and bcf_emit handles framing + BGZF deflate.
 *
 * Output is byte-identical to the Python writer (io/bcf.py BcfWriter +
 * io/sites.py encode_gt_indiv) at the same zlib level: same typed-width
 * selection per record, same BGZF member boundaries, same zlib parameters.
 *
 * The unfiltered whole-file case only; region/target/sample subsetting
 * stays in the Python driver (codec/decompressor.py).
 */
#include "bcf_emit.h"
#include "xsi_accessor.h"

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr int32_t INT32_EOV = INT32_MIN + 1;

/* BCF typed-value encoders, mirroring io/bcf.py pack_typed_int /
 * pack_type_descriptor byte for byte. */
void pack_typed_int(std::vector<uint8_t> *out, int64_t v) {
  if (v >= -120 && v <= 127) {
    out->push_back((1 << 4) | 1);
    out->push_back(uint8_t(int8_t(v)));
  } else if (v >= -32000 && v <= 32767) {
    out->push_back((1 << 4) | 2);
    int16_t t = int16_t(v);
    out->push_back(uint8_t(t & 0xff));
    out->push_back(uint8_t((t >> 8) & 0xff));
  } else {
    out->push_back((1 << 4) | 3);
    int32_t t = int32_t(v);
    for (int i = 0; i < 4; ++i) out->push_back(uint8_t((t >> (8 * i)) & 0xff));
  }
}

void pack_type_descriptor(std::vector<uint8_t> *out, int type, int64_t len) {
  if (len < 15) {
    out->push_back(uint8_t((len << 4) | type));
  } else {
    out->push_back(uint8_t((15 << 4) | type));
    pack_typed_int(out, len);
  }
}

}  // namespace

namespace {

/* (rid, start, end) triplets, 1-based inclusive with INT64 sentinels for
 * open bounds — pre-resolved by the Python driver (codec/decompressor.py
 * Region.overlaps / Region.targets semantics). */
bool keep_record(int32_t rid, int64_t pos1, int64_t rlen,
                 const int64_t *regions, int n_regions,
                 const int64_t *targets, int n_targets) {
  if (n_regions) {
    bool hit = false;
    for (int i = 0; i < n_regions && !hit; ++i) {
      const int64_t *r = regions + 3 * i;
      hit = r[0] == rid && pos1 + rlen - 1 >= r[1] && pos1 <= r[2];
    }
    if (!hit) return false;
  }
  if (n_targets) {
    bool hit = false;
    for (int i = 0; i < n_targets && !hit; ++i) {
      const int64_t *t = targets + 3 * i;
      hit = t[0] == rid && pos1 >= t[1] && pos1 <= t[2];
    }
    if (!hit) return false;
  }
  return true;
}

}  // namespace

extern "C" {

int64_t xsi_extract_segment(const char *xsi_path, const char *out_path,
                            const uint8_t *header_text, uint32_t l_text,
                            int32_t gt_key, int level,
                            const uint64_t *chunks, int n_chunks,
                            const int64_t *regions, int n_regions,
                            const int64_t *targets, int n_targets,
                            int64_t start_blk, int64_t end_blk,
                            int write_header, int write_eof);

/* Extract records of `xsi_path` (+ its `_var.bcf`) into `out_path` as a
 * BCF with the given header text (l_text bytes incl. trailing NUL),
 * FORMAT/GT string-dictionary index `gt_key`, and BGZF level `level`.
 *
 * chunks: n_chunks (beg_voff, end_voff) CSI chunk pairs to iterate (NULL
 * = stream the whole file); regions/targets: filter triplets (see
 * keep_record).  Returns the number of records written, or negative on
 * error (xsi_last_error() describes it). */
int64_t xsi_extract_ranges(const char *xsi_path, const char *out_path,
                           const uint8_t *header_text, uint32_t l_text,
                           int32_t gt_key, int level,
                           const uint64_t *chunks, int n_chunks,
                           const int64_t *regions, int n_regions,
                           const int64_t *targets, int n_targets) {
  return xsi_extract_segment(xsi_path, out_path, header_text, l_text, gt_key,
                             level, chunks, n_chunks, regions, n_regions,
                             targets, n_targets, -1, -1, 1, 1);
}

/* Full-control entry: everything xsi_extract_ranges does, plus a BM block
 * window [start_blk, end_blk) (-1 = unbounded; records outside are
 * skipped, and iteration stops at end_blk — blocks are file-ordered) and
 * header/EOF segment flags (multi-process body segments,
 * parallel/distributed.decompress_file_multihost). */
int64_t xsi_extract_segment(const char *xsi_path, const char *out_path,
                            const uint8_t *header_text, uint32_t l_text,
                            int32_t gt_key, int level,
                            const uint64_t *chunks, int n_chunks,
                            const int64_t *regions, int n_regions,
                            const int64_t *targets, int n_targets,
                            int64_t start_blk, int64_t end_blk,
                            int write_header, int write_eof) {
  xsi_file_t *f = xsi_open(xsi_path);
  if (!f) return -1;
  const int64_t n_samples = int64_t(xsi_num_samples(f));
  if (n_samples <= 0) {
    xsi_close(f);
    return -1;
  }

  bcf_emit_t *e = bcf_emit_open_segment(out_path, header_text, l_text,
                                        level, write_header, write_eof);
  if (!e) {
    xsi_close(f);
    return -2;
  }
  {
    // BGZF deflate is the extract loop's wall-clock ceiling; members
    // compress on a worker pool and are written in order, byte-identical
    // at any thread count.  XSI_EMIT_THREADS overrides; single-core
    // hosts stay synchronous.
    int hw = int(std::thread::hardware_concurrency());
    int threads = hw > 1 ? (hw - 1 < 4 ? hw - 1 : 4) : 0;
    if (const char *t = getenv("XSI_EMIT_THREADS")) threads = atoi(t);
    bcf_emit_set_threads(e, threads);
  }

  const size_t cap = size_t(n_samples) * 2;
  std::vector<int32_t> gt(cap);
  std::vector<uint8_t> shared, prefix, row;
  int cur_width = 0;
  int64_t cur_ploidy = -1;
  int64_t n_rec = 0;
  int64_t rc_final = 0;

  int chunk_i = 0;
  uint64_t chunk_end = ~0ull;
  if (n_chunks > 0) {
    if (xsi_var_seek(f, chunks[0]) != 0) {
      bcf_emit_close(e);
      xsi_close(f);
      return -7;
    }
    chunk_end = chunks[1];
  }

  int rc = 0;
  for (;;) {
    if (n_chunks > 0) {
      // advance through chunk ranges: read while before this chunk's end
      while (xsi_var_tell(f) >= chunk_end) {
        if (++chunk_i >= n_chunks) { rc = 0; goto done; }
        if (xsi_var_seek(f, chunks[2 * chunk_i]) != 0) {
          rc_final = -7;
          goto done;
        }
        chunk_end = chunks[2 * chunk_i + 1];
      }
    }
    if ((rc = xsi_next_record(f)) != 1) break;

    if (start_blk >= 0 || end_blk >= 0) {
      int64_t blk = int64_t(uint32_t(xsi_record_bm(f)) >> 15);
      if (start_blk >= 0 && blk < start_blk) continue;
      if (end_blk >= 0 && blk >= end_blk) { rc = 0; break; }
    }

    if (n_regions || n_targets) {
      uint32_t slen0 = 0;
      const uint8_t *sh0 = xsi_record_shared(f, &slen0);
      if (!sh0 || slen0 < 24) { rc_final = -4; break; }
      int32_t rlen32;
      memcpy(&rlen32, sh0 + 8, 4);
      if (!keep_record(xsi_record_rid(f), xsi_record_pos(f) + 1,
                       int64_t(rlen32), regions, n_regions, targets,
                       n_targets))
        continue;
    }

    int64_t n = xsi_get_genotypes(f, gt.data(), cap);
    if (n < 0 || n % n_samples != 0) { rc_final = -3; break; }
    int64_t ploidy = n / n_samples;

    // Typed width by the record's max value, as encode_gt_indiv does
    // (EOV/missing sentinels are <= 0 and never widen the type).
    int32_t maxv = 0;
    for (int64_t i = 0; i < n; ++i)
      if (gt[i] > maxv) maxv = gt[i];
    int width = maxv < 127 ? 1 : maxv < 32767 ? 2 : 4;

    if (width != cur_width || ploidy != cur_ploidy) {
      prefix.clear();
      pack_typed_int(&prefix, gt_key);
      pack_type_descriptor(&prefix, width == 1 ? 1 : width == 2 ? 2 : 3,
                           ploidy);
      cur_width = width;
      cur_ploidy = ploidy;
    }

    row.resize(size_t(n) * size_t(width));
    if (width == 1) {
      for (int64_t i = 0; i < n; ++i)
        row[size_t(i)] = gt[i] == INT32_EOV ? 0x81 : uint8_t(int8_t(gt[i]));
    } else if (width == 2) {
      for (int64_t i = 0; i < n; ++i) {
        int16_t v = gt[i] == INT32_EOV ? int16_t(0x8001) : int16_t(gt[i]);
        memcpy(row.data() + 2 * i, &v, 2);
      }
    } else {
      memcpy(row.data(), gt.data(), size_t(n) * 4);
    }

    uint32_t sh_len = 0;
    const uint8_t *sh = xsi_record_shared(f, &sh_len);
    if (!sh || sh_len < 24) { rc_final = -4; break; }
    shared.assign(sh, sh + sh_len);
    uint32_t word = (1u << 24) | uint32_t(n_samples);  // n_fmt=1 (GT only)
    memcpy(shared.data() + 20, &word, 4);

    const uint64_t off[2] = {0, sh_len};
    if (bcf_emit_records(e, shared.data(), off, prefix.data(),
                         uint32_t(prefix.size()), row.data(), 1,
                         int32_t(row.size())) != 0) {
      rc_final = -5;
      break;
    }
    n_rec++;
  }
done:
  if (rc < 0 && rc_final == 0) rc_final = -6;  // variant-file read error

  if (bcf_emit_close(e) != 0 && rc_final == 0) rc_final = -5;
  xsi_close(f);
  return rc_final != 0 ? rc_final : n_rec;
}

/* Whole-file unfiltered extract (the original entry point). */
int64_t xsi_extract_file(const char *xsi_path, const char *out_path,
                         const uint8_t *header_text, uint32_t l_text,
                         int32_t gt_key, int level) {
  return xsi_extract_ranges(xsi_path, out_path, header_text, l_text, gt_key,
                            level, nullptr, 0, nullptr, 0, nullptr, 0);
}

}  /* extern "C" */
