/*
 * Batch genotype reader: BGZF BCF -> (shared bytes, GT int32 rows) batches.
 *
 * The compress pipeline's ceiling is the Python-side BCF record parse
 * (profiled ~70 MB/s logical per thread); this reader walks the record
 * stream natively and hands Python whole batches of decoded GT arrays
 * plus the raw `shared` blocks the variant-file writer re-emits — the
 * read-side counterpart of the native extract loop (xsi_extract.cpp).
 * The reference reads records through htslib (bcf_read/bcf_get_genotypes,
 * the xSqueezeIt reference's include/xcf.hpp); this is a from-scratch walker over
 * the BCF2.2 spec on the shared BgzfReader.
 *
 * Python owns the header: it parses it once (io/bcf.py), derives the GT
 * FORMAT key and sample count, and passes the uncompressed byte offset
 * where records start.  Caller-allocated buffers; a record that does not
 * fit the remaining space is carried to the next call.
 */
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

#include "bcf_typed.h"
#include "bgzf_reader.h"

using xsi_native::BgzfReader;

namespace {

struct GtBatchReader {
  BgzfReader bgzf;
  int gt_key = -1;
  int n_samples = 0;
  std::string error;
  bool eof = false;
  // carried record (did not fit the previous batch)
  bool has_pending = false;
  std::vector<uint8_t> p_shared, p_indiv;

  explicit GtBatchReader(const std::string &path) : bgzf(path) {}

  bool fetch(std::vector<uint8_t> &shared, std::vector<uint8_t> &indiv) {
    int rc = xsi_native::read_bcf_frame(bgzf, &shared, &indiv);
    if (rc == 1) return true;
    if (rc == 0) {
      eof = true;
    } else {
      error = bgzf.error().empty() ? "corrupt/truncated record frame"
                                   : bgzf.error();
    }
    return false;
  }
};

}  // namespace

extern "C" {

void *xsi_gtb_open(const char *path, uint64_t header_skip, int gt_key,
                   int n_samples, int64_t skip_recs, uint64_t start_voff) {
  auto *h = new GtBatchReader(path);
  if (!h->bgzf.ok()) {
    delete h;
    return nullptr;
  }
  h->gt_key = gt_key;
  h->n_samples = n_samples;
  if (start_voff) {
    // direct seek to a record boundary (multi-process slice starts come
    // from the count scan's captured voffsets) — no prefix decompression;
    // skip_recs then walks any residual records past the seek point
    if (!h->bgzf.seek_virtual(start_voff)) {
      delete h;
      return nullptr;
    }
    std::vector<uint8_t> s2, i2;
    for (int64_t i = 0; i < skip_recs; ++i) {
      if (!h->fetch(s2, i2)) {
        delete h;
        return nullptr;
      }
    }
    return h;
  }
  // Skip magic + header text (Python already parsed them).
  if (!xsi_native::skip_bytes(h->bgzf, header_skip)) {
    delete h;
    return nullptr;
  }
  // Frame-skip records already consumed by the caller (GtInput
  // skip_records, e.g. a multi-process worker's slice start).
  std::vector<uint8_t> sh, iv;
  for (int64_t i = 0; i < skip_recs; ++i) {
    if (!h->fetch(sh, iv)) {
      delete h;
      return nullptr;
    }
  }
  return h;
}

const char *xsi_gtb_error(void *hv) {
  auto *h = static_cast<GtBatchReader *>(hv);
  if (!h->error.empty()) return h->error.c_str();
  return h->bgzf.error().c_str();
}

/* Fill a batch.  Row r of gt spans [gt_off[r], gt_off[r+1]); shared block
 * r spans [sh_off[r], sh_off[r+1]).  Returns the number of records
 * delivered (0 = EOF), or <0: -1 corrupt/truncated stream, -2 malformed
 * indiv block, -3 record without GT, -5 a single record exceeds the
 * buffer capacities. */
int xsi_gtb_batch(void *hv, int max_recs, int32_t *gt, int64_t gt_cap,
                  int64_t *gt_off, uint8_t *shared, int64_t sh_cap,
                  int64_t *sh_off, int32_t *n_allele, int32_t *ploidy) {
  auto *h = static_cast<GtBatchReader *>(hv);
  int n = 0;
  int64_t gpos = 0, spos = 0;
  gt_off[0] = 0;
  sh_off[0] = 0;
  std::vector<uint8_t> sh, iv;
  while (n < max_recs) {
    if (h->has_pending) {
      sh.swap(h->p_shared);
      iv.swap(h->p_indiv);
      h->has_pending = false;
    } else {
      if (h->eof) break;
      if (!h->fetch(sh, iv)) {
        if (h->eof) break;
        return -1;
      }
    }

    bool found = false;
    int type = 0;
    int64_t len = 0;
    const uint8_t *data = nullptr;
    if (!xsi_native::find_format_field(iv.data(), iv.data() + iv.size(),
                                       h->n_samples, h->gt_key, &found,
                                       &type, &len, &data)) {
      h->error = "malformed FORMAT block";
      return -2;
    }
    // A record without usable GT is delivered with an EMPTY gt row and
    // ploidy 0 (the Python reader yields gt=None there; consumers like
    // utils/bitmap.py skip such records rather than erroring).
    bool has_gt = found && type != 7 && len > 0;
    int64_t total = has_gt ? len * h->n_samples : 0;

    if (gpos + total > gt_cap || spos + int64_t(sh.size()) > sh_cap) {
      // carry to the next call
      h->p_shared.swap(sh);
      h->p_indiv.swap(iv);
      h->has_pending = true;
      if (n == 0) {
        h->error = "record exceeds batch buffer capacity";
        return -5;
      }
      break;
    }

    if (has_gt) xsi_native::decode_gt_values(type, data, total, gt + gpos);
    memcpy(shared + spos, sh.data(), sh.size());
    uint32_t n_allele_info;
    memcpy(&n_allele_info, sh.data() + 16, 4);
    n_allele[n] = int32_t(n_allele_info >> 16);
    ploidy[n] = has_gt ? int32_t(len) : 0;
    gpos += total;
    spos += int64_t(sh.size());
    ++n;
    gt_off[n] = gpos;
    sh_off[n] = spos;
  }
  return n;
}

void xsi_gtb_close(void *hv) { delete static_cast<GtBatchReader *>(hv); }

}  // extern "C"

extern "C" {

/* Count records by walking the frame words (no field decode) — the
 * reference's count_entries (xcf.cpp:318-340) over the native reader.
 * Returns the record count, or -1 on a corrupt/truncated stream. */
int64_t xsi_bcf_count_offsets(const char *path, uint64_t header_skip,
                              int64_t every, uint64_t *voffs, int64_t cap) {
  xsi_native::BgzfReader r(path);
  if (!r.ok()) return -1;
  if (!xsi_native::skip_bytes(r, header_skip)) return -1;
  int64_t n = 0;
  for (;;) {
    if (voffs && every > 0 && n % every == 0 && n / every < cap)
      voffs[n / every] = r.tell_virtual();
    int rc = xsi_native::skip_bcf_frame(r);
    if (rc == 0) return n;
    if (rc < 0) return -1;
    n++;
  }
}

int64_t xsi_bcf_count(const char *path, uint64_t header_skip) {
  return xsi_bcf_count_offsets(path, header_skip, 0, nullptr, 0);
}

}  // extern "C"
