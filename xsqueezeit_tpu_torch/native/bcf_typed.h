/*
 * BCF2.2 typed-value helpers shared by the c_xcf shim (c_api.cpp) and the
 * batch genotype reader (gt_batch.cpp).
 *
 * Semantics restated from the hts-specs BCF2.2 typed encoding (the
 * reference gets these from htslib's vcf.c); every read is bounds-checked
 * against endp — these walk untrusted file bytes and must fail cleanly on
 * truncated/malformed input, never overread.
 */
#ifndef XSI_BCF_TYPED_H
#define XSI_BCF_TYPED_H

#include <cstdint>
#include <cstring>
#include <vector>

namespace xsi_native {

inline bool read_typed_int(const uint8_t **pp, const uint8_t *endp,
                           int64_t *out) {
  const uint8_t *p = *pp;
  if (p >= endp) return false;
  uint8_t d = *p++;
  int type = d & 0x0f;
  int64_t v = 0;
  if (type == 1) {
    if (p + 1 > endp) return false;
    v = *reinterpret_cast<const int8_t *>(p); p += 1;
  } else if (type == 2) {
    if (p + 2 > endp) return false;
    int16_t t; memcpy(&t, p, 2); v = t; p += 2;
  } else {
    if (p + 4 > endp) return false;
    int32_t t; memcpy(&t, p, 4); v = t; p += 4;
  }
  *pp = p;
  *out = v;
  return true;
}

/* Locate a FORMAT field in an indiv block.  On success points *data at the
 * packed values ([len x n_sample] entries of `width` bytes, fully inside
 * the block) and returns true.  *found=false with a true return means the
 * key is absent (clean walk); a false return means a malformed block. */
inline bool find_format_field(const uint8_t *p, const uint8_t *endp,
                              int n_sample, int key, bool *found,
                              int *type_out, int64_t *len_out,
                              const uint8_t **data) {
  *found = false;
  while (p < endp) {
    int64_t k, len;
    if (!read_typed_int(&p, endp, &k) || p >= endp) return false;
    uint8_t d = *p++;
    int type = d & 0x0f;
    len = d >> 4;
    if (len == 15 && !read_typed_int(&p, endp, &len)) return false;
    if (len < 0) return false;
    int width = (type == 1 || type == 7) ? 1 : type == 2 ? 2 : 4;
    size_t span = size_t(width) * size_t(len) * size_t(n_sample);
    if (span > size_t(endp - p)) return false;
    if (k == key) {
      *found = true;
      *type_out = type;
      *len_out = len;
      *data = p;
      return true;
    }
    p += span;
  }
  return true;
}

/* Decode `total` packed GT values of typed width `type` into htslib int32
 * codes (missing / vector_end sentinels widened).  `data` must span the
 * values (guaranteed by find_format_field). */
inline void decode_gt_values(int type, const uint8_t *data, int64_t total,
                             int32_t *out) {
  // htslib sentinel values (named k* — the shim's vcf.h defines macros
  // with the canonical bcf_int32_* names).  The type branch lives OUTSIDE
  // the loop and the sentinel mapping is branch-free selects, so each
  // body auto-vectorizes (compare + blend) — this widening loop is the
  // batch parser's per-value hot spot at biobank widths.
  const int32_t kMissing32 = INT32_MIN;
  const int32_t kVectorEnd32 = INT32_MIN + 1;
  if (type == 1) {
    const int8_t *p = reinterpret_cast<const int8_t *>(data);
    for (int64_t i = 0; i < total; ++i) {
      int32_t t = p[i];
      out[i] = t == -128 ? kMissing32 : t == -127 ? kVectorEnd32 : t;
    }
  } else if (type == 2) {
    for (int64_t i = 0; i < total; ++i) {
      int16_t s;
      memcpy(&s, data + 2 * i, 2);
      int32_t t = s;
      out[i] = t == -32768 ? kMissing32 : t == -32767 ? kVectorEnd32 : t;
    }
  } else {
    memcpy(out, data, size_t(total) * 4);
  }
}

/* Read one BCF record frame (l_shared/l_indiv word pair + bodies) off a
 * BgzfReader-like stream.  Returns 1 = record, 0 = clean EOF, -1 =
 * corrupt/truncated (reader.error() or the frame bounds).  Shared by the
 * batch GT reader, the record counter and the variant pass. */
template <class Reader>
inline int read_bcf_frame(Reader &r, std::vector<uint8_t> *shared,
                          std::vector<uint8_t> *indiv) {
  uint32_t l_shared, l_indiv;
  size_t got = r.read(&l_shared, 4);
  if (got == 0) return r.error().empty() ? 0 : -1;
  if (got != 4 || r.read(&l_indiv, 4) != 4) return -1;
  if (l_shared < 24 || l_shared > (1u << 30) || l_indiv > (1u << 30))
    return -1;
  shared->resize(l_shared);
  if (r.read(shared->data(), l_shared) != l_shared) return -1;
  indiv->resize(l_indiv);
  if (l_indiv && r.read(indiv->data(), l_indiv) != l_indiv) return -1;
  return 1;
}

/* Skip one BCF record frame without materializing it (record counting:
 * only the 8-byte length word is read; the bodies advance in-block).
 * Same return convention as read_bcf_frame. */
template <class Reader>
inline int skip_bcf_frame(Reader &r) {
  uint32_t l_shared, l_indiv;
  size_t got = r.read(&l_shared, 4);
  if (got == 0) return r.error().empty() ? 0 : -1;
  if (got != 4 || r.read(&l_indiv, 4) != 4) return -1;
  if (l_shared < 24 || l_shared > (1u << 30) || l_indiv > (1u << 30))
    return -1;
  size_t body = size_t(l_shared) + size_t(l_indiv);
  if (r.skip(body) != body) return -1;
  return 1;
}

/* Skip `n` uncompressed bytes (the BCF header the Python side parsed). */
template <class Reader>
inline bool skip_bytes(Reader &r, uint64_t n) {
  std::vector<uint8_t> buf(64 * 1024);
  while (n) {
    size_t take = n < buf.size() ? size_t(n) : buf.size();
    if (r.read(buf.data(), take) != take) return false;
    n -= take;
  }
  return true;
}

}  // namespace xsi_native

#endif  // XSI_BCF_TYPED_H
