/*
 * Native GT block encoder: the host compress hot loop in C++.
 *
 * Byte-identical to the Python oracle (codec/gt_block.py GtBlockEncoder,
 * pinned by tests/test_native_encode.py over the whole fixture matrix and
 * by the golden-byte suite).  Semantics restated from the XSI v5 GT block
 * layout (reference: gt_block.hpp:106-151 encode, 380-470 serialize);
 * this is a port of OUR oracle's structure, not of the reference's
 * word-at-a-time templates.
 *
 * The Python host path measures ~75 MB/s logical (encode-bound); this
 * loop is the -c counterpart of the native extract loop
 * (xsi_extract.cpp).  The device (TPU) path is unaffected.
 */
#include <cstdint>
#include <cstring>
#include <map>
#include <string>
#include <vector>

namespace {

constexpr int WAH_BITS = 15;
constexpr uint16_t WAH_HIGH_BIT = 1u << 15;
constexpr uint16_t WAH_COUNT_1_BIT = 1u << 14;
constexpr uint16_t WAH_MAX_COUNTER = (1u << 14) - 1;
constexpr uint16_t WAH_ALL_SET = 0x7FFF;

constexpr int32_t kMissing32 = INT32_MIN;        // bcf_int32_missing
constexpr int32_t kVectorEnd32 = INT32_MIN + 1;  // bcf_int32_vector_end

/* GT block dictionary keys (format/constants.py GTDict). */
enum GtKeys : uint32_t {
  KEY_BCF_LINES = 0x0,
  KEY_BINARY_LINES = 0x1,
  KEY_MAX_LINE_PLOIDY = 0x2,
  KEY_DEFAULT_PHASING = 0x3,
  KEY_WEIRDNESS_STRATEGY = 0x4,
  KEY_LINE_SORT = 0x10,
  KEY_LINE_SELECT = 0x11,
  KEY_LINE_HAPLOID = 0x12,
  KEY_LINE_MISSING = 0x16,
  KEY_LINE_NON_UNIFORM_PHASING = 0x17,
  KEY_LINE_END_OF_VECTORS = 0x18,
  KEY_MATRIX_WAH = 0x20,
  KEY_MATRIX_SPARSE = 0x21,
  KEY_MATRIX_MISSING = 0x26,
  KEY_MATRIX_NON_UNIFORM_PHASING = 0x27,
  KEY_MATRIX_END_OF_VECTORS = 0x28,
  KEY_MATRIX_MISSING_SPARSE = 0x36,
  KEY_MATRIX_END_OF_VECTORS_SPARSE = 0x38,
};
constexpr uint32_t VAL_UNDEFINED = 0xFFFFFFFFu;
constexpr uint32_t DICT_SIZE_SYMBOL = 0xFFFFFFFFu;

enum Ws { WS_PBWT_WAH = 0, WS_WAH = 1, WS_SPARSE = 2 };

/* Streaming WAH2 run encoder: feed packed 15-bit words, get the encoded
 * stream (fill runs saturate at 16383 words, literals flush;
 * wah_np.wah_encode semantics).  ONE implementation shared by the
 * word-at-a-time fused encode pass and the bit-vector helper below. */
struct WahRun {
  uint16_t run_word = 0;
  uint32_t run_len = 0;

  void flush(std::vector<uint16_t> *out) {
    if (!run_len) return;
    uint16_t w = WAH_HIGH_BIT | uint16_t(run_len);
    if (run_word == WAH_ALL_SET) w |= WAH_COUNT_1_BIT;
    out->push_back(w);
    run_len = 0;
  }

  void word(uint16_t w, std::vector<uint16_t> *out) {
    if (w == 0 || w == WAH_ALL_SET) {
      if (run_len && run_word != w) flush(out);
      run_word = w;
      if (++run_len == WAH_MAX_COUNTER) flush(out);
    } else {
      flush(out);
      out->push_back(w);
    }
  }
};

/* WAH2-encode a 0/1 bit vector (LSB-first 15-bit words). */
void wah_encode_bits(const uint8_t *bits, int64_t n,
                     std::vector<uint16_t> *out) {
  int64_t n_words = (n + WAH_BITS - 1) / WAH_BITS;
  WahRun run;
  for (int64_t wi = 0; wi < n_words; ++wi) {
    uint16_t w = 0;
    int64_t base = wi * WAH_BITS;
    int64_t lim = base + WAH_BITS < n ? WAH_BITS : n - base;
    for (int64_t j = 0; j < lim; ++j)
      w |= uint16_t(bits[base + j] != 0) << j;
    run.word(w, out);
  }
  run.flush(out);
}

/* Collect the indices where alleles[i] == code.  The outer pass is a
 * vectorizable OR-reduction per 256-element chunk; only chunks that
 * contain a hit take the scalar scan — sparse lines (the reason this
 * runs at all) hit a handful of chunks out of dozens. */
void collect_idx(const int16_t *al, int64_t n, int16_t code,
                 std::vector<uint32_t> *out) {
  out->clear();
  constexpr int64_t C = 256;
  for (int64_t base = 0; base < n; base += C) {
    int64_t lim = base + C < n ? base + C : n;
    int16_t any = 0;
    for (int64_t i = base; i < lim; ++i) any |= int16_t(al[i] == code);
    if (!any) continue;
    for (int64_t i = base; i < lim; ++i)
      if (al[i] == code) out->push_back(uint32_t(i));
  }
}

void wah_encode_flags(const std::vector<uint8_t> &flags,
                      std::vector<uint8_t> *payload) {
  std::vector<uint16_t> words;
  wah_encode_bits(flags.data(), int64_t(flags.size()), &words);
  const uint8_t *p = reinterpret_cast<const uint8_t *>(words.data());
  payload->insert(payload->end(), p, p + words.size() * 2);
}

struct GtEncoder {
  int n_samples, n_haps, block_bcf_lines, mac_threshold, default_phasing;
  int aet_bytes;  // 2 or 4
  int ws;
  std::string error;

  std::vector<int32_t> a, a_weird, a_next;
  std::vector<int32_t> ones_buf;  // scratch: fused partition's one-side
  std::vector<int16_t> alleles;  // scratch: current record's allele codes
  std::vector<uint8_t> bits;     // scratch
  std::vector<int64_t> acs;      // scratch: per-allele counts
  std::vector<uint32_t> idx;     // scratch: sparse index collector

  WahRun wah_run_;  // streaming run state for the fused encode pass
  int bcf_lines = 0;
  int64_t binary_lines = 0;
  int max_vector_length = 1;
  bool missing_found = false, eov_found = false, nup_found = false,
       haploid_found = false;

  std::vector<uint8_t> line_is_wah, haploid_binary_line;  // per binary line
  std::vector<uint8_t> line_has_missing, line_has_eov,
      line_has_nup;                   // per BCF line
  std::vector<int32_t> alt_counts;    // per BCF line

  std::vector<uint16_t> wah_words;    // concatenated WAH matrix
  std::vector<uint8_t> sparse_bytes;  // concatenated sparse matrix (A_T units)
  std::vector<uint8_t> miss_track, eov_track;  // WAH or sparse per strategy
  std::vector<uint16_t> phase_words;

  GtEncoder(int ns, int bl, int mt, int dp, int ab, int w)
      : n_samples(ns), n_haps(2 * ns), block_bcf_lines(bl), mac_threshold(mt),
        default_phasing(dp), aet_bytes(ab), ws(w) {
    a.resize(n_haps);
    a_weird.resize(n_haps);
    a_next.resize(n_haps);
    ones_buf.reserve(n_haps);
    for (int i = 0; i < n_haps; ++i) a[i] = a_weird[i] = i;
  }

  bool sparse_append(const std::vector<uint32_t> &idx, bool negated,
                     std::vector<uint8_t> *dst) {
    uint64_t flag = aet_bytes == 2 ? 0x8000u : 0x80000000u;
    if (idx.size() >= flag) {
      error = "sparse line too long for index type";
      return false;
    }
    uint64_t head = uint64_t(idx.size()) | (negated ? flag : 0);
    size_t off = dst->size();
    if (aet_bytes == 2) {
      dst->resize(off + 2 + 2 * idx.size());
      uint16_t h16 = uint16_t(head);
      memcpy(dst->data() + off, &h16, 2);
      uint8_t *out = dst->data() + off + 2;  // may be odd: memcpy stores
      for (size_t i = 0; i < idx.size(); ++i) {
        uint16_t v16 = uint16_t(idx[i]);
        memcpy(out + 2 * i, &v16, 2);
      }
    } else {
      dst->resize(off + 4 + 4 * idx.size());
      uint32_t h32 = uint32_t(head);
      memcpy(dst->data() + off, &h32, 4);
      if (!idx.empty())  // memcpy(_, nullptr, 0) is UB
        memcpy(dst->data() + off + 4, idx.data(), 4 * idx.size());
    }
    return true;
  }

  int encode_record(const int32_t *gt, int64_t ngt, int n_alleles) {
    if (bcf_lines >= block_bcf_lines) {
      error = "block is full";
      return -1;
    }
    if (n_samples == 0 || ngt % n_samples != 0) {
      error = "gt length is not a multiple of n_samples";
      return -1;
    }
    int ploidy = int(ngt / n_samples);
    if (ploidy > 2) {
      error = "Ploidy higher than 2 is not supported";
      return -1;
    }
    if (ploidy > max_vector_length) max_vector_length = ploidy;
    bool haploid = ploidy == 1;

    alleles.resize(size_t(ngt));
    acs.assign(size_t(n_alleles > 0 ? n_alleles : 1), 0);
    bool has_missing = false, has_eov = false, has_nup = false;
    const int32_t n_ac = int32_t(acs.size());
    // Prescan (branch-free, auto-vectorized): the minimum detects any
    // special code (allele codes are (a+1)<<1 | phase, so anything below
    // 2 is missing/EOV/corrupt) and the OR accumulates phase anomalies
    // over the non-first slots, specials included (matches the per-value
    // loop's semantics).
    int32_t mn = INT32_MAX;
    for (int64_t i = 0; i < ngt; ++i) mn = gt[i] < mn ? gt[i] : mn;
    if (!haploid) {
      uint32_t nup_acc = 0;
      for (int64_t i = 1; i < ngt; i += 2)
        nup_acc |= uint32_t(gt[i] & 1) ^ uint32_t(default_phasing);
      has_nup = nup_acc != 0;
    }
    if (mn >= 2) {
      // no specials: pure shift conversion, vectorized counting
      if (n_ac == 2) {
        int64_t c0 = 0, c1 = 0;
        for (int64_t i = 0; i < ngt; ++i) {
          int32_t al = (gt[i] >> 1) - 1;
          alleles[size_t(i)] = int16_t(al);
          c0 += al == 0;
          c1 += al == 1;
        }
        acs[0] = c0;
        acs[1] = c1;
      } else {
        for (int64_t i = 0; i < ngt; ++i) {
          int32_t al = (gt[i] >> 1) - 1;
          alleles[size_t(i)] = int16_t(al);
          if (al < n_ac) acs[size_t(al)]++;
        }
      }
    } else {
      // specials present: per-value classification
      auto convert = [&](int32_t g) -> int16_t {
        if (g >= 2) {
          int32_t al = (g >> 1) - 1;
          if (al < n_ac) acs[size_t(al)]++;
          return int16_t(al);
        }
        int32_t al = (g >> 1) - 1;
        if ((g >> 1) == 0 || g == kMissing32) {
          has_missing = true;
          return -1;
        }
        if (g == kVectorEnd32) {
          has_eov = true;
          return -2;
        }
        return int16_t(al < -2 ? -3 : al);
      };
      for (int64_t i = 0; i < ngt; ++i) alleles[size_t(i)] = convert(gt[i]);
    }

    if (n_alleles <= 1) {
      if (has_missing || has_eov || has_nup) {
        error = "record with no ALT allele carries missing/end-of-vector/"
                "non-uniform-phasing data, which XSI v5 cannot represent";
        return -2;
      }
      line_has_missing.push_back(0);
      line_has_eov.push_back(0);
      line_has_nup.push_back(0);
      alt_counts.push_back(n_alleles - 1);
      haploid_found |= haploid;  // oracle parity: set even with no line
      bcf_lines++;
      return 0;
    }
    line_has_missing.push_back(has_missing);
    line_has_eov.push_back(has_eov);
    line_has_nup.push_back(has_nup);
    alt_counts.push_back(n_alleles - 1);
    missing_found |= has_missing;
    eov_found |= has_eov;
    nup_found |= has_nup;
    haploid_found |= haploid;

    // --- main genotype matrix: one binary line per ALT -------------------
    for (int alt = 1; alt < n_alleles; ++alt) {
      int64_t ac = acs[size_t(alt)];
      int64_t mac = ac < ngt - ac ? ac : ngt - ac;
      haploid_binary_line.push_back(haploid);
      if (mac > mac_threshold) {
        line_is_wah.push_back(1);
        if (haploid) {
          // bits over the haploid arrangement (even haps of a, halved)
          bits.clear();
          for (int j = 0; j < n_haps; ++j)
            if ((a[j] & 1) == 0)
              bits.push_back(alleles[size_t(a[j] >> 1)] == alt);
          wah_encode_bits(bits.data(), int64_t(bits.size()), &wah_words);
          // partition the 2N arrangement by the per-SAMPLE key
          int lo = 0;
          for (int j = 0; j < n_haps; ++j)
            if (alleles[size_t(a[j] >> 1)] != alt) a_next[lo++] = a[j];
          for (int j = 0; j < n_haps; ++j)
            if (alleles[size_t(a[j] >> 1)] == alt) a_next[lo++] = a[j];
          a.swap(a_next);
        } else {
          // Fused single pass through the arrangement: gather the key,
          // accumulate the packed WAH word, and two-way partition in the
          // same loop (was 3 separate gathers of alleles[a[j]]).
          ones_buf.clear();
          int lo = 0;
          uint16_t w = 0;
          int wbit = 0;
          wah_run_ = WahRun();
          for (int j = 0; j < n_haps; ++j) {
            int32_t hap = a[j];
            uint16_t key = alleles[size_t(hap)] == alt;
            w |= uint16_t(key << wbit);
            if (++wbit == WAH_BITS) {
              wah_run_.word(w, &wah_words);
              w = 0;
              wbit = 0;
            }
            if (key) ones_buf.push_back(hap);
            else a_next[lo++] = hap;
          }
          if (wbit) wah_run_.word(w, &wah_words);  // zero-padded tail
          wah_run_.flush(&wah_words);
          memcpy(a_next.data() + lo, ones_buf.data(),
                 ones_buf.size() * sizeof(int32_t));
          a.swap(a_next);
        }
      } else {
        line_is_wah.push_back(0);
        int sparse_allele = ac == mac ? alt : 0;
        collect_idx(alleles.data(), ngt, int16_t(sparse_allele), &idx);
        if (!sparse_append(idx, sparse_allele == 0, &sparse_bytes)) return -3;
      }
      binary_lines++;
    }

    // --- exception tracks ------------------------------------------------
    bool wah_weird = ws == WS_WAH || ws == WS_PBWT_WAH;
    if (ws == WS_SPARSE) {
      if (has_missing) {
        collect_idx(alleles.data(), ngt, -1, &idx);
        if (!sparse_append(idx, false, &miss_track)) return -3;
      }
      if (has_eov) {
        collect_idx(alleles.data(), ngt, -2, &idx);
        if (!sparse_append(idx, false, &eov_track)) return -3;
      }
    } else if (wah_weird) {
      std::vector<uint16_t> words;
      auto weird_wah = [&](int16_t code, std::vector<uint8_t> *dst) {
        bits.clear();
        if (haploid) {
          for (int j = 0; j < n_haps; ++j)
            if ((a_weird[j] & 1) == 0)
              bits.push_back(alleles[size_t(a_weird[j] >> 1)] == code);
        } else {
          for (int j = 0; j < n_haps; ++j)
            bits.push_back(alleles[size_t(a_weird[j])] == code);
        }
        words.clear();
        wah_encode_bits(bits.data(), int64_t(bits.size()), &words);
        const uint8_t *p = reinterpret_cast<const uint8_t *>(words.data());
        dst->insert(dst->end(), p, p + words.size() * 2);
      };
      if (has_missing) weird_wah(-1, &miss_track);
      if (has_eov) weird_wah(-2, &eov_track);
      if ((has_missing || has_eov) && ws == WS_PBWT_WAH && !haploid) {
        // weirdness arrangement update: partition by missing-or-EOV
        int lo = 0;
        for (int j = 0; j < n_haps; ++j) {
          int16_t c = alleles[size_t(a_weird[j])];
          if (!(c == -1 || c == -2)) a_next[lo++] = a_weird[j];
        }
        for (int j = 0; j < n_haps; ++j) {
          int16_t c = alleles[size_t(a_weird[j])];
          if (c == -1 || c == -2) a_next[lo++] = a_weird[j];
        }
        a_weird.swap(a_next);
      }
    } else {
      error = "unsupported weirdness strategy";
      return -4;
    }

    if (has_nup) {
      bits.resize(size_t(ngt));
      for (int64_t i = 0; i < ngt; ++i)
        bits[size_t(i)] =
            (i & 1) && ((gt[i] & 1) != default_phasing);
      wah_encode_bits(bits.data(), ngt, &phase_words);
    }

    bcf_lines++;
    return 0;
  }

  void first_line_flags(const std::vector<uint8_t> &per_bcf,
                        std::vector<uint8_t> *out) const {
    out->assign(size_t(binary_lines), 0);
    int64_t off = 0;
    for (size_t i = 0; i < alt_counts.size(); ++i) {
      if (alt_counts[i] <= 0) continue;
      (*out)[size_t(off)] = per_bcf[i];
      off += alt_counts[i];
    }
  }

  int64_t serialize(uint8_t *out, int64_t cap) {
    bool wah_weird = ws == WS_WAH || ws == WS_PBWT_WAH;
    std::map<uint32_t, uint32_t> d;
    d[KEY_BCF_LINES] = uint32_t(bcf_lines);
    d[KEY_BINARY_LINES] = uint32_t(binary_lines);
    d[KEY_MAX_LINE_PLOIDY] = uint32_t(max_vector_length);
    d[KEY_DEFAULT_PHASING] = uint32_t(default_phasing);
    d[KEY_WEIRDNESS_STRATEGY] = uint32_t(ws);
    d[KEY_LINE_SORT] = VAL_UNDEFINED;
    d[KEY_LINE_SELECT] = VAL_UNDEFINED;
    d[KEY_MATRIX_WAH] = VAL_UNDEFINED;
    d[KEY_MATRIX_SPARSE] = VAL_UNDEFINED;
    if (missing_found) {
      d[KEY_LINE_MISSING] = VAL_UNDEFINED;
      d[wah_weird ? KEY_MATRIX_MISSING : KEY_MATRIX_MISSING_SPARSE] =
          VAL_UNDEFINED;
    }
    if (eov_found) {
      d[KEY_LINE_END_OF_VECTORS] = VAL_UNDEFINED;
      d[wah_weird ? KEY_MATRIX_END_OF_VECTORS
                  : KEY_MATRIX_END_OF_VECTORS_SPARSE] = VAL_UNDEFINED;
    }
    if (nup_found) {
      d[KEY_LINE_NON_UNIFORM_PHASING] = VAL_UNDEFINED;
      d[KEY_MATRIX_NON_UNIFORM_PHASING] = VAL_UNDEFINED;
    }
    if (haploid_found) d[KEY_LINE_HAPLOID] = VAL_UNDEFINED;

    size_t dict_bytes = 8 * (d.size() + 1);
    std::vector<uint8_t> payload;
    payload.resize(dict_bytes);  // dictionary placeholder

    auto mark = [&](uint32_t key) { d[key] = uint32_t(payload.size()); };
    auto put_u16 = [&](const std::vector<uint16_t> &v) {
      const uint8_t *p = reinterpret_cast<const uint8_t *>(v.data());
      payload.insert(payload.end(), p, p + v.size() * 2);
    };
    std::vector<uint8_t> flags;

    mark(KEY_LINE_SORT);
    wah_encode_flags(line_is_wah, &payload);
    d[KEY_LINE_SELECT] = d[KEY_LINE_SORT];

    mark(KEY_MATRIX_WAH);
    put_u16(wah_words);
    mark(KEY_MATRIX_SPARSE);
    payload.insert(payload.end(), sparse_bytes.begin(), sparse_bytes.end());

    if (missing_found) {
      mark(KEY_LINE_MISSING);
      first_line_flags(line_has_missing, &flags);
      wah_encode_flags(flags, &payload);
      mark(wah_weird ? KEY_MATRIX_MISSING : KEY_MATRIX_MISSING_SPARSE);
      payload.insert(payload.end(), miss_track.begin(), miss_track.end());
    }
    if (eov_found) {
      mark(KEY_LINE_END_OF_VECTORS);
      first_line_flags(line_has_eov, &flags);
      wah_encode_flags(flags, &payload);
      mark(wah_weird ? KEY_MATRIX_END_OF_VECTORS
                     : KEY_MATRIX_END_OF_VECTORS_SPARSE);
      payload.insert(payload.end(), eov_track.begin(), eov_track.end());
    }
    if (nup_found) {
      mark(KEY_LINE_NON_UNIFORM_PHASING);
      first_line_flags(line_has_nup, &flags);
      wah_encode_flags(flags, &payload);
      mark(KEY_MATRIX_NON_UNIFORM_PHASING);
      put_u16(phase_words);
    }
    if (haploid_found) {
      mark(KEY_LINE_HAPLOID);
      wah_encode_flags(haploid_binary_line, &payload);
    }

    // dictionary (ascending key order; std::map iterates sorted)
    uint32_t hdr[2] = {DICT_SIZE_SYMBOL, uint32_t(d.size())};
    memcpy(payload.data(), hdr, 8);
    size_t off = 8;
    for (const auto &kv : d) {
      uint32_t e[2] = {kv.first, kv.second};
      memcpy(payload.data() + off, e, 8);
      off += 8;
    }

    if (int64_t(payload.size()) > cap) return -int64_t(payload.size());
    memcpy(out, payload.data(), payload.size());
    return int64_t(payload.size());
  }
};

}  // namespace

extern "C" {

void *xsi_enc_open(int n_samples, int block_bcf_lines, int mac_threshold,
                   int default_phasing, int aet_bytes, int ws) {
  if (n_samples <= 0 || (aet_bytes != 2 && aet_bytes != 4)) return nullptr;
  return new GtEncoder(n_samples, block_bcf_lines, mac_threshold,
                       default_phasing, aet_bytes, ws);
}

int xsi_enc_record(void *hv, const int32_t *gt, int64_t ngt, int n_alleles) {
  if (!hv || !gt) return -1;
  return static_cast<GtEncoder *>(hv)->encode_record(gt, ngt, n_alleles);
}

/* Batched encode: records i in [0, n) live at gt_all[offs[i]:offs[i+1]]
 * with n_alleles[i] ALTs+REF.  One library call per block instead of one
 * per record (the per-record ctypes crossing dominates sparse blocks).
 * Returns 0, or the failing encode_record rc; `done` (optional) receives
 * the count of records successfully encoded before a failure. */
int xsi_enc_records(void *hv, const int32_t *gt_all, const int64_t *offs,
                    const int32_t *n_alleles, int n, int *done) {
  if (!hv || !gt_all || !offs || !n_alleles || n < 0) return -1;
  GtEncoder *enc = static_cast<GtEncoder *>(hv);
  for (int i = 0; i < n; ++i) {
    int rc = enc->encode_record(gt_all + offs[i], offs[i + 1] - offs[i],
                                n_alleles[i]);
    if (rc != 0) {
      if (done) *done = i;
      return rc;
    }
  }
  if (done) *done = n;
  return 0;
}

int64_t xsi_enc_serialize(void *hv, uint8_t *out, int64_t cap) {
  if (!hv || !out) return -1;
  return static_cast<GtEncoder *>(hv)->serialize(out, cap);
}

int xsi_enc_bcf_lines(void *hv) {
  if (!hv) return -1;
  return static_cast<GtEncoder *>(hv)->bcf_lines;
}

const char *xsi_enc_error(void *hv) {
  if (!hv) return "no encoder handle";
  return static_cast<GtEncoder *>(hv)->error.c_str();
}

void xsi_enc_close(void *hv) { delete static_cast<GtEncoder *>(hv); }

}  // extern "C"

/* ------------------------------------------------------------------ */
/* Sparse-stream line-offset walk (ops/sparse_np.sparse_line_offsets):
 * each head word stores its line's length, so the walk is inherently
 * scalar pointer-chasing — microseconds in C where the numpy
 * binary-lifting formulation costs ~0.4 ms/block in call overhead.
 * Writes n_lines+1 offsets; returns 0, or -1 when the walk leaves the
 * stream (truncated/corrupt input — callers raise).  Head masks follow
 * the A_T width (u16/u32). */
extern "C" int xsi_sparse_offsets16(const uint16_t *s, int64_t n,
                                    int64_t n_lines, int64_t *out) {
  if (!s || !out || n_lines < 0) return -1;
  int64_t pos = 0;
  for (int64_t i = 0; i < n_lines; ++i) {
    out[i] = pos;
    if (pos >= n) return -1;
    pos += 1 + int64_t(s[pos] & 0x7FFF);
  }
  out[n_lines] = pos;
  return pos <= n ? 0 : -1;
}

extern "C" int xsi_sparse_offsets32(const uint32_t *s, int64_t n,
                                    int64_t n_lines, int64_t *out) {
  if (!s || !out || n_lines < 0) return -1;
  int64_t pos = 0;
  for (int64_t i = 0; i < n_lines; ++i) {
    out[i] = pos;
    if (pos >= n) return -1;
    pos += 1 + int64_t(s[pos] & 0x7FFFFFFF);
  }
  out[n_lines] = pos;
  return pos <= n ? 0 : -1;
}

/* ------------------------------------------------------------------ */
/* One-pass ingest for the DEVICE encoder's batch path
 * (codec/encoder_base.BlockEncoderBase.encode_records): htslib gt
 * values -> compact allele codes + the per-record stats the block
 * serializer needs.  The numpy formulation is ~6 whole-matrix passes
 * (alleles_from_gt masks, missing/EOV/ALT reductions, phase scan);
 * this is ONE streaming pass at memory bandwidth.  Reference cost
 * being replaced: per-line scan_genotypes, gt_block.hpp:207-269.
 *
 * Records i in [0, n) occupy gt_all[i*W : (i+1)*W] (uniform width —
 * the Python caller splits segments into uniform runs).  Outputs:
 *   codes_out[n*W]  int8 allele codes (missing -1, EOV -2); requires
 *                   max n_alleles <= 127 (caller falls back otherwise)
 *   miss_out[n]     count of missing slots per record
 *   eov_out[n]      count of END_OF_VECTOR slots per record
 *   alt_out         per-ALT carrier counts, record i at
 *                   alt_out[alt_offs[i] .. alt_offs[i+1])  (na[i]-1 slots)
 *   nup_out[n]      1 when any odd slot's phase bit != default_phasing
 *                   (full row recomputed host-side only when flagged);
 *                   untouched when check_phase == 0
 * Returns 0, -1 on bad arguments. */
extern "C" int xsi_ingest_codes(const int32_t *gt_all, const int32_t *n_alleles,
                                int64_t n, int64_t W, int default_phasing,
                                int check_phase, int8_t *codes_out,
                                int32_t *miss_out, int32_t *eov_out,
                                int64_t *alt_out, const int64_t *alt_offs,
                                uint8_t *nup_out) {
  if (!gt_all || !n_alleles || n < 0 || W <= 0 || !codes_out || !miss_out ||
      !eov_out || !alt_out || !alt_offs || (check_phase && !nup_out))
    return -1;
  for (int64_t i = 0; i < n; ++i) {
    const int32_t *__restrict gt = gt_all + i * W;
    int8_t *__restrict codes = codes_out + i * W;
    int64_t *__restrict alt = alt_out + alt_offs[i];
    const int32_t na = n_alleles[i];
    /* Pass 1 — codes: branch-free selects, auto-vectorized.  numpy
     * truncates to int8 BEFORE the -1; stats run on the truncated value,
     * replicated exactly so malformed huge alleles stay bit-identical to
     * the Python oracle. */
    for (int64_t j = 0; j < W; ++j) {
      const int32_t g = gt[j];
      const int32_t s = g >> 1;                 /* arithmetic, like numpy */
      int8_t c = (int8_t)((int8_t)s - 1);
      c = (s == 0 || g == kMissing32) ? (int8_t)-1 : c;
      c = (g == kVectorEnd32) ? (int8_t)-2 : c;
      codes[j] = c;
    }
    /* Pass 2 — counts over the int8 codes (SIMD compares).  The
     * biallelic carrier count folds in; the general per-ALT histogram
     * (rare multi-ALT) takes the scalar loop. */
    int32_t miss = 0, eov = 0;
    if (na == 2) {
      int64_t ones = 0;
      for (int64_t j = 0; j < W; ++j) {
        const int8_t c = codes[j];
        miss += (c == (int8_t)-1);
        eov += (c == (int8_t)-2);
        ones += (c == (int8_t)1);
      }
      alt[0] += ones;
    } else {
      for (int64_t j = 0; j < W; ++j) {
        const int8_t c = codes[j];
        miss += (c == (int8_t)-1);
        eov += (c == (int8_t)-2);
        if (c >= 1 && c < na) alt[c - 1]++;
      }
    }
    miss_out[i] = miss;
    eov_out[i] = eov;
    /* Pass 3 — phase: OR the odd slots' gt values and test bit 0 against
     * the default ("any odd slot's phase bit differs")... with a twist:
     * OR alone loses which value differed, so OR gt^default instead.
     * Odd slots are the high 32 bits of each little-endian 8-byte pair —
     * a contiguous uint64 OR-reduction the compiler vectorizes, no
     * strided loads. */
    if (check_phase) {
      uint32_t any_differs;
      if ((W & 1) == 0) {
        const uint64_t *__restrict p = (const uint64_t *)(const void *)gt;
        const int64_t np_ = W >> 1;
        if (default_phasing == 0) {          /* any phase bit SET */
          uint64_t acc64 = 0;
          for (int64_t k = 0; k < np_; ++k) acc64 |= p[k];
          any_differs = (uint32_t)(acc64 >> 32) & 1u;
        } else {                             /* any phase bit CLEAR */
          uint64_t acc64 = ~0ull;
          for (int64_t k = 0; k < np_; ++k) acc64 &= p[k];
          any_differs = (~(uint32_t)(acc64 >> 32)) & 1u;
        }
      } else {
        uint32_t acc = 0;
        for (int64_t j = 1; j < W; j += 2)
          acc |= (uint32_t)gt[j] ^ (uint32_t)default_phasing;
        any_differs = acc & 1u;
      }
      nup_out[i] = (uint8_t)any_differs;
    }
  }
  return 0;
}
