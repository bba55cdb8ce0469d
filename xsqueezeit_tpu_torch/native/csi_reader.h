/*
 * Minimal CSI (coordinate-sorted index) reader for region seeks in the
 * native libraries — the C port of xsqueezeit_tpu/io/csi.py::CsiIndex
 * (hts-specs CSIv1: an R-tree of binning intervals, BGZF-compressed,
 * magic "CSI\1").  Consumers ask for the minimum BGZF virtual offset of
 * any chunk whose bin may hold records overlapping a region — the seek
 * target for a streaming scan (reference consumers get the equivalent
 * from htslib via bcf_sr_set_regions, the xSqueezeIt reference's xcf.cpp:115-127).
 *
 * All counts/offsets are untrusted file bytes and bounds-checked.
 */
#ifndef XSI_CSI_READER_H
#define XSI_CSI_READER_H

#include "bgzf_reader.h"

#include <cstdint>
#include <map>
#include <string>
#include <utility>
#include <vector>

namespace xsi_native {

class CsiReader {
 public:
  bool ok() const { return ok_; }

  bool load(const std::string &path) {
    BgzfReader r(path);
    if (!r.ok()) return false;
    std::vector<uint8_t> data;
    uint8_t buf[1 << 16];
    for (;;) {
      size_t got = r.read(buf, sizeof buf);
      if (got == 0) break;
      data.insert(data.end(), buf, buf + got);
      if (data.size() > (size_t(1) << 30)) return false;  // absurd index
    }
    size_t pos = 0;
    auto need = [&](size_t n) { return data.size() - pos >= n; };
    auto rd_i32 = [&](int32_t *out) {
      if (!need(4)) return false;
      memcpy(out, data.data() + pos, 4);
      pos += 4;
      return true;
    };
    if (!need(4) || memcmp(data.data(), "CSI\1", 4) != 0) return false;
    pos = 4;
    int32_t l_aux = 0, n_ref = 0;
    if (!rd_i32(&min_shift_) || !rd_i32(&depth_) || !rd_i32(&l_aux))
      return false;
    if (min_shift_ < 0 || min_shift_ > 31 || depth_ < 0 || depth_ > 10 ||
        l_aux < 0 || !need(size_t(l_aux)))
      return false;
    pos += size_t(l_aux);
    if (!rd_i32(&n_ref) || n_ref < 0 || n_ref > (1 << 24)) return false;
    uint32_t meta_bin = n_bins(depth_) + 1;
    bins_.resize(size_t(n_ref));
    for (int32_t rid = 0; rid < n_ref; ++rid) {
      int32_t nb = 0;
      if (!rd_i32(&nb) || nb < 0) return false;
      for (int32_t b = 0; b < nb; ++b) {
        if (!need(16)) return false;
        uint32_t bin_no;
        memcpy(&bin_no, data.data() + pos, 4);
        pos += 4 + 8;  // skip loff (the chunk list suffices for the scan)
        int32_t nc = 0;
        if (!rd_i32(&nc) || nc < 0 || !need(size_t(nc) * 16)) return false;
        for (int32_t c = 0; c < nc; ++c) {
          uint64_t cb, ce;
          memcpy(&cb, data.data() + pos, 8);
          memcpy(&ce, data.data() + pos + 8, 8);
          pos += 16;
          if (bin_no != meta_bin)
            bins_[size_t(rid)][bin_no].emplace_back(cb, ce);
        }
      }
    }
    ok_ = true;
    return true;
  }

  // Minimum virtual offset over chunks of bins overlapping the 0-based
  // half-open interval [beg, end) of reference `rid`; UINT64_MAX when no
  // chunk can hold an overlapping record (empty region).
  uint64_t min_voffset(int rid, int64_t beg, int64_t end) const {
    if (!ok_ || rid < 0 || size_t(rid) >= bins_.size()) return UINT64_MAX;
    const auto &bmap = bins_[size_t(rid)];
    if (bmap.empty()) return UINT64_MAX;
    uint64_t best = UINT64_MAX;
    if (end <= beg) end = beg + 1;
    int64_t e = end - 1;
    int s = min_shift_ + depth_ * 3;
    int64_t t = 0;
    for (int level = 0; level <= depth_; ++level) {
      int64_t b = t + (beg >> s), bend = t + (e >> s);
      for (int64_t bin = b; bin <= bend; ++bin) {
        auto it = bmap.find(uint32_t(bin));
        if (it == bmap.end()) continue;
        for (const auto &ch : it->second)
          if (ch.first < best) best = ch.first;
      }
      s -= 3;
      t += int64_t(1) << (3 * level);
    }
    return best;
  }

 private:
  static uint32_t n_bins(int depth) {
    return ((1u << ((depth + 1) * 3)) - 1) / 7;
  }

  bool ok_ = false;
  int32_t min_shift_ = 14, depth_ = 5;
  std::vector<std::map<uint32_t, std::vector<std::pair<uint64_t, uint64_t>>>>
      bins_;
};

}  // namespace xsi_native

#endif /* XSI_CSI_READER_H */
