/*
 * Shared streaming BGZF reader for the native libraries.
 *
 * One implementation used by both the XSI accessor (xsi_accessor.cpp) and
 * the c_xcf_* shim (c_api.cpp) — previously two near-identical copies that
 * had already diverged in error reporting and bounds checks.  The reference
 * gets this from htslib's bgzf.c; this is a from-scratch reader over the
 * BGZF spec (gzip members with a BC extra subfield carrying BSIZE-1).
 *
 * All length fields are validated before use: the reader parses untrusted
 * file bytes and must fail cleanly (return false / short read) on corrupt
 * or truncated input, never overread.
 */
#ifndef XSI_BGZF_READER_H
#define XSI_BGZF_READER_H

#include <zlib.h>
#ifdef USE_LIBDEFLATE
#include <libdeflate.h>
#endif

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace xsi_native {

class BgzfReader {
 public:
  explicit BgzfReader(const std::string &path)
      : fp_(fopen(path.c_str(), "rb")) {}
  ~BgzfReader() {
    if (fp_) fclose(fp_);
#ifdef USE_LIBDEFLATE
    if (ld_) libdeflate_free_decompressor(ld_);
#endif
  }
  BgzfReader(const BgzfReader &) = delete;
  BgzfReader &operator=(const BgzfReader &) = delete;

  bool ok() const { return fp_ != nullptr; }
  const std::string &error() const { return error_; }

  // Seek to a BGZF virtual offset (coffset << 16 | uoffset): reposition
  // to the member starting at file offset coffset and skip uoffset bytes
  // of its decompressed payload (htslib bgzf_seek semantics — the form
  // CSI/tabix chunk offsets come in).  A voffset pointing at the file end
  // succeeds and leaves the reader at EOF.
  bool seek_virtual(uint64_t voff) {
    if (!fp_) return false;
    long coff = long(voff >> 16);
    size_t uoff = size_t(voff & 0xFFFF);
    if (fseek(fp_, coff, SEEK_SET) != 0) return fail("BGZF: seek failed");
    block_.clear();
    pos_ = 0;
    error_.clear();
    if (!load_block()) {
      if (!error_.empty()) return false;   // malformed member
      return uoff == 0;                    // clean EOF voffset
    }
    if (uoff > block_.size()) return fail("BGZF: seek offset beyond member");
    pos_ = uoff;
    return true;
  }

  // Advance n decompressed bytes without copying them out (frame-skip
  // walks: the record counter touches only the 8-byte length words).
  size_t skip(size_t n) {
    size_t got = 0;
    while (got < n) {
      if (pos_ >= block_.size() && !load_block()) break;
      size_t take = n - got < block_.size() - pos_ ? n - got
                                                   : block_.size() - pos_;
      pos_ += take;
      got += take;
    }
    return got;
  }

  // Read n bytes of decompressed data; returns bytes read (< n at EOF or
  // on a malformed stream — check error() to distinguish).
  size_t read(void *dst, size_t n) {
    auto *out = static_cast<uint8_t *>(dst);
    size_t got = 0;
    while (got < n) {
      if (pos_ >= block_.size() && !load_block()) break;
      size_t take = n - got < block_.size() - pos_ ? n - got
                                                   : block_.size() - pos_;
      memcpy(out + got, block_.data() + pos_, take);
      pos_ += take;
      got += take;
    }
    return got;
  }

 private:
  bool fail(const char *msg) {
    error_ = msg;
    return false;
  }

  bool load_block() {
    member_off_ = ftell(fp_);
    uint8_t hdr[18];
    if (fread(hdr, 1, 18, fp_) != 18) {
      end_off_ = member_off_;
      return false;  // EOF (not an error)
    }
    if (hdr[0] != 0x1f || hdr[1] != 0x8b) return fail("BGZF: bad gzip magic");
    uint16_t xlen = uint16_t(hdr[10]) | (uint16_t(hdr[11]) << 8);
    std::vector<uint8_t> extra(xlen);
    memcpy(extra.data(), hdr + 12, xlen < 6 ? xlen : 6);
    if (xlen > 6 &&
        fread(extra.data() + 6, 1, xlen - 6, fp_) != size_t(xlen - 6))
      return fail("BGZF: truncated extra field");
    int bsize = -1;
    for (size_t off = 0; off + 4 <= extra.size();) {
      uint16_t slen =
          uint16_t(extra[off + 2]) | (uint16_t(extra[off + 3]) << 8);
      if (extra[off] == 'B' && extra[off + 1] == 'C' && slen == 2) {
        if (off + 6 > extra.size()) return fail("BGZF: malformed BC subfield");
        bsize = (int(extra[off + 4]) | (int(extra[off + 5]) << 8)) + 1;
        break;
      }
      off += 4 + slen;
    }
    if (bsize < 0) return fail("BGZF: missing BC subfield");
    int comp_len = bsize - 12 - int(xlen) - 8;
    if (comp_len < 0) return fail("BGZF: malformed BSIZE");
    std::vector<uint8_t> comp(size_t(comp_len), 0);
    if (fread(comp.data(), 1, comp_len, fp_) != size_t(comp_len))
      return fail("BGZF: truncated block");
    uint8_t tail[8];
    if (fread(tail, 1, 8, fp_) != 8) return fail("BGZF: truncated trailer");
    uint32_t isize;
    memcpy(&isize, tail + 4, 4);
    // BGZF caps uncompressed payload at 64 KiB per member; a corrupt ISIZE
    // must not drive a huge allocation.
    if (isize > (1u << 16)) return fail("BGZF: ISIZE exceeds 64 KiB");
    block_.resize(isize);
    pos_ = 0;
    end_off_ = ftell(fp_);
    if (isize == 0) return load_block();  // EOF marker member: try next
#ifdef USE_LIBDEFLATE
    // libdeflate raw inflate: ~2x zlib, htslib's own choice when present.
    if (!ld_) ld_ = libdeflate_alloc_decompressor();
    size_t actual = 0;
    if (libdeflate_deflate_decompress(ld_, comp.data(), size_t(comp_len),
                                      block_.data(), isize, &actual)
            != LIBDEFLATE_SUCCESS || actual != isize)
      return fail("BGZF: inflate failed");
    return true;
#else
    z_stream zs{};
    if (inflateInit2(&zs, -15) != Z_OK) return fail("zlib init failed");
    zs.next_in = comp.data();
    zs.avail_in = uInt(comp_len);
    zs.next_out = block_.data();
    zs.avail_out = isize;
    int rc = inflate(&zs, Z_FINISH);
    inflateEnd(&zs);
    if (rc != Z_STREAM_END) return fail("BGZF: inflate failed");
    return true;
#endif
  }

  FILE *fp_;
#ifdef USE_LIBDEFLATE
  libdeflate_decompressor *ld_ = nullptr;
#endif
  std::vector<uint8_t> block_;
  size_t pos_ = 0;
  long member_off_ = 0;  // file offset of the current member's start
  long end_off_ = 0;     // file offset just past the current member
  std::string error_;

 public:
  // Virtual offset of the next byte to be read (htslib coordinates:
  // member file offset << 16 | intra-member offset).  When the current
  // member is exhausted, points at the next member's start — the form
  // CSI chunk-end comparisons expect.
  uint64_t tell_virtual() const {
    if (pos_ < block_.size())
      return (uint64_t(member_off_) << 16) | uint64_t(pos_);
    return uint64_t(end_off_) << 16;
  }
};

}  // namespace xsi_native

#endif  /* XSI_BGZF_READER_H */
