/*
 * Native BCF record emitter (see bcf_emit.h).
 *
 * The BGZF member framing matches xsqueezeit_tpu/io/bgzf.py byte for byte:
 * members carry at most 0xFF00 uncompressed bytes, raw-deflate payload at
 * the configured level, BC extra subfield with BSIZE-1, header fields
 * (mtime 0, xfl 0, os 0xFF), trailer CRC32 + ISIZE, and the canonical
 * 28-byte EOF marker.
 */
#include "bcf_emit.h"

#include <zlib.h>

#ifdef USE_LIBDEFLATE
#include <libdeflate.h>
#endif

#include <condition_variable>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <deque>
#include <mutex>
#include <thread>
#include <vector>

namespace {

constexpr size_t MAX_BLOCK = 0xFF00;

const uint8_t BGZF_EOF_MARKER[28] = {
    0x1f, 0x8b, 0x08, 0x04, 0x00, 0x00, 0x00, 0x00, 0x00, 0xff, 0x06, 0x00,
    0x42, 0x43, 0x02, 0x00, 0x1b, 0x00, 0x03, 0x00, 0x00, 0x00, 0x00, 0x00,
    0x00, 0x00, 0x00, 0x00};

/* One BGZF member's async-compression job: `in` is the uncompressed
 * chunk, `out` the fully framed member (header + payload + trailer),
 * byte-identical to the synchronous writer's output. */
struct EmitJob {
  std::vector<uint8_t> in;
  std::vector<uint8_t> out;
  bool done = false;
  bool ok = false;
};

}  // namespace

namespace {

bool raw_deflate_into(const uint8_t *data, size_t n, int level,
#ifdef USE_LIBDEFLATE
                      libdeflate_compressor *ld,
#else
                      void *,
#endif
                      std::vector<uint8_t> *comp, size_t *clen_out) {
#ifdef USE_LIBDEFLATE
  if (ld) {
    comp->resize(libdeflate_deflate_compress_bound(ld, n));
    size_t clen = libdeflate_deflate_compress(ld, data, n, comp->data(),
                                              comp->size());
    if (clen == 0) return false;
    *clen_out = clen;
    return true;
  }
#endif
  // raw deflate at `level` (zlib window -15), same as Python's
  // compressobj(level, DEFLATED, -15)
  uLong bound = compressBound(uLong(n)) + 64;
  comp->resize(bound);
  z_stream zs{};
  if (deflateInit2(&zs, level, Z_DEFLATED, -15, 8,
                   Z_DEFAULT_STRATEGY) != Z_OK)
    return false;
  zs.next_in = const_cast<Bytef *>(data);
  zs.avail_in = uInt(n);
  zs.next_out = comp->data();
  zs.avail_out = uInt(comp->size());
  int rc = deflate(&zs, Z_FINISH);
  *clen_out = comp->size() - zs.avail_out;
  deflateEnd(&zs);
  return rc == Z_STREAM_END;
}

bool use_zlib_env() {
  const char *z = getenv("XSI_EMIT_ZLIB");
  return z && z[0] == '1';
}

/* Build one complete framed BGZF member (header + raw-deflate payload +
 * crc/isize trailer) into `out`.  Deterministic for a given compressor
 * backend and level, so the threaded and synchronous writers produce
 * byte-identical files. */
bool frame_member(const uint8_t *data, size_t n, int level,
#ifdef USE_LIBDEFLATE
                  libdeflate_compressor *ld,
#else
                  void *ld,
#endif
                  std::vector<uint8_t> *scratch, std::vector<uint8_t> *out) {
#ifdef USE_LIBDEFLATE
  // a failed libdeflate_alloc_compressor must be a hard error, not a
  // silent zlib fallback: one starved worker would otherwise emit
  // mixed-backend members, breaking the byte-identity contract
  if (!ld && !use_zlib_env()) return false;
#endif
  size_t clen = 0;
  if (!raw_deflate_into(data, n, level, ld, scratch, &clen)) return false;
  size_t bsize = clen + 25 + 1;  // header(18) + payload + crc(4) + isize(4)
  if (bsize - 1 > 0xFFFF) return false;
  out->resize(18 + clen + 8);
  uint8_t *p = out->data();
  const uint8_t hdr[18] = {
      0x1f, 0x8b, 0x08, 0x04,          // magic, deflate, FEXTRA
      0,    0,    0,    0,             // mtime
      0,    0xff,                      // xfl, os
      0x06, 0x00,                      // xlen = 6
      0x42, 0x43, 0x02, 0x00,          // 'B','C', slen = 2
      uint8_t((bsize - 1) & 0xff), uint8_t(((bsize - 1) >> 8) & 0xff)};
  memcpy(p, hdr, 18);
  memcpy(p + 18, scratch->data(), clen);
  uint32_t crc = uint32_t(crc32(0L, data, uInt(n)));
  uint32_t isize = uint32_t(n);
  uint8_t tail[8] = {
      uint8_t(crc & 0xff),          uint8_t((crc >> 8) & 0xff),
      uint8_t((crc >> 16) & 0xff),  uint8_t((crc >> 24) & 0xff),
      uint8_t(isize & 0xff),        uint8_t((isize >> 8) & 0xff),
      uint8_t((isize >> 16) & 0xff), uint8_t((isize >> 24) & 0xff)};
  memcpy(p + 18 + clen, tail, 8);
  return true;
}

}  // namespace

struct bcf_emit {
  FILE *fp = nullptr;
  int level = 6;
  bool write_eof = true;  // body segments omit the 28-byte EOF marker
  std::vector<uint8_t> buf;        // pending uncompressed bytes (< MAX_BLOCK
                                   // after every write call)
  std::vector<uint8_t> comp;       // scratch for one compressed member
  std::vector<uint8_t> framed;     // scratch for one framed member
  bool failed = false;
#ifdef USE_LIBDEFLATE
  // libdeflate is ~2-3x faster than zlib at equal ratio and is what htslib
  // itself links for BGZF when available; XSI_EMIT_ZLIB=1 forces the zlib
  // path (whose bytes are identical to Python's zlib writer, for the
  // byte-identity tests — content is identical either way).
  libdeflate_compressor *ld = nullptr;
#endif

  // ---- ordered deflate worker pool (bcf_emit_set_threads) ----
  // Members compress on worker threads and are written strictly in file
  // order, so the output is byte-identical to the synchronous writer.
  // Only the extract loop enables this: bcf_emit_tell callers (the
  // variant pass needs per-record virtual offsets) must stay synchronous.
  int n_threads = 0;
  std::vector<std::thread> workers;
  std::mutex mu;
  std::condition_variable cv_work, cv_done;
  std::deque<EmitJob *> order;   // members in file order (owned)
  std::deque<EmitJob *> todo;    // subset not yet compressed (borrowed)
  std::vector<EmitJob *> freelist;
  bool stop_workers = false;

  ~bcf_emit() {
    stop_pool();
    for (EmitJob *j : order) delete j;
    for (EmitJob *j : freelist) delete j;
#ifdef USE_LIBDEFLATE
    if (ld) libdeflate_free_compressor(ld);
#endif
  }

  void stop_pool() {
    if (workers.empty()) return;
    {
      std::lock_guard<std::mutex> lk(mu);
      stop_workers = true;
    }
    cv_work.notify_all();
    for (auto &t : workers) t.join();
    workers.clear();
  }

  void worker_main() {
#ifdef USE_LIBDEFLATE
    libdeflate_compressor *wld =
        use_zlib_env() ? nullptr : libdeflate_alloc_compressor(level);
#else
    void *wld = nullptr;
#endif
    std::vector<uint8_t> scratch;
    std::unique_lock<std::mutex> lk(mu);
    while (true) {
      cv_work.wait(lk, [&] { return stop_workers || !todo.empty(); });
      if (todo.empty()) {
        if (stop_workers) break;
        continue;
      }
      EmitJob *j = todo.front();
      todo.pop_front();
      lk.unlock();
      bool ok = frame_member(j->in.data(), j->in.size(), level, wld,
                             &scratch, &j->out);
      lk.lock();
      j->ok = ok;
      j->done = true;
      cv_done.notify_all();
    }
    lk.unlock();
#ifdef USE_LIBDEFLATE
    if (wld) libdeflate_free_compressor(wld);
#endif
  }

  /* Write the oldest members' framed bytes in order; `all` drains the
   * whole queue, else just keeps the in-flight window bounded. */
  bool drain(bool all) {
    size_t limit = all ? 0 : size_t(4 * n_threads);
    std::unique_lock<std::mutex> lk(mu);
    while (order.size() > limit) {
      EmitJob *j = order.front();
      cv_done.wait(lk, [&] { return j->done; });
      order.pop_front();
      lk.unlock();
      bool ok = j->ok && fwrite(j->out.data(), 1, j->out.size(), fp) ==
                             j->out.size();
      j->done = j->ok = false;
      j->in.clear();
      lk.lock();
      freelist.push_back(j);
      if (!ok) return false;
    }
    return true;
  }

  bool flush_member_async(const uint8_t *data, size_t n) {
    EmitJob *j;
    {
      std::lock_guard<std::mutex> lk(mu);
      if (freelist.empty()) {
        j = new EmitJob();
      } else {
        j = freelist.back();
        freelist.pop_back();
      }
    }
    j->in.assign(data, data + n);
    {
      std::lock_guard<std::mutex> lk(mu);
      order.push_back(j);
      todo.push_back(j);
    }
    cv_work.notify_one();
    return drain(false);
  }

  bool flush_member(const uint8_t *data, size_t n) {
    if (n_threads > 0) return flush_member_async(data, n);
#ifdef USE_LIBDEFLATE
    if (!ld && !use_zlib_env()) ld = libdeflate_alloc_compressor(level);
    auto *sld = use_zlib_env() ? nullptr : ld;
#else
    void *sld = nullptr;
#endif
    if (!frame_member(data, n, level, sld, &comp, &framed)) return false;
    return fwrite(framed.data(), 1, framed.size(), fp) == framed.size();
  }

  void write(const uint8_t *data, size_t n) {
    if (failed) return;
    buf.insert(buf.end(), data, data + n);
    while (buf.size() >= MAX_BLOCK) {
      if (!flush_member(buf.data(), MAX_BLOCK)) { failed = true; return; }
      buf.erase(buf.begin(), buf.begin() + MAX_BLOCK);
    }
  }
};

extern "C" {

bcf_emit_t *bcf_emit_open_segment(const char *path,
                                  const uint8_t *header_text, uint32_t l_text,
                                  int level, int write_header,
                                  int write_eof) {
  FILE *fp = fopen(path, "wb");
  if (!fp) return nullptr;
  auto *e = new bcf_emit();
  e->fp = fp;
  e->level = level;
  e->write_eof = write_eof != 0;
  if (write_header) {
    const uint8_t magic[5] = {'B', 'C', 'F', 2, 2};
    e->write(magic, 5);
    uint8_t l[4] = {uint8_t(l_text & 0xff), uint8_t((l_text >> 8) & 0xff),
                    uint8_t((l_text >> 16) & 0xff),
                    uint8_t((l_text >> 24) & 0xff)};
    e->write(l, 4);
    e->write(header_text, l_text);
  }
  if (e->failed) {
    fclose(fp);
    delete e;
    return nullptr;
  }
  return e;
}

bcf_emit_t *bcf_emit_open(const char *path, const uint8_t *header_text,
                          uint32_t l_text, int level) {
  return bcf_emit_open_segment(path, header_text, l_text, level, 1, 1);
}

int bcf_emit_records(bcf_emit_t *e, const uint8_t *shared,
                     const uint64_t *sh_off, const uint8_t *prefix,
                     uint32_t prefix_len, const uint8_t *gt_bytes,
                     int32_t n_rec, int32_t row_bytes) {
  if (!e || e->failed) return -1;
  for (int32_t i = 0; i < n_rec; ++i) {
    uint64_t sbeg = sh_off[i], send = sh_off[i + 1];
    uint32_t l_shared = uint32_t(send - sbeg);
    uint32_t l_indiv = prefix_len + uint32_t(row_bytes);
    uint8_t frame[8] = {
        uint8_t(l_shared & 0xff),        uint8_t((l_shared >> 8) & 0xff),
        uint8_t((l_shared >> 16) & 0xff), uint8_t((l_shared >> 24) & 0xff),
        uint8_t(l_indiv & 0xff),         uint8_t((l_indiv >> 8) & 0xff),
        uint8_t((l_indiv >> 16) & 0xff),  uint8_t((l_indiv >> 24) & 0xff)};
    e->write(frame, 8);
    e->write(shared + sbeg, l_shared);
    e->write(prefix, prefix_len);
    e->write(gt_bytes + size_t(i) * size_t(row_bytes), size_t(row_bytes));
    if (e->failed) return -2;
  }
  return 0;
}

uint64_t bcf_emit_tell(bcf_emit_t *e) {
  if (!e || !e->fp) return 0;
  return (uint64_t(ftell(e->fp)) << 16) | uint64_t(e->buf.size());
}

/* Enable the ordered deflate worker pool on an emitter that will never
 * call bcf_emit_tell (virtual offsets require synchronous writes): the
 * extract loop's BGZF deflate is its wall-clock ceiling on multi-core
 * hosts.  Output bytes are identical at any thread count.  Call once,
 * right after open; n <= 0 keeps the synchronous writer. */
int bcf_emit_set_threads(bcf_emit_t *e, int n) {
  if (!e || e->failed) return -1;
  if (!e->workers.empty()) return -2;  // already enabled
  if (n <= 0) return 0;
  if (n > 64) n = 64;  // env overrides arrive unvalidated
  e->n_threads = n;
  for (int i = 0; i < n; ++i) {
    try {
      e->workers.emplace_back([e] { e->worker_main(); });
    } catch (...) {
      // thread creation can fail under RLIMIT_NPROC; whatever spawned
      // keeps working (fewer workers, same ordered output), and zero
      // spawned degrades to the synchronous writer
      if (e->workers.empty()) e->n_threads = 0;
      return -3;
    }
  }
  return 0;
}

int bcf_emit_close(bcf_emit_t *e) {
  if (!e) return -1;
  int rc = 0;
  if (!e->failed && !e->buf.empty()) {
    if (!e->flush_member(e->buf.data(), e->buf.size())) e->failed = true;
    e->buf.clear();
  }
  if (!e->failed && e->n_threads > 0 && !e->drain(true)) e->failed = true;
  if (!e->failed && e->write_eof) {
    if (fwrite(BGZF_EOF_MARKER, 1, 28, e->fp) != 28) e->failed = true;
  }
  rc = e->failed ? -2 : 0;
  fclose(e->fp);
  delete e;
  return rc;
}

}  /* extern "C" */

/* ------------------------------------------------------------------ */
/* VCF text GT-region renderer: the -O v/-O z per-record hot spot.
 *
 * Renders the tab-separated genotype region of one record from the
 * htslib-style int32 array — "a|b\ta/b\t..." with '.' for missing
 * (allele < 0), END_OF_VECTOR truncating a sample's alleles, and a bare
 * "." for a fully-EOV sample.  Exact semantics of the Python renderer
 * io/vcf.py format_gt (the oracle; equality pinned by tests).
 * Returns bytes written, or -1 if `cap` is too small (caller doubles).  */
extern "C" int64_t xsi_format_gt_region(const int32_t *gt, int32_t ploidy,
                                        int32_t n_samples, uint8_t *out,
                                        int64_t cap) {
  static const int32_t kEov = INT32_MIN + 1;  /* bcf_int32_vector_end */
  if (!gt || !out || ploidy <= 0 || n_samples < 0) return -2;
  int64_t p = 0;
  /* every sample writes a TRAILING tab; the last byte is dropped at
   * return (keeps the fast and general branches composable) */
  for (int32_t i = 0; i < n_samples; ++i) {
    /* worst case per allele: '|' + 11 digits; +2 slack per sample */
    if (p + int64_t(ploidy) * 12 + 2 > cap) return -1;
    if (ploidy == 2) {
      /* common diploid cell "a|b\t" with single-digit or missing
       * alleles: codes ((a+1)<<1)|ph for a in [-1, 9] all fall in
       * [0, 21] unsigned (EOV/corrupt values are far outside) —
       * four direct stores, no inner loop */
      int32_t v0 = gt[2 * int64_t(i)], v1 = gt[2 * int64_t(i) + 1];
      if (uint32_t(v0) < 22u && uint32_t(v1) < 22u) {
        out[p] = v0 >= 2 ? uint8_t('0' + (v0 >> 1) - 1) : uint8_t('.');
        out[p + 1] = (v1 & 1) ? '|' : '/';
        out[p + 2] = v1 >= 2 ? uint8_t('0' + (v1 >> 1) - 1) : uint8_t('.');
        out[p + 3] = '\t';
        p += 4;
        continue;
      }
    }
    int64_t sample_start = p;
    for (int32_t j = 0; j < ploidy; ++j) {
      int32_t v = gt[int64_t(i) * ploidy + j];
      if (v == kEov) break;
      if (j) out[p++] = (v & 1) ? '|' : '/';
      int32_t allele = (v >> 1) - 1;
      if (allele < 0) {
        out[p++] = '.';
      } else if (allele < 10) {
        out[p++] = uint8_t('0' + allele);
      } else {
        char tmp[12];
        int k = 0;
        while (allele > 0) { tmp[k++] = char('0' + allele % 10); allele /= 10; }
        while (k) out[p++] = uint8_t(tmp[--k]);
      }
    }
    if (p == sample_start) out[p++] = '.';  /* all-EOV sample */
    out[p++] = '\t';
  }
  return p > 0 ? p - 1 : 0;  /* drop the trailing tab */
}
