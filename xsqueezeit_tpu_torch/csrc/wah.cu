// WAH2 expand and compress, written from the output side.
//
// Format (16-bit WAH2): bit 15 set = counter word, bit 14 = fill value, low
// 14 bits = run length in 15-bit groups (at most MAXC = 16383); otherwise
// the word is a 15-bit literal.
//
// EXPAND replaces xsqueezeit_tpu/ops/wah_pallas.py _expand_kernel (:51-89,
// entry wah_expand_pallas :291-346) and, being driven by each line's own
// word range, the contract of _expand_rows_kernel (:189-218, the TPU's form
// for wide lines); with VARW it replaces the XLA function
// wah_jax.wah_expand_stream_varw (:227-262, mixed-ploidy blocks: line l has
// its own width group_off[l+1] - group_off[l] <= w).  It expands a block's
// concatenated stream into int32[n_lines, w] 15-bit groups (counters
// resolved to 0 / 0x7FFF fills, rows past the stream's end all zero), or,
// with BITS, straight into uint8[n_lines, h] bits: wah_jax.wah_decode_lines,
// expand and unpack_bits in one (bits past a VARW line's width are 0).
//   Bound: the bytes of the output grid (the stream is tens of times
//   smaller), written once.  The earlier CUDA form paid instead for
//   per-line offsets in plain torch (about seven launches with int64
//   temporaries), for one thread filling a counter's whole span while the
//   others idled, for a block scan per 128-word tile and, on the bits path,
//   for unpack_bits' two int32[L, w, 15] temporaries (4 GB at HRC).
//   Design: wah_span_scan_kernel, one single-pass decoupled look-back scan,
//   writes the inclusive prefix of the word spans (int32, saturating at
//   INT_MAX: a block's lines span at most 8192 * 32767 groups, so every
//   prefix inside the lines is exact, and anything past them only needs to
//   compare greater).  Each line's warp then finds its word range [a, b) by
//   a 33-way search for lo and hi (l*w and (l+1)*w, or group_off[l] and
//   group_off[l+1]): searchsorted(..., right=True), as
//   wah_torch.wah_word_offsets.  The line's words and their group starts go
//   to shared memory (with a CTA per line each start in 16 bits, relative
//   to the line and biased: 6 bytes per word slot, so one CTA holds a line
//   of the format's widest, 32,767 groups, 491,505 haplotypes, in 196,606
//   bytes).  The line's groups are then resolved there, eight consecutive
//   groups per thread and step (a binary search in the shared starts finds
//   the first one's covering word, as wah_decode_lines finds it; the others
//   walk on from it), and every thread stores 16-byte chunks of the output
//   row from the shared groups: four groups, or 16
//   bits cut from two groups with one shift (rows need not be 16-byte
//   aligned: chunks are aligned in the flat output, the ragged ends store
//   by element).  No thread fills a counter's span; no per-tile scan.  A
//   warp serves a line (four lines per CTA) for narrow lines, a CTA of 256
//   threads for wide ones (the wrapper picks; PERF.md has both timed).
//
// COMPRESS replaces wah_pallas.py _compress_kernel (:112-155, entry
// wah_compress_pallas :159-186): per row of packed 15-bit words, runs of
// all-0 / all-0x7FFF words become counters split at MAXC, literals pass
// through, output front-packed with the word count n_out.  With BITS it
// reads uint8/bool bit rows [R, h] (any row stride) and packs 15 bits per
// group itself: wah_jax.wah_encode_lines, pack_bits and RLE in one.
//   Bound: one read of the row (words, or bits) and one write of the
//   output words.  The earlier form walked a row in 128-word tiles, one after
//   another, with two block scans (four barriers) per tile: latency-bound
//   at HRC width (34 tiles); on the path, torch pack_bits added three
//   full-size int32 copies of the bit matrix (5.5 GB moved at HRC).
//   Design: one CTA per row.  The row's words are staged in shared memory
//   (with BITS, each packed from the one or two 16-byte chunks of the bit
//   row that hold its 15 bytes: no 65 KB row is staged, so 8 CTAs fit an
//   SM); each thread owns a contiguous segment of about w / T words and
//   finds its runs serially.  One exclusive max-scan of the
//   segments' last run boundaries gives every segment the run start it
//   continues (the MAXC splits need it), one exclusive sum-scan of the
//   segments' emit counts their output slots: two block scans per row.  The
//   compacted words are staged in shared memory and stored with 16-byte
//   stores, zero tail included.
#include <climits>
#include <type_traits>

#include "scan.cuh"

constexpr int WAH_HIGH = 0x8000;
constexpr int WAH_ONE = 0x4000;
constexpr int WAH_MAXC = 0x3FFF;
constexpr int WAH_ALL_SET = 0x7FFF;

__device__ __forceinline__ int wah_span(int word) {
    return (word & WAH_HIGH) ? (word & WAH_MAXC) : 1;
}

__device__ __forceinline__ int sat_add(int a, int b) {
    const unsigned s = (unsigned)a + (unsigned)b;
    return s > (unsigned)INT_MAX ? INT_MAX : (int)s;
}

template <typename K>
static cudaError_t allow_smem(K* kernel, size_t bytes) {
    if (bytes <= 48 * 1024) return cudaSuccess;
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// ---- the span scan ------------------------------------------------------

constexpr int SCAN_THREADS = 256;
constexpr int SCAN_ITEMS = 16;
constexpr int SCAN_TILE = SCAN_THREADS * SCAN_ITEMS;
// a tile's status word: flag in the high half, value in the low half
constexpr unsigned long long SCAN_AGGREGATE = 1ull << 32;
constexpr unsigned long long SCAN_INCLUSIVE = 2ull << 32;

// Shared slot of tile element i: one int of padding after every 32, so
// that a thread's run of SCAN_ITEMS elements and a warp's strided loads
// both hit distinct banks.
__device__ __forceinline__ int scan_slot(int i) { return i + (i >> 5); }

// cum[k] = spans of words 0..k, saturating at INT_MAX.  status: one zeroed
// word per tile; ticket: a zeroed counter (tiles are taken in launch
// order, so every tile a CTA waits on belongs to a CTA already running).
// The look-back reads 32 predecessors at once, one per lane of warp 0.

__global__ void __launch_bounds__(SCAN_THREADS)
wah_span_scan_kernel(const uint16_t* __restrict__ stream, int n,
                     int* __restrict__ cum, unsigned long long* status,
                     int* ticket) {
    __shared__ int scratch[32];
    __shared__ int s_tile, s_excl;
    __shared__ int s_val[SCAN_TILE + SCAN_TILE / 32];  // see scan_slot
    if (threadIdx.x == 0) s_tile = atomicAdd(ticket, 1);
    __syncthreads();
    const int tile = s_tile;
    const long base = (long)tile * SCAN_TILE;
    for (int i = threadIdx.x; i < SCAN_TILE; i += SCAN_THREADS) {
        const long k = base + i;
        s_val[scan_slot(i)] = k < n ? wah_span(stream[k]) : 0;
    }
    __syncthreads();
    // a tile's spans sum to at most 4096 * 16383 < 2^31: no saturation
    int v[SCAN_ITEMS];
    int run = 0;
#pragma unroll
    for (int j = 0; j < SCAN_ITEMS; ++j) {
        run += s_val[scan_slot(threadIdx.x * SCAN_ITEMS + j)];
        v[j] = run;
    }
    int total;
    const int ex = block_exclusive_scan<SumOp>(run, scratch, &total);
    if (threadIdx.x < 32) {
        const int lane = threadIdx.x;
        volatile unsigned long long* st = status;
        int excl = 0;
        if (tile > 0) {
            if (lane == 0) st[tile] = SCAN_AGGREGATE | (unsigned)total;
            for (int top = tile - 1;; top -= 32) {
                // lane i reads tile top - i (below tile 0: an inclusive 0)
                unsigned long long s = SCAN_INCLUSIVE;
                if (top - lane >= 0) {
                    do {
                        s = st[top - lane];
                    } while ((s >> 32) == 0);
                }
                const unsigned inc = __ballot_sync(
                    0xffffffffu, (s & SCAN_INCLUSIVE) != 0);
                // sum down to the nearest inclusive prefix, if any
                const int last = inc ? __ffs(inc) - 1 : 31;
                int agg = lane <= last ? (int)(s & 0xFFFFFFFFull) : 0;
#pragma unroll
                for (int o = 16; o > 0; o >>= 1)
                    agg = sat_add(agg, __shfl_xor_sync(0xffffffffu, agg, o));
                excl = sat_add(excl, agg);
                if (inc) break;
            }
        }
        if (lane == 0) {
            st[tile] = SCAN_INCLUSIVE | (unsigned)sat_add(excl, total);
            s_excl = excl;
        }
    }
    __syncthreads();
    const int excl = s_excl;
#pragma unroll
    for (int j = 0; j < SCAN_ITEMS; ++j)
        s_val[scan_slot(threadIdx.x * SCAN_ITEMS + j)] =
            sat_add(excl, ex + v[j]);
    __syncthreads();
    for (int i = threadIdx.x; i < SCAN_TILE; i += SCAN_THREADS) {
        const long k = base + i;
        if (k < n) cum[k] = s_val[scan_slot(i)];
    }
}

// Number of entries of the ascending cum[0, n) that are <= t, found by the
// 32 lanes of a warp together: each round probes 32 points and keeps the
// 33rd part of the range that holds the answer.
__device__ int warp_upper_bound(const int* __restrict__ cum, int n, long t) {
    const int lane = threadIdx.x & 31;
    int lo = 0, hi = n;  // entries below lo are <= t, from hi on > t
    while (hi - lo > 32) {
        const int p = lo + (int)((long)(lane + 1) * (hi - lo) / 33);
        const int c = __popc(__ballot_sync(0xffffffffu, cum[p] <= t));
        const int p_last = __shfl_sync(0xffffffffu, p, c > 0 ? c - 1 : 0);
        const int p_next = __shfl_sync(0xffffffffu, p, c < 32 ? c : 31);
        if (c > 0) lo = p_last + 1;
        if (c < 32) hi = p_next;
    }
    const bool le = lane < hi - lo && cum[lo + lane] <= t;
    return lo + __popc(__ballot_sync(0xffffffffu, le));
}

// ---- expand -------------------------------------------------------------

// Lines per CTA, and the dynamic shared memory of one line: a start and a
// word per word slot, a 15-bit group per group of w_row plus two (mirrored
// by wah_kernels.expand_smem_bytes).
template <int LT>
__host__ __device__ constexpr int lines_per_cta() { return LT == 32 ? 4 : 1; }

// A word's first group, relative to its line's first group.  A warp per
// line (narrow lines) keeps it in an int.  A CTA per line stores it plus
// start_bias in 16 bits, so that one CTA holds the format's widest line:
// the line's first word covers the line's first group, so it starts at
// most WAH_MAXC - 1 groups before it, and the others start inside the
// line (a start past it is stored as w_row, which no group reaches).
// Stored values lie in [1, 49,150]; the searches compare biased values.
template <int LT>
using start_t = typename std::conditional<LT == 32, int, uint16_t>::type;

template <int LT>
__host__ __device__ constexpr int start_bias() {
    return LT == 32 ? 0 : WAH_MAXC;
}

template <int LT>
__host__ __device__ inline size_t expand_line_smem(int w_row) {
    return (size_t)w_row * (sizeof(start_t<LT>) + 4) + 4;
}

// 4 bits -> 4 bytes of 0 / 1 (bit i to byte i): the shifted copies of x
// land on disjoint bit ranges, so the product carries nothing.
__device__ __forceinline__ uint32_t spread_nibble(uint32_t x) {
    return (x * 0x00204081u) & 0x01010101u;
}

template <bool VARW, bool BITS, int LT>
__global__ void __launch_bounds__(LT * lines_per_cta<LT>())
wah_expand_kernel(const uint16_t* __restrict__ stream,
                  const int* __restrict__ cum, int n,
                  const int64_t* __restrict__ group_off,
                  void* __restrict__ out, int n_lines, int w_row,
                  int row_len) {
    constexpr int LPC = lines_per_cta<LT>();
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ int s_ab[LPC][2];
    const int sub = threadIdx.x / LT;  // the CTA's line served by this thread
    const int t = threadIdx.x % LT;
    const long line = (long)blockIdx.x * LPC + sub;
    constexpr int BIAS = start_bias<LT>();
    // per line: starts, words, then groups (uint16, w_row + 2)
    unsigned char* base = smem + sub * expand_line_smem<LT>(w_row);
    start_t<LT>* st = reinterpret_cast<start_t<LT>*>(base);
    uint16_t* wd = reinterpret_cast<uint16_t*>(st + w_row);
    uint16_t* gv = wd + w_row;
    if (line >= n_lines) return;  // whole warps (LT = 32) only
    long lo, hi;
    if (VARW) {
        lo = group_off[line];
        hi = group_off[line + 1];
    } else {
        lo = line * w_row;
        hi = lo + w_row;
    }
    if (LT == 32) {
        const int a = warp_upper_bound(cum, n, lo);
        const int b = warp_upper_bound(cum, n, hi);
        if (t == 0) {
            s_ab[sub][0] = a;
            s_ab[sub][1] = b;
        }
        __syncwarp();
    } else {
        if (t < 64) {
            const int r = warp_upper_bound(cum, n, t < 32 ? lo : hi);
            if ((t & 31) == 0) s_ab[0][t >> 5] = r;
        }
        __syncthreads();
    }
    const int a = s_ab[sub][0];
    // with spans >= 1 a line of w_row groups has at most w_row words
    const int nw = max(0, min(s_ab[sub][1] - a, w_row));
    const int wl =
        VARW ? (int)max(0L, min(hi - lo, (long)w_row)) : w_row;
    for (int j = t; j < nw; j += LT) {
        const long k = (long)a + j;
        wd[j] = stream[k];
        const long s = (k == 0 ? 0L : (long)cum[k - 1]) - lo;
        st[j] = (start_t<LT>)(BIAS ? min(s, (long)w_row) + BIAS : s);
    }
    if (t < 2) gv[w_row + t] = 0;
    if (LT == 32)
        __syncwarp();
    else
        __syncthreads();

    // 1. the line's groups into shared memory, 8 consecutive groups per
    // thread and step: a binary search in the shared starts finds the
    // first group's covering word, the others advance from it
    for (int q0 = 8 * t; q0 < w_row; q0 += 8 * LT) {
        int l = 0, h = nw;
        while (l < h) {
            const int m = (l + h) >> 1;
            if ((int)st[m] <= q0 + BIAS)
                l = m + 1;
            else
                h = m;
        }
        int k = l - 1;  // the last word starting at or before q0
        for (int q = q0; q < min(q0 + 8, w_row); ++q) {
            const int qb = q + BIAS;
            while (k + 1 < nw && (int)st[k + 1] <= qb) ++k;
            int g = 0;
            if (k >= 0 && q < wl) {
                const int word = wd[k];
                if (qb < (int)st[k] + wah_span(word))
                    g = (word & WAH_HIGH)
                            ? ((word & WAH_ONE) ? WAH_ALL_SET : 0)
                            : word;
            }
            gv[q] = (uint16_t)g;
        }
    }
    if (LT == 32)
        __syncwarp();
    else
        __syncthreads();

    // 2. the output row from the shared groups, in 16-byte chunks of the
    // flat output (the row's ragged ends store by element)
    using E = typename std::conditional<BITS, uint8_t, int32_t>::type;
    constexpr int V = 16 / sizeof(E);  // elements per 16-byte chunk
    E* o = static_cast<E*>(out);
    const long g0 = line * (long)row_len, g1 = g0 + row_len;
    for (long c = g0 / V + t; c < (g1 + V - 1) / V; c += LT) {
        const long e0 = max(c * V, g0), e1 = min(c * V + V, g1);
        const int p = (int)(e0 - g0);
        if (e1 - e0 == V) {
            uint32_t pk[4];
            if (BITS) {
                // bits p .. p + 15 lie in groups q and q + 1
                const int q = p / 15;
                const uint32_t v =
                    ((uint32_t)gv[q] | ((uint32_t)gv[q + 1] << 15)) >>
                    (p - 15 * q);
#pragma unroll
                for (int i = 0; i < 4; ++i)
                    pk[i] = spread_nibble((v >> (4 * i)) & 0xF);
            } else {
#pragma unroll
                for (int i = 0; i < 4; ++i) pk[i] = gv[p + i];
            }
            reinterpret_cast<uint4*>(o)[c] =
                make_uint4(pk[0], pk[1], pk[2], pk[3]);
        } else {
            for (long e = e0; e < e1; ++e) {
                const int pe = (int)(e - g0);
                if (BITS)
                    o[e] = (E)((gv[pe / 15] >> (pe % 15)) & 1);
                else
                    o[e] = (E)gv[pe];
            }
        }
    }
}

template <bool VARW, bool BITS, int LT>
static cudaError_t launch_expand(const uint16_t* stream, const int* cum,
                                 int n, const int64_t* group_off, void* out,
                                 int n_lines, int w_row, int row_len,
                                 cudaStream_t st) {
    constexpr int LPC = lines_per_cta<LT>();
    const size_t smem = LPC * expand_line_smem<LT>(w_row);
    auto* kernel = &wah_expand_kernel<VARW, BITS, LT>;
    const cudaError_t e = allow_smem(kernel, smem);
    if (e != cudaSuccess) return e;
    kernel<<<(n_lines + LPC - 1) / LPC, LT * LPC, smem, st>>>(
        stream, cum, n, group_off, out, n_lines, w_row, row_len);
    return cudaGetLastError();
}

template <int LT>
static cudaError_t expand_routes(bool varw, bool bits, const uint16_t* s,
                                 const int* cum, int n, const int64_t* goff,
                                 void* out, int n_lines, int w_row,
                                 int row_len, cudaStream_t st) {
    if (varw)
        return bits ? launch_expand<true, true, LT>(s, cum, n, goff, out,
                                                    n_lines, w_row, row_len,
                                                    st)
                    : launch_expand<true, false, LT>(s, cum, n, goff, out,
                                                     n_lines, w_row,
                                                     row_len, st);
    return bits ? launch_expand<false, true, LT>(s, cum, n, goff, out,
                                                 n_lines, w_row, row_len, st)
                : launch_expand<false, false, LT>(s, cum, n, goff, out,
                                                  n_lines, w_row, row_len,
                                                  st);
}

// stream: uint16[n]; cum: int32[n] scratch; status: 8 * (ceil(n / 4096) +
// 1) bytes of scratch (zeroed here); group_off: int64[n_lines + 1] (varw
// only); out: int32[n_lines, w_row] or (bits) uint8[n_lines, row_len];
// line_threads 32 (a warp per line) or 256 (a CTA per line).
extern "C" int xsi_wah_expand(const void* stream, int n, void* cum,
                              void* status, const void* group_off, void* out,
                              int n_lines, int w_row, int row_len, int varw,
                              int bits, int line_threads, void* st) {
    const cudaStream_t s = (cudaStream_t)st;
    if (n_lines <= 0) return (int)cudaGetLastError();
    if (n > 0) {
        const int tiles = (n + SCAN_TILE - 1) / SCAN_TILE;
        cudaError_t e =
            cudaMemsetAsync(status, 0, (size_t)(tiles + 1) * 8, s);
        if (e != cudaSuccess) return (int)e;
        auto* words = (unsigned long long*)status;
        wah_span_scan_kernel<<<tiles, SCAN_THREADS, 0, s>>>(
            (const uint16_t*)stream, n, (int*)cum, words,
            (int*)(words + tiles));
        e = cudaGetLastError();
        if (e != cudaSuccess) return (int)e;
    }
    const auto* sw = (const uint16_t*)stream;
    const auto* go = (const int64_t*)group_off;
    if (line_threads == 32)
        return (int)expand_routes<32>(varw, bits, sw, (const int*)cum, n, go,
                                      out, n_lines, w_row, row_len, s);
    return (int)expand_routes<256>(varw, bits, sw, (const int*)cum, n, go,
                                   out, n_lines, w_row, row_len, s);
}

// ---- compress -----------------------------------------------------------

// Dynamic shared memory of a compress CTA: the row's words, then the
// output words (131,072 bytes at the format's widest line, w = 32767).
static size_t compress_smem(int w) {
    return ((size_t)w * 2 + 15) / 16 * 16 * 2;
}

// 4 bytes of 0 / 1 -> 4 bits (byte i to bit i): the shifted copies land on
// disjoint bits 24-27, so the product carries nothing into them.
__device__ __forceinline__ uint32_t gather_nibble(uint32_t x) {
    return ((x & 0x01010101u) * 0x01020408u) >> 24 & 0xFu;
}

// 16 bytes of 0 / 1 -> 16 bits.
__device__ __forceinline__ uint32_t gather_chunk(uint4 x) {
    return gather_nibble(x.x) | gather_nibble(x.y) << 4 |
           gather_nibble(x.z) << 8 | gather_nibble(x.w) << 12;
}

__device__ __forceinline__ int word_class(int v) {
    return v == 0 ? 0 : (v == WAH_ALL_SET ? 1 : 2);  // zero, ones, literal
}

template <bool BITS>
__global__ void __launch_bounds__(256)
wah_compress_kernel(const void* __restrict__ src, int ld,
                    uint16_t* __restrict__ out, int32_t* __restrict__ n_out,
                    int w, int h) {
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ int scratch[32];
    const int T = blockDim.x;
    const long r = blockIdx.x;
    uint16_t* wv = reinterpret_cast<uint16_t*>(smem);
    uint16_t* ost = wv + ((size_t)w * 2 + 15) / 16 * 8;
    if (BITS) {
        // word j packs bytes 15j .. 15j + 14 of the row, read as the one or
        // two 16-byte chunks (aligned in memory) that hold them; neighbours
        // share chunks, so each byte comes from device memory about once.
        // A chunk holding a byte of the row lies in the row's allocation;
        // its bytes outside the row are masked off.
        const auto* row = static_cast<const unsigned char*>(src) + r * ld;
        const int off = (int)(reinterpret_cast<uintptr_t>(row) & 15);
        const auto* row0 = reinterpret_cast<const uint4*>(row - off);
#pragma unroll 4
        for (int j = threadIdx.x; j < w; j += T) {
            const int b0 = off + 15 * j;  // byte offset from row0
            const int nb = min(15, h - 15 * j);
            uint32_t m = gather_chunk(__ldg(row0 + (b0 >> 4)));
            if ((b0 & 15) + nb > 16)
                m |= gather_chunk(__ldg(row0 + (b0 >> 4) + 1)) << 16;
            wv[j] = (uint16_t)((m >> (b0 & 15)) & ((1u << nb) - 1));
        }
    } else {
        const auto* row = static_cast<const int32_t*>(src) + r * (long)w;
        for (int j = threadIdx.x; j < w; j += T) wv[j] = (uint16_t)row[j];
    }
    __syncthreads();

    const int seg = (w + T - 1) / T;
    const int j0 = min((int)threadIdx.x * seg, w);
    const int j1 = min(j0 + seg, w);
    int last = -1;  // the segment's last run boundary
    for (int j = j0, pc = j0 > 0 ? word_class(wv[j0 - 1]) : -1; j < j1;
         ++j) {
        const int c = word_class(wv[j]);
        if (c == 2 || c != pc) last = j;
        pc = c;
    }
    int ignored;
    // the run start the segment continues (thread 0 starts at a boundary)
    const int carry = block_exclusive_scan<MaxOp>(last, scratch, &ignored);

    // Walk the segment; word j emits when it ends its run or reaches a
    // multiple of MAXC from the run's start.  Returns the emit count and,
    // with `write`, stores the emitted words from ost[dest] on.
    auto walk = [&](bool write, int dest) {
        int rs = carry, emitted = 0;
        int pc = j0 > 0 ? word_class(wv[j0 - 1]) : -1;
        int c = j0 < w ? word_class(wv[j0]) : 0;
        for (int j = j0; j < j1; ++j) {
            if (c == 2 || c != pc) rs = j;
            const int nc = j + 1 < w ? word_class(wv[j + 1]) : -1;
            if (nc != c || c == 2 || (j + 1 - rs) % WAH_MAXC == 0) {
                if (write)
                    ost[dest + emitted] =
                        c == 2 ? wv[j]
                               : (uint16_t)(WAH_HIGH | (c == 1 ? WAH_ONE : 0) |
                                            ((j - rs) % WAH_MAXC + 1));
                ++emitted;
            }
            pc = c;
            c = nc;
        }
        return emitted;
    };
    int n_total;
    const int dest = block_exclusive_scan<SumOp>(walk(false, 0), scratch,
                                                 &n_total);
    walk(true, dest);
    __syncthreads();

    // the row: n_total words, then zeros up to w, in 16-byte chunks of the
    // flat output (the row's ragged ends store by element)
    const long g0 = r * (long)w, g1 = g0 + w;
    for (long c = g0 / 8 + threadIdx.x; c < (g1 + 7) / 8; c += T) {
        const long e0 = max(c * 8, g0), e1 = min(c * 8 + 8, g1);
        if (e1 - e0 == 8) {
            uint32_t pk[4];
            for (int i = 0; i < 4; ++i) {
                const int p = (int)(c * 8 - g0) + 2 * i;
                const uint32_t a = p < n_total ? ost[p] : 0;
                const uint32_t b = p + 1 < n_total ? ost[p + 1] : 0;
                pk[i] = a | (b << 16);
            }
            reinterpret_cast<uint4*>(out)[c] =
                make_uint4(pk[0], pk[1], pk[2], pk[3]);
        } else {
            for (long e = e0; e < e1; ++e) {
                const int p = (int)(e - g0);
                out[e] = p < n_total ? ost[p] : 0;
            }
        }
    }
    if (threadIdx.x == 0) n_out[r] = n_total;
}

// src: int32[n_rows, w] words, or (bits) uint8/bool rows of h bits, row
// stride ld bytes; out: uint16[n_rows, w]; n_out: int32[n_rows].
extern "C" int xsi_wah_compress(const void* src, int ld, void* out,
                                void* n_out, int n_rows, int w, int h,
                                int bits, void* st) {
    if (n_rows <= 0) return (int)cudaGetLastError();
    const int threads = w <= 1024 ? 128 : 256;
    const size_t smem = compress_smem(w);
    auto* kernel =
        bits ? &wah_compress_kernel<true> : &wah_compress_kernel<false>;
    const cudaError_t e = allow_smem(kernel, smem);
    if (e != cudaSuccess) return (int)e;
    kernel<<<n_rows, threads, smem, (cudaStream_t)st>>>(
        src, ld, (uint16_t*)out, (int32_t*)n_out, w, h);
    return (int)cudaGetLastError();
}
