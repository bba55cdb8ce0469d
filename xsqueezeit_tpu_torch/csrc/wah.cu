// WAH2 expand and compress, one CTA per line.
//
// Format (16-bit WAH2): bit 15 set = counter word, bit 14 = fill value, low
// 14 bits = run length in 15-bit groups (at most MAXC = 16383); otherwise
// the word is a 15-bit literal.
//
// wah_expand replaces xsqueezeit_tpu/ops/wah_pallas.py _expand_kernel
// (:51-89, entry wah_expand_pallas :290-346); being driven by per-line word
// offsets it also serves the contract of _expand_rows_kernel (:189-218),
// which the TPU needed for wide lines.  It expands a block's concatenated
// stream into int32[n_lines, w] 15-bit groups, counters resolved to 0 /
// 0x7FFF fills, rows past the stream's end all zero.
//   Bound: device-memory writes of the [n_lines, w] grid (the stream is
//   tens of times smaller); each line is independent.
//   Design: line l owns words [offs[l], offs[l+1]) (offsets come from one
//   cumsum + searchsorted in plain torch).  A block scan of the words'
//   spans gives each word its first group; a literal writes one group, a
//   counter writes its fill over its span, and the groups past the last
//   word are zeroed.  The TPU kernel's staged rolls and row cummax are not
//   needed.
//
// wah_compress replaces wah_pallas.py _compress_kernel (:112-155, entry
// wah_compress_pallas :158-186): per row of packed 15-bit words, runs of
// all-0 / all-0x7FFF words become counters split at MAXC, literals pass
// through, output front-packed with the word count n_out.
//   Bound: one read of the words and one write of the output per row;
//   w = 334 at 1KGP3 width, so a row is three tiles of a 128-thread CTA.
//   Design: per tile, a block max-scan of run-boundary positions (carried
//   across tiles) gives each word its run start; the emit flag of word i is
//   "word i+1 starts a run, or the run reaches a multiple of MAXC"; a block
//   sum-scan of the emit flags gives each emitted word its output slot.
//   The TPU kernel's staged-shift compaction is a plain scatter here.
#include "scan.cuh"

constexpr int WAH_THREADS = 128;
constexpr int WAH_HIGH = 0x8000;
constexpr int WAH_ONE = 0x4000;
constexpr int WAH_MAXC = 0x3FFF;
constexpr int WAH_ALL_SET = 0x7FFF;

// With VARW (wah_expand_varw, the mixed-ploidy decode; replaces the XLA
// wah_jax.wah_expand_stream_varw, :226-262) line l has its own width
// group_off[l+1] - group_off[l] <= w, where w is the row stride: groups past
// the line's width are zeroed up to w.
template <bool VARW>
__global__ void __launch_bounds__(WAH_THREADS)
wah_expand_kernel(const uint16_t* __restrict__ stream,
                  const int64_t* __restrict__ offs,
                  const int64_t* __restrict__ group_off,
                  int32_t* __restrict__ out, int w_row) {
    __shared__ int scratch[32];
    const long line = blockIdx.x;
    const long a = offs[line];
    const long b = offs[line + 1];
    int w = w_row;
    if (VARW) {
        const int64_t wl = group_off[line + 1] - group_off[line];
        w = wl < w_row ? (int)wl : w_row;
    }
    int32_t* row = out + line * (long)w_row;
    int base = 0;  // groups covered by the earlier tiles of this line
    for (long t = a; t < b; t += blockDim.x) {
        const long k = t + threadIdx.x;
        int word = 0, span = 0;
        if (k < b) {
            word = stream[k];
            span = (word & WAH_HIGH) ? (word & WAH_MAXC) : 1;
        }
        int tile_total;
        const int g =
            base + block_inclusive_scan<SumOp>(span, scratch, &tile_total) -
            span;
        if (k < b) {
            if (word & WAH_HIGH) {
                const int fill = (word & WAH_ONE) ? WAH_ALL_SET : 0;
                const int end = min(g + span, w);
                for (int x = g; x < end; ++x) row[x] = fill;
            } else if (g < w) {
                row[g] = word;
            }
        }
        base = min(base + tile_total, w);
    }
    for (int x = base + threadIdx.x; x < w_row; x += blockDim.x) row[x] = 0;
}

__device__ __forceinline__ int word_class(int v) {
    return v == 0 ? 0 : (v == WAH_ALL_SET ? 1 : 2);  // zero, ones, literal
}

__global__ void __launch_bounds__(WAH_THREADS)
wah_compress_kernel(const int32_t* __restrict__ words,
                    uint16_t* __restrict__ out,
                    int32_t* __restrict__ n_out, int w) {
    __shared__ int scratch[32];
    const long r = blockIdx.x;
    const int32_t* row = words + r * (long)w;
    uint16_t* orow = out + r * (long)w;
    int run_carry = -1;  // run start of the last word of the previous tile
    int emitted = 0;
    for (int t = 0; t < w; t += blockDim.x) {
        const int i = t + threadIdx.x;
        const bool in = i < w;
        int v = 0, cls = 2;
        bool boundary = false;
        if (in) {
            v = row[i];
            cls = word_class(v);
            boundary = i == 0 || cls == 2 || cls != word_class(row[i - 1]);
        }
        int tile_max;
        const int run_start =
            max(run_carry, block_inclusive_scan<MaxOp>(boundary ? i : -1,
                                                       scratch, &tile_max));
        int emit = 0, val = 0;
        if (in) {
            const int pos = i - run_start;
            val = cls == 2 ? v
                           : (WAH_HIGH | (cls == 1 ? WAH_ONE : 0) |
                              (pos % WAH_MAXC + 1));
            if (i == w - 1) {
                emit = 1;
            } else {
                const int cn = word_class(row[i + 1]);
                emit = (cls == 2 || cn != cls ||
                        (i + 1 - run_start) % WAH_MAXC == 0);
            }
        }
        int tile_emits;
        const int dest =
            emitted + block_inclusive_scan<SumOp>(emit, scratch, &tile_emits) -
            emit;
        if (emit) orow[dest] = (uint16_t)val;
        emitted += tile_emits;
        run_carry = max(run_carry, tile_max);
    }
    for (int x = emitted + threadIdx.x; x < w; x += blockDim.x) orow[x] = 0;
    if (threadIdx.x == 0) n_out[r] = emitted;
}

extern "C" int xsi_wah_expand(const void* stream, const void* offs,
                              void* out, int n_lines, int w, void* st) {
    if (n_lines > 0)
        wah_expand_kernel<false>
            <<<n_lines, WAH_THREADS, 0, (cudaStream_t)st>>>(
                (const uint16_t*)stream, (const int64_t*)offs, nullptr,
                (int32_t*)out, w);
    return (int)cudaGetLastError();
}

extern "C" int xsi_wah_expand_varw(const void* stream, const void* offs,
                                   const void* group_off, void* out,
                                   int n_lines, int w_max, void* st) {
    if (n_lines > 0)
        wah_expand_kernel<true>
            <<<n_lines, WAH_THREADS, 0, (cudaStream_t)st>>>(
                (const uint16_t*)stream, (const int64_t*)offs,
                (const int64_t*)group_off, (int32_t*)out, w_max);
    return (int)cudaGetLastError();
}

extern "C" int xsi_wah_compress(const void* words, void* out, void* n_out,
                                int n_rows, int w, void* st) {
    if (n_rows > 0)
        wah_compress_kernel<<<n_rows, WAH_THREADS, 0, (cudaStream_t)st>>>(
            (const int32_t*)words, (uint16_t*)out, (int32_t*)n_out, w);
    return (int)cudaGetLastError();
}
