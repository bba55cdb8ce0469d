// The PBWT encode's chunk-start rank chain as a log-depth scan of row sorts.
//
// Replaces the XLA function xsqueezeit_tpu/ops/pbwt_jax.py _rank_chain
// (:213-282, a lax.scan over chunks inside the jitted pbwt_encode_chunked
// and pbwt_encode_keys).
//   What it computes.  T[t, h] < 2^31 is haplotype h's history total over
//   chunk t (bit k = the chunk's k-th sorting line, latest highest); r_0 =
//   r0 is a permutation of 0..H-1 and r_{t+1} = rank of h by (T_t[h],
//   r_t[h]).  Outputs r_starts[t] = r_t (t < n_ch) and r_final = r_{n_ch}.
//   Formulation (ops/pbwt_kernels.py rank_chain_levels_plain states it
//   step by step).  Ranks are unique, so r_t = rank of h by (T_{t-1}[h],
//   ..., T_0[h], r_0[h]) (the radix identity, pbwt_jax.py:221-224) = rank
//   by (P_t[h], r_0[h]), P_t the dense rank of the tuple (T_{t-1}, ...,
//   T_0) over h (P_0 = 0).  Dense ranks compose: level 0 sets W_t = the
//   dense rank of T_{t-1}; the level of stride d = 1, 2, 4, ... sets W_t =
//   the dense rank of (W_t, W_{t-d}) for t > d (Hillis-Steele), so W_t =
//   P_t once d >= n_ch; a final level ranks (P_t, r_0).  Each level is n_ch
//   independent row sorts spread over every SM.  A dense rank needs no
//   stable sort; only the LSD passes inside one sort are stable.
//   Keys: a pair is (W_t << lb) | W_{t-d}, lb the bits of W_{t-d}'s
//   distinct count (each level writes every row's count); a row whose pair
//   cannot change it is taken as it is (W_t all distinct or W_{t-d} all
//   equal: W_t; W_t all equal: W_{t-d}; at the final level P_t all
//   distinct: r_t = P_t, all equal: r_t = r_0); a pass whose 8-bit digit is
//   the same on the whole row is skipped.
//   Bound: the bytes of T (read once) and of r_starts and r_final (written
//   once).  What holds it above that is ceil(log2 n_ch) + 2 levels of row
//   sorts, their digit passes and the W rows (double buffered in device
//   memory, L2-resident at 1KGP3 width) read and written once a level.
//   Layout, two routes by width (ops/pbwt_kernels.py rank_route):
//   - H <= 16,384 (SMEM_H): a row a CTA of 512 threads, its u32 keys and
//     u16 payloads double buffered in shared memory, one launch a level.
//     Warp w owns a contiguous segment of the row.  A pass: per-warp digit
//     counts by match groups (laid out [warp][digit], so that a warp's
//     lanes hit distinct banks), a scan of them (digits in order, each
//     digit's warps in order), and a stable scatter (a match group's lanes
//     take consecutive slots after the warp's running count).  A scan of
//     the flags (key != its predecessor) gives the dense ranks; they land
//     by haplotype in shared memory and leave coalesced.
//   - H > 16,384: a row through device memory in tiles of 4096 keys, a CTA
//     a (row, tile): a prep kernel builds the keys, each row's OR / AND and
//     the first pass's digit counts; each pass is a count kernel (digit
//     counts per row and tile; the first pass has the prep's), an offsets
//     kernel (a scan per row over [digit][tile]) and a scatter kernel
//     (stable in-tile ranks as above, the tile sorted in shared memory so
//     that its writes go out coalesced); then a flag-count, a
//     flag-offset and a dense-rank kernel (or, at the final level, one
//     kernel writing positions).  u32 keys and u16 ranks and payloads up to
//     65,535 haplotypes; u64 keys and u32 above (2 * 19 bits at most).
#include <cuda_runtime.h>
#include <stdint.h>

#include "scan.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int DBITS = 8;                 // bits of T or a key per pass
constexpr int RADIX = 1 << DBITS;
constexpr int THREADS = 512;             // every row or tile kernel
constexpr int WARPS = THREADS / 32;
constexpr int ITEMS = 8;                 // keys a thread holds in a tile
constexpr int TILE = THREADS * ITEMS;    // keys a CTA (device route)
constexpr int SEG = TILE / WARPS;        // keys a warp in a tile
constexpr int SCAN_THREADS = 1024;       // the per-row offset scans
constexpr int SMEM_H = 16384;            // widest row held in shared memory
constexpr int MAX_H = 491505;            // the format's widest panel
constexpr int ALIGN = 256;               // scratch arrays start aligned

enum Level { LEVEL0 = 0, PAIR = 1, FINAL = 2 };
// What a level does with a row: sort its keys, or take a row as it is
// (PAIR: TAKE_HI = W_t, TAKE_LO = W_{t-d}; FINAL: TAKE_HI = P_t, TAKE_LO =
// r_0).
enum RowMode { SORT = 0, TAKE_HI = 1, TAKE_LO = 2 };

using ull = unsigned long long;

__host__ __device__ inline int bits_for(int n) {  // bits of 0..n-1
    int b = 0;
    while ((1 << b) < n) ++b;
    return b;
}

__host__ inline size_t aligned(size_t n) {
    return (n + ALIGN - 1) / ALIGN * ALIGN;
}

// Row w of W holds P_{w+1}; cin[w] is its distinct count.
__device__ inline int row_mode(int lv, int w, int d, const int* cin, int H) {
    if (lv == LEVEL0) return SORT;
    if (lv == PAIR) {
        if (w < d) return TAKE_HI;  // its window already reaches T_0
        const int ch = cin[w], cl = cin[w - d];
        if (ch == H || cl == 1) return TAKE_HI;
        return ch == 1 ? TAKE_LO : SORT;
    }
    const int c = cin[w];
    return c == H ? TAKE_HI : c == 1 ? TAKE_LO : SORT;
}

// Bit position of the low part of a key (PAIR, FINAL).
__device__ inline int low_bits(int lv, int w, int d, const int* cin, int H) {
    return lv == PAIR ? bits_for(cin[w - d]) : bits_for(H);
}

template <typename K, typename R>
__device__ inline K make_key(int lv, const int32_t* T, const int64_t* r0,
                             const R* Win, int w, int d, int lb, int H,
                             int h) {
    if (lv == LEVEL0) return (K)(uint32_t)T[(size_t)w * H + h];
    const K hi = (K)Win[(size_t)w * H + h];
    const K lo = lv == PAIR ? (K)Win[(size_t)(w - d) * H + h] : (K)r0[h];
    return (hi << lb) | lo;
}

// The output row of the final level for W row w: r_{w+1}.
__device__ inline int64_t* final_row(int64_t* r_starts, int64_t* r_final,
                                     int w, int n_ch, int H) {
    return w + 1 < n_ch ? r_starts + (size_t)(w + 1) * H : r_final;
}

// Element h of a row taken as it is (mode TAKE_HI or TAKE_LO).
template <typename R>
__device__ inline void take(int lv, int mode, const int64_t* r0,
                            const R* Win, R* Wout, int64_t* rout, int w,
                            int d, int H, int h) {
    if (lv == PAIR)
        Wout[(size_t)w * H + h] =
            Win[(size_t)(mode == TAKE_HI ? w : w - d) * H + h];
    else
        rout[h] = mode == TAKE_HI ? (int64_t)Win[(size_t)w * H + h] : r0[h];
}

// Whether a row taken as it is must be written: not where it was W_t at
// the previous level too (pin: that level's modes), which wrote it into
// the buffer this level writes (a row once complete or all distinct stays
// so, and both buffers hold it).
__device__ inline bool must_take(int lv, int mode, const int* pin, int w) {
    return lv != PAIR || mode != TAKE_HI || pin[w] != TAKE_HI;
}

__device__ inline bool digit_varies(ull vary, int s) {
    return ((vary >> s) & (RADIX - 1)) != 0;
}

// Passes run before the pass of shift s: its source buffer's parity.
__device__ inline int passes_below(ull vary, int s) {
    int n = 0;
    for (int x = 0; x < s; x += DBITS) n += digit_varies(vary, x);
    return n;
}

template <typename K>
__device__ __forceinline__ K warp_or(K x) {
#pragma unroll
    for (int o = 16; o; o >>= 1) x |= __shfl_xor_sync(FULL, x, o);
    return x;
}

template <typename K>
__device__ __forceinline__ K warp_and(K x) {
#pragma unroll
    for (int o = 16; o; o >>= 1) x &= __shfl_xor_sync(FULL, x, o);
    return x;
}

// ---------------------------------------------------------------------
// Shared-memory route: one CTA a row and level.

// Dynamic shared memory of the shared-memory route at width H: keys (u32)
// and payloads (u16), double buffered, and the [warp][digit] counts (u16:
// a count or prefix is <= H <= 16,384).
__host__ inline size_t smem_bytes(int H) {
    const size_t Hp = (size_t)(H + 31) & ~(size_t)31;
    return 2 * Hp * 4 + 2 * Hp * 2 + (size_t)RADIX * WARPS * 2;
}

// The [warp][digit] counts of a row or tile (each warp's keys a
// contiguous run, warps in order) made the first position of each
// (warp, digit) among the keys sorted by digit; a barrier follows.  Every
// thread of the CTA calls it.
template <typename C>
__device__ void warp_digit_offsets(C* hist, int* scratch) {
    const int tid = threadIdx.x;
    int tot = 0;
    if (tid < RADIX)
        for (int q = 0; q < WARPS; ++q) tot += hist[q * RADIX + tid];
    int total;
    const int start = block_exclusive_scan<SumOp>(tot, scratch, &total);
    if (tid < RADIX) {
        int run = start;
        for (int q = 0; q < WARPS; ++q) {
            const int c = hist[q * RADIX + tid];
            hist[q * RADIX + tid] = (C)run;
            run += c;
        }
    }
    __syncthreads();
}

// One stable LSD pass of the keys sk / sv (digit at shift s) into dk / dv.
__device__ void smem_pass(const uint32_t* sk, const uint16_t* sv,
                          uint32_t* dk, uint16_t* dv, uint16_t* hist,
                          int* scratch, int s, int s0, int s1) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const unsigned lt = (1u << lane) - 1u;
    uint16_t* mine = hist + warp * RADIX;  // this warp's digit counts
    for (int dg = lane; dg < RADIX; dg += 32) mine[dg] = 0;
    __syncwarp();
    for (int g = s0; g < s1; g += 32) {
        const int p = g + lane;
        const int dg = p < s1 ? (int)((sk[p] >> s) & (RADIX - 1)) : RADIX;
        const unsigned m = __match_any_sync(FULL, dg);
        if (dg < RADIX && lane == __ffs(m) - 1) mine[dg] += __popc(m);
        __syncwarp();
    }
    __syncthreads();
    warp_digit_offsets(hist, scratch);
    for (int g = s0; g < s1; g += 32) {
        const int p = g + lane;
        uint32_t k = 0;
        uint16_t v = 0;
        int dg = RADIX;
        if (p < s1) {
            k = sk[p];
            v = sv[p];
            dg = (int)((k >> s) & (RADIX - 1));
        }
        const unsigned m = __match_any_sync(FULL, dg);
        const int pos = dg < RADIX ? mine[dg] + __popc(m & lt) : 0;
        __syncwarp();
        if (dg < RADIX) {
            dk[pos] = k;
            dv[pos] = v;
            if (lane == __ffs(m) - 1) mine[dg] += __popc(m);
        }
        __syncwarp();
    }
    __syncthreads();
}

__global__ void __launch_bounds__(THREADS)
    rank_level_smem_kernel(int lv, const int32_t* __restrict__ T,
                           const int64_t* __restrict__ r0,
                           const uint16_t* __restrict__ Win,
                           uint16_t* __restrict__ Wout,
                           const int* __restrict__ cin,
                           int* __restrict__ cout,
                           const int* __restrict__ pin,
                           int* __restrict__ pout,
                           int64_t* __restrict__ r_starts,
                           int64_t* __restrict__ r_final, int n_ch, int H,
                           int d) {
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ uint32_t red_or[WARPS], red_and[WARPS];
    __shared__ int tot[WARPS];
    __shared__ int scratch[32];
    const int Hp = (H + 31) & ~31;
    uint32_t* keys = reinterpret_cast<uint32_t*>(smem);           // [2][Hp]
    uint16_t* vals = reinterpret_cast<uint16_t*>(keys + 2 * Hp);  // [2][Hp]
    uint16_t* hist = vals + 2 * Hp;                     // [WARPS][RADIX]
    const int w = blockIdx.x, tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;
    const int mode = row_mode(lv, w, d, cin, H);
    int64_t* rout =
        lv == FINAL ? final_row(r_starts, r_final, w, n_ch, H) : nullptr;
    if (tid == 0) pout[w] = mode;
    if (mode != SORT) {
        if (must_take(lv, mode, pin, w))
            for (int h = tid; h < H; h += THREADS)
                take(lv, mode, r0, Win, Wout, rout, w, d, H, h);
        if (lv == PAIR && tid == 0)
            cout[w] = cin[mode == TAKE_HI ? w : w - d];
        return;
    }
    const int lb = lv == LEVEL0 ? 0 : low_bits(lv, w, d, cin, H);
    uint32_t o = 0, a = FULL;
    for (int h = tid; h < H; h += THREADS) {
        const uint32_t k =
            make_key<uint32_t, uint16_t>(lv, T, r0, Win, w, d, lb, H, h);
        keys[h] = k;
        vals[h] = (uint16_t)h;
        o |= k;
        a &= k;
    }
    o = __reduce_or_sync(FULL, o);
    a = __reduce_and_sync(FULL, a);
    if (lane == 0) {
        red_or[warp] = o;
        red_and[warp] = a;
    }
    __syncthreads();
    o = 0;
    a = FULL;
    for (int i = 0; i < WARPS; ++i) {
        o |= red_or[i];
        a &= red_and[i];
    }
    const uint32_t vary = o & ~a;
    const int seg = ((H + WARPS - 1) / WARPS + 31) & ~31;
    const int s0 = min(warp * seg, H), s1 = min(s0 + seg, H);
    int cur = 0;
    for (int s = 0; s < 32; s += DBITS) {
        if (!digit_varies(vary, s)) continue;
        smem_pass(keys + cur * Hp, vals + cur * Hp, keys + (cur ^ 1) * Hp,
                  vals + (cur ^ 1) * Hp, hist, scratch, s, s0, s1);
        cur ^= 1;
    }
    const uint32_t* sk = keys + cur * Hp;
    const uint16_t* sv = vals + cur * Hp;
    // the result by haplotype, in the free key buffer
    uint16_t* byh = reinterpret_cast<uint16_t*>(keys + (cur ^ 1) * Hp);
    if (lv == FINAL) {
        for (int p = tid; p < H; p += THREADS) byh[sv[p]] = (uint16_t)p;
    } else {
        const unsigned lt = (1u << lane) - 1u;
        int n = 0;
        for (int g = s0; g < s1; g += 32) {
            const int p = g + lane;
            const bool f = p < s1 && p > 0 && sk[p] != sk[p - 1];
            n += __popc(__ballot_sync(FULL, f));
        }
        if (lane == 0) tot[warp] = n;
        __syncthreads();
        int before = 0, total = 0;
        for (int i = 0; i < WARPS; ++i) {
            if (i < warp) before += tot[i];
            total += tot[i];
        }
        for (int g = s0; g < s1; g += 32) {
            const int p = g + lane;
            const bool f = p < s1 && p > 0 && sk[p] != sk[p - 1];
            const unsigned b = __ballot_sync(FULL, f);
            if (p < s1)
                byh[sv[p]] = (uint16_t)(before + __popc(b & lt) + (f ? 1 : 0));
            before += __popc(b);
        }
        if (tid == 0) cout[w] = total + 1;
    }
    __syncthreads();
    if (lv == FINAL)
        for (int h = tid; h < H; h += THREADS) rout[h] = byh[h];
    else
        for (int h = tid; h < H; h += THREADS)
            Wout[(size_t)w * H + h] = byh[h];
}

// ---------------------------------------------------------------------
// Device-memory route: a CTA a (row, tile), blockIdx.x = w * tiles + tile.

// Adds the warp's digits (RADIX: no key) to the shared counts, one atomic
// a match group.
__device__ inline void count_digit(int* hist, int dg) {
    const unsigned m = __match_any_sync(FULL, dg);
    if (dg < RADIX && (int)(threadIdx.x & 31) == __ffs(m) - 1)
        atomicAdd(&hist[dg], __popc(m));
}

struct Rows {
    ull* rowor;   // [n_ch] OR of the row's keys
    ull* rowand;  // [n_ch] AND of the row's keys
    int* rmode;   // [n_ch] RowMode at this level
};

__device__ inline ull row_vary(const Rows& rw, int w) {
    return rw.rowor[w] & ~rw.rowand[w];
}

template <typename K, typename R>
__global__ void __launch_bounds__(THREADS)
    rank_prep_kernel(int lv, const int32_t* __restrict__ T,
                     const int64_t* __restrict__ r0,
                     const R* __restrict__ Win, R* __restrict__ Wout,
                     const int* __restrict__ cin, int* __restrict__ cout,
                     const int* __restrict__ pin,
                     K* __restrict__ keys, R* __restrict__ vals, Rows rw,
                     int* __restrict__ counts,
                     int64_t* __restrict__ r_starts,
                     int64_t* __restrict__ r_final, int n_ch, int H, int d,
                     int tiles) {
    __shared__ ull red_or[WARPS], red_and[WARPS];
    __shared__ int hist[RADIX];
    const int w = blockIdx.x / tiles, tile = blockIdx.x - w * tiles;
    const int h0 = tile * TILE, h1 = min(h0 + TILE, H);
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int mode = row_mode(lv, w, d, cin, H);
    if (tile == 0 && tid == 0) {
        rw.rmode[w] = mode;
        if (lv == PAIR && mode != SORT)
            cout[w] = cin[mode == TAKE_HI ? w : w - d];
    }
    if (mode != SORT) {
        int64_t* rout =
            lv == FINAL ? final_row(r_starts, r_final, w, n_ch, H) : nullptr;
        if (must_take(lv, mode, pin, w))
            for (int h = h0 + tid; h < h1; h += THREADS)
                take(lv, mode, r0, Win, Wout, rout, w, d, H, h);
        return;
    }
    const int lb = lv == LEVEL0 ? 0 : low_bits(lv, w, d, cin, H);
    K* kr = keys + (size_t)w * H;
    R* vr = vals + (size_t)w * H;
    for (int i = tid; i < RADIX; i += THREADS) hist[i] = 0;
    __syncthreads();
    K o = 0, a = ~(K)0;
    for (int g = h0 + warp * 32; g < h1; g += THREADS) {
        const int h = g + lane;
        int dg = RADIX;
        if (h < h1) {
            const K k = make_key<K, R>(lv, T, r0, Win, w, d, lb, H, h);
            kr[h] = k;
            vr[h] = (R)h;
            o |= k;
            a &= k;
            dg = (int)(k & (RADIX - 1));
        }
        count_digit(hist, dg);
    }
    o = warp_or(o);
    a = warp_and(a);
    if (lane == 0) {
        red_or[warp] = o;
        red_and[warp] = a;
    }
    __syncthreads();
    if (tid == 0) {
        ull oo = 0, aa = ~0ull;
        for (int i = 0; i < WARPS; ++i) {
            oo |= red_or[i];
            aa &= red_and[i];
        }
        // a u32 key's high half: 0 in the OR and in the AND, never varying
        atomicOr(&rw.rowor[w], oo);
        atomicAnd(&rw.rowand[w], aa);
    }
    for (int i = tid; i < RADIX; i += THREADS)
        counts[((size_t)w * RADIX + i) * tiles + tile] = hist[i];
}

// Digit counts of one (row, tile), counts[w][digit][tile], for every pass
// but the first (the prep kernel counts digit 0 as it builds the keys).
template <typename K>
__global__ void __launch_bounds__(THREADS)
    rank_count_kernel(int s, const K* __restrict__ keys, size_t plane,
                      Rows rw, int* __restrict__ counts, int H, int tiles) {
    __shared__ int hist[RADIX];
    const int w = blockIdx.x / tiles, tile = blockIdx.x - w * tiles;
    if (rw.rmode[w] != SORT) return;
    const ull vary = row_vary(rw, w);
    if (!digit_varies(vary, s)) return;
    const K* src = keys + (passes_below(vary, s) & 1) * plane + (size_t)w * H;
    const int h0 = tile * TILE, h1 = min(h0 + TILE, H);
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    for (int i = tid; i < RADIX; i += THREADS) hist[i] = 0;
    __syncthreads();
    for (int g = h0 + warp * 32; g < h1; g += THREADS) {
        const int h = g + lane;
        count_digit(hist,
                    h < h1 ? (int)((src[h] >> s) & (RADIX - 1)) : RADIX);
    }
    __syncthreads();
    for (int i = tid; i < RADIX; i += THREADS)
        counts[((size_t)w * RADIX + i) * tiles + tile] = hist[i];
}

// Each row's counts made exclusive prefixes, in [digit][tile] order: the
// first slot of each (digit, tile) in the sorted row.
__global__ void __launch_bounds__(SCAN_THREADS)
    rank_offsets_kernel(int s, Rows rw, int* __restrict__ counts,
                        int tiles) {
    __shared__ int scratch[32];
    const int w = blockIdx.x;
    if (rw.rmode[w] != SORT || !digit_varies(row_vary(rw, w), s)) return;
    int* c = counts + (size_t)w * RADIX * tiles;
    const int n = RADIX * tiles, per = (n + SCAN_THREADS - 1) / SCAN_THREADS;
    const int i0 = min((int)threadIdx.x * per, n), i1 = min(i0 + per, n);
    int sum = 0;
    for (int i = i0; i < i1; ++i) sum += c[i];
    int total;
    int ex = block_exclusive_scan<SumOp>(sum, scratch, &total);
    for (int i = i0; i < i1; ++i) {
        const int x = c[i];
        c[i] = ex;
        ex += x;
    }
}

// One stable LSD pass of a (row, tile): warp w's SEG keys, ITEMS a lane,
// ranked among equal digits by match groups and a running per-warp count;
// the tile is sorted in shared memory first, so that the writes to the
// row go out coalesced (each digit's run of the tile is contiguous there).
template <typename K, typename R>
__global__ void __launch_bounds__(THREADS)
    rank_scatter_kernel(int s, K* __restrict__ keys, R* __restrict__ vals,
                        size_t plane, Rows rw,
                        const int* __restrict__ counts, int H, int tiles) {
    extern __shared__ __align__(16) unsigned char smem[];
    K* kst = reinterpret_cast<K*>(smem);        // [TILE] the tile, sorted
    R* vst = reinterpret_cast<R*>(kst + TILE);  // [TILE] its payloads
    __shared__ int hist[WARPS * RADIX];  // [warp][digit]
    __shared__ int gbase[RADIX];  // row position minus tile position
    __shared__ int scratch[32];
    const int w = blockIdx.x / tiles, tile = blockIdx.x - w * tiles;
    if (rw.rmode[w] != SORT) return;
    const ull vary = row_vary(rw, w);
    if (!digit_varies(vary, s)) return;
    const int par = passes_below(vary, s) & 1;
    const K* sk = keys + par * plane + (size_t)w * H;
    const R* sv = vals + par * plane + (size_t)w * H;
    K* dk = keys + (par ^ 1) * plane + (size_t)w * H;
    R* dv = vals + (par ^ 1) * plane + (size_t)w * H;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const unsigned lt = (1u << lane) - 1u;
    for (int i = tid; i < RADIX * WARPS; i += THREADS) hist[i] = 0;
    __syncthreads();
    const int base = tile * TILE + warp * SEG;
    K k[ITEMS];
    R v[ITEMS];
    int dg[ITEMS], rk[ITEMS];
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
        const int h = base + i * 32 + lane;
        dg[i] = RADIX;
        k[i] = 0;
        v[i] = 0;
        if (h < H) {
            k[i] = sk[h];
            v[i] = sv[h];
            dg[i] = (int)((k[i] >> s) & (RADIX - 1));
        }
        const unsigned m = __match_any_sync(FULL, dg[i]);
        rk[i] = dg[i] < RADIX ? hist[warp * RADIX + dg[i]] + __popc(m & lt)
                              : 0;
        __syncwarp();
        if (dg[i] < RADIX && lane == __ffs(m) - 1)
            hist[warp * RADIX + dg[i]] += __popc(m);
        __syncwarp();
    }
    __syncthreads();
    warp_digit_offsets(hist, scratch);
    // each digit's row position minus its tile position (warp 0's)
    if (tid < RADIX)
        gbase[tid] = counts[((size_t)w * RADIX + tid) * tiles + tile] -
                     hist[tid];
    __syncthreads();
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
        if (dg[i] < RADIX) {
            const int pos = hist[warp * RADIX + dg[i]] + rk[i];
            kst[pos] = k[i];
            vst[pos] = v[i];
        }
    }
    __syncthreads();
    const int n = min(TILE, H - tile * TILE);
    for (int j = tid; j < n; j += THREADS) {
        const K x = kst[j];
        const int g = gbase[(int)((x >> s) & (RADIX - 1))] + j;
        dk[g] = x;
        dv[g] = vst[j];
    }
}

// Flags (key != its predecessor) of each (row, tile) of a sorted row.
template <typename K>
__global__ void __launch_bounds__(THREADS)
    rank_flags_kernel(const K* __restrict__ keys, size_t plane, Rows rw,
                      int* __restrict__ tilecnt, int H, int tiles) {
    __shared__ int scratch[32];
    const int w = blockIdx.x / tiles, tile = blockIdx.x - w * tiles;
    if (rw.rmode[w] != SORT) return;
    const K* sk =
        keys + (passes_below(row_vary(rw, w), 64) & 1) * plane + (size_t)w * H;
    const int h0 = tile * TILE, h1 = min(h0 + TILE, H);
    int n = 0;
    for (int h = h0 + (int)threadIdx.x; h < h1; h += THREADS)
        n += h > 0 && sk[h] != sk[h - 1];
    int total;
    block_inclusive_scan<SumOp>(n, scratch, &total);
    if (threadIdx.x == 0) tilecnt[(size_t)w * tiles + tile] = total;
}

// Each row's flag counts made exclusive prefixes over its tiles; the row's
// distinct count is their total plus one.
__global__ void __launch_bounds__(SCAN_THREADS)
    rank_flag_offsets_kernel(Rows rw, int* __restrict__ tilecnt,
                             int* __restrict__ cout, int tiles) {
    __shared__ int scratch[32];
    const int w = blockIdx.x;
    if (rw.rmode[w] != SORT) return;
    int* c = tilecnt + (size_t)w * tiles;
    const int per = (tiles + SCAN_THREADS - 1) / SCAN_THREADS;
    const int i0 = min((int)threadIdx.x * per, tiles),
              i1 = min(i0 + per, tiles);
    int sum = 0;
    for (int i = i0; i < i1; ++i) sum += c[i];
    int total;
    int ex = block_exclusive_scan<SumOp>(sum, scratch, &total);
    for (int i = i0; i < i1; ++i) {
        const int x = c[i];
        c[i] = ex;
        ex += x;
    }
    if (threadIdx.x == 0) cout[w] = total + 1;
}

// Dense ranks of a (row, tile) by haplotype: warp w's SEG keys, 32 at a
// time (loads coalesced), flags ranked by ballots, the warps' counts on
// top of the tile's offset.
template <typename K, typename R>
__global__ void __launch_bounds__(THREADS)
    rank_dense_kernel(const K* __restrict__ keys,
                      const R* __restrict__ vals, size_t plane, Rows rw,
                      const int* __restrict__ tilecnt, R* __restrict__ Wout,
                      int H, int tiles) {
    __shared__ int tot[WARPS];
    const int w = blockIdx.x / tiles, tile = blockIdx.x - w * tiles;
    if (rw.rmode[w] != SORT) return;
    const int par = passes_below(row_vary(rw, w), 64) & 1;
    const K* sk = keys + par * plane + (size_t)w * H;
    const R* sv = vals + par * plane + (size_t)w * H;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const unsigned le = (2u << lane) - 1u;
    const int base = tile * TILE + warp * SEG;
    unsigned fb[ITEMS];
    int n = 0;
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
        const int h = base + i * 32 + lane;
        fb[i] = __ballot_sync(FULL, h < H && h > 0 && sk[h] != sk[h - 1]);
        n += __popc(fb[i]);
    }
    if (lane == 0) tot[warp] = n;
    __syncthreads();
    int r = tilecnt[(size_t)w * tiles + tile];
    for (int q = 0; q < warp; ++q) r += tot[q];
    R* out = Wout + (size_t)w * H;
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
        const int h = base + i * 32 + lane;
        if (h < H) out[sv[h]] = (R)(r + __popc(fb[i] & le));
        r += __popc(fb[i]);
    }
}

// The final level: r_{w+1}[h] = the position of h in the sorted row.
template <typename R>
__global__ void __launch_bounds__(THREADS)
    rank_position_kernel(const R* __restrict__ vals, size_t plane, Rows rw,
                         int64_t* __restrict__ r_starts,
                         int64_t* __restrict__ r_final, int n_ch, int H,
                         int tiles) {
    const int w = blockIdx.x / tiles, tile = blockIdx.x - w * tiles;
    if (rw.rmode[w] != SORT) return;
    const R* sv =
        vals + (passes_below(row_vary(rw, w), 64) & 1) * plane + (size_t)w * H;
    int64_t* out = final_row(r_starts, r_final, w, n_ch, H);
    const int h1 = min(tile * TILE + TILE, H);
    for (int h = tile * TILE + (int)threadIdx.x; h < h1; h += THREADS)
        out[sv[h]] = h;
}

// ---------------------------------------------------------------------
// Host side.

// The scratch both routes share (W, the distinct counts and the rows'
// modes, double buffered) and the device route's (keys, payloads, rows'
// OR / AND, counts);
// mirrors ops/pbwt_kernels.py rank_scratch_bytes.
struct Scratch {
    void* W[2];
    int* cnt[2];
    int* mode[2];
    void* keys;
    void* vals;
    Rows rw;
    int* counts;
    int* tilecnt;
    size_t bytes;

    Scratch(void* base, int n_ch, int H) {
        const bool dev = H > SMEM_H;
        const size_t rb = H <= 0xFFFF ? 2 : 4, kb = 2 * rb;
        const size_t nh = (size_t)n_ch * H;
        const int tiles = (H + TILE - 1) / TILE;
        char* p = static_cast<char*>(base);
        size_t off = 0;
        auto carve = [&](size_t n) {
            void* q = p + off;
            off += aligned(n);
            return q;
        };
        for (int i = 0; i < 2; ++i) W[i] = carve(nh * rb);
        for (int i = 0; i < 2; ++i) cnt[i] = (int*)carve(4 * (size_t)n_ch);
        for (int i = 0; i < 2; ++i) mode[i] = (int*)carve(4 * (size_t)n_ch);
        keys = vals = nullptr;
        rw = {nullptr, nullptr, nullptr};
        counts = tilecnt = nullptr;
        if (dev) {
            keys = carve(2 * nh * kb);
            vals = carve(2 * nh * rb);
            rw.rowor = (ull*)carve(8 * (size_t)n_ch);
            rw.rowand = (ull*)carve(8 * (size_t)n_ch);
            counts = (int*)carve(4 * (size_t)n_ch * RADIX * tiles);
            tilecnt = (int*)carve(4 * (size_t)n_ch * tiles);
        }
        bytes = off;
    }
};

int run_smem(const int32_t* T, const int64_t* r0, int64_t* r_starts,
             int64_t* r_final, Scratch& sc, int n_ch, int H,
             cudaStream_t st) {
    const size_t smem = smem_bytes(H);
    cudaError_t e = cudaFuncSetAttribute(
        rank_level_smem_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    uint16_t* W[2] = {(uint16_t*)sc.W[0], (uint16_t*)sc.W[1]};
    auto level = [&](int lv, int cur, int d) {
        rank_level_smem_kernel<<<n_ch, THREADS, smem, st>>>(
            lv, T, r0, W[cur], W[cur ^ 1], sc.cnt[cur], sc.cnt[cur ^ 1],
            sc.mode[cur], sc.mode[cur ^ 1], r_starts, r_final, n_ch, H, d);
        return (int)cudaGetLastError();
    };
    // level 0 writes buffer 0 (cur = 1: reads nothing)
    int rc = level(LEVEL0, 1, 0), cur = 0;
    for (int d = 1; rc == 0 && d < n_ch; d <<= 1, cur ^= 1)
        rc = level(PAIR, cur, d);
    return rc ? rc : level(FINAL, cur, 0);
}

template <typename K, typename R>
int run_device(const int32_t* T, const int64_t* r0, int64_t* r_starts,
               int64_t* r_final, Scratch& sc, int n_ch, int H,
               cudaStream_t st) {
    const int tiles = (H + TILE - 1) / TILE;
    const int grid = n_ch * tiles;
    const size_t plane = (size_t)n_ch * H;
    K* keys = (K*)sc.keys;
    R* vals = (R*)sc.vals;
    R* W[2] = {(R*)sc.W[0], (R*)sc.W[1]};
    // every digit a key can vary in: T's 31 bits, a pair's 2 * bits_for(H)
    const int kbits = 2 * bits_for(H) > 31 ? 2 * bits_for(H) : 31;
    const size_t scatter_smem = (size_t)TILE * (sizeof(K) + sizeof(R));
    cudaError_t e0 = cudaFuncSetAttribute(
        rank_scatter_kernel<K, R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)scatter_smem);
    if (e0 != cudaSuccess) return (int)e0;
    auto level = [&](int lv, int cur, int d) -> int {
        sc.rw.rmode = sc.mode[cur ^ 1];
        cudaError_t e = cudaMemsetAsync(sc.rw.rowor, 0, 8 * (size_t)n_ch, st);
        if (e == cudaSuccess)
            e = cudaMemsetAsync(sc.rw.rowand, 0xFF, 8 * (size_t)n_ch, st);
        if (e != cudaSuccess) return (int)e;
        rank_prep_kernel<K, R><<<grid, THREADS, 0, st>>>(
            lv, T, r0, W[cur], W[cur ^ 1], sc.cnt[cur], sc.cnt[cur ^ 1],
            sc.mode[cur], keys, vals, sc.rw, sc.counts, r_starts, r_final,
            n_ch, H, d, tiles);
        int rc = (int)cudaGetLastError();
        for (int s = 0; rc == 0 && s < kbits; s += DBITS) {
            if (s > 0) {
                rank_count_kernel<K><<<grid, THREADS, 0, st>>>(
                    s, keys, plane, sc.rw, sc.counts, H, tiles);
                if ((rc = (int)cudaGetLastError())) break;
            }
            rank_offsets_kernel<<<n_ch, SCAN_THREADS, 0, st>>>(
                s, sc.rw, sc.counts, tiles);
            if ((rc = (int)cudaGetLastError())) break;
            rank_scatter_kernel<K, R><<<grid, THREADS, scatter_smem, st>>>(
                s, keys, vals, plane, sc.rw, sc.counts, H, tiles);
            rc = (int)cudaGetLastError();
        }
        if (rc) return rc;
        if (lv == FINAL) {
            rank_position_kernel<R><<<grid, THREADS, 0, st>>>(
                vals, plane, sc.rw, r_starts, r_final, n_ch, H, tiles);
            return (int)cudaGetLastError();
        }
        rank_flags_kernel<K><<<grid, THREADS, 0, st>>>(keys, plane, sc.rw,
                                                       sc.tilecnt, H, tiles);
        if ((rc = (int)cudaGetLastError())) return rc;
        rank_flag_offsets_kernel<<<n_ch, SCAN_THREADS, 0, st>>>(
            sc.rw, sc.tilecnt, sc.cnt[cur ^ 1], tiles);
        if ((rc = (int)cudaGetLastError())) return rc;
        rank_dense_kernel<K, R><<<grid, THREADS, 0, st>>>(
            keys, vals, plane, sc.rw, sc.tilecnt, W[cur ^ 1], H, tiles);
        return (int)cudaGetLastError();
    };
    int rc = level(LEVEL0, 1, 0), cur = 0;
    for (int d = 1; rc == 0 && d < n_ch; d <<= 1, cur ^= 1)
        rc = level(PAIR, cur, d);
    return rc ? rc : level(FINAL, cur, 0);
}

}  // namespace

// The whole chain on `stream`: ceil(log2 n_ch) + 2 levels (one launch each
// up to SMEM_H haplotypes, a few a pass above).  scratch holds
// scratch_bytes >= rank_scratch_bytes (ops/pbwt_kernels.py) bytes.
extern "C" int xsi_rank_chain(const void* T, const void* r0, void* r_starts,
                              void* r_final, void* scratch,
                              size_t scratch_bytes, int n_ch, int H,
                              void* stream) {
    if (H < 1 || H > MAX_H || n_ch < 0) return (int)cudaErrorInvalidValue;
    const cudaStream_t st = (cudaStream_t)stream;
    const size_t row = (size_t)H * sizeof(int64_t);
    if (n_ch == 0)  // r_final = r_0
        return (int)cudaMemcpyAsync(r_final, r0, row,
                                    cudaMemcpyDeviceToDevice, st);
    Scratch sc(scratch, n_ch, H);
    if (sc.bytes > scratch_bytes) return (int)cudaErrorInvalidValue;
    cudaError_t e =
        cudaMemcpyAsync(r_starts, r0, row, cudaMemcpyDeviceToDevice, st);
    if (e != cudaSuccess) return (int)e;
    const int32_t* t = (const int32_t*)T;
    const int64_t* r = (const int64_t*)r0;
    int64_t* rs = (int64_t*)r_starts;
    int64_t* rf = (int64_t*)r_final;
    if (H <= SMEM_H) return run_smem(t, r, rs, rf, sc, n_ch, H, st);
    if (H <= 0xFFFF)
        return run_device<uint32_t, uint16_t>(t, r, rs, rf, sc, n_ch, H, st);
    return run_device<ull, uint32_t>(t, r, rs, rf, sc, n_ch, H, st);
}
