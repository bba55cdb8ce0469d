// PBWT device scans, each one launch stepping through a whole block on one
// CTA (the rank chain on a cluster at wide rows): the encode's
// chunk-start rank chain and the mixed-ploidy decode scan.
//
// RANK CHAIN replaces the XLA function xsqueezeit_tpu/ops/pbwt_jax.py
// _rank_chain (:213-282, a lax.scan over chunks inside the jitted
// pbwt_encode_chunked and pbwt_encode_keys).
//   What it computes.  T[t, h] < 2^31 is haplotype h's history total over
//   chunk t's sorting lines (bit k = the chunk's k-th sorting line, latest
//   highest); r_t[h] is h's rank at chunk t's start, r_0 = r0 (a
//   permutation of 0..H-1).  r_{t+1} = rank of each h by (T_t[h], r_t[h]).
//   Outputs r_starts[t] = r_t and r_final = r_{n_ch}.
//   Formulation.  Ranks are unique, so ranking by (T_t, r_t) is an LSD
//   radix sort over T_t's bits started from the order r_t.  Bits that are
//   equal on every haplotype leave the order as it is, so each chunk runs
//   only its varying bits (a block OR / AND of the chunk's row); a chunk
//   with no sorting line runs none.  The varying bits go two at a time as
//   one digit c in 0..3 (the lower bit the digit's low bit: a stable sort
//   by c is the two one-bit passes), and each pass works in rank space,
//   with no arrangement stored: every haplotype sets bit r of its digit's
//   bitmask over the ranks, one block scan of the mask words' popcounts
//   (the four digits' counts packed in one u64, 16 bits each: each total
//   is <= H <= 65,535) gives every word's prefix per digit, and
//       r <- start[c] + (ranks below r with digit c),
//   the second term being the word's prefix plus one masked popcount.
//   Bound: the bytes of T (read once) and of r_starts (written once); what
//   holds it far above that is the sequential floor, one block-wide pass
//   (mark, scan, update: five barriers on one CTA, two of them cluster
//   barriers on a cluster) per two sorting lines of the block, and the
//   shared-memory traffic of the passes (per haplotype and pass one atomic
//   OR and one 8-byte load).
//   Layout: up to H = 16,384 one CTA of 1024 threads; above, a cluster of
//   K = ceil(H / 8192) <= 8 CTAs (the wrapper's rank_route picks K; one
//   CTA at HRC width held 64 ranks a thread, spilled them and ran slower
//   than 8 CTAs: PERF.md).  CTA q owns haplotypes [q * hc, q * hc + hc),
//   hc = ceil(H / K) <= 16,384 on one CTA and <= 8192 on a cluster;
//   thread tid owns local haplotypes tid + j * 1024 for j < E (E = 4, 8 or
//   16 on one CTA, 8 on a cluster: a template parameter) and keeps their
//   ranks in registers, two u16 to a register.  Every CTA holds, per digit, a
//   mask word for every 32 ranks with a prefix beside it in one u64 (the
//   update reads both with one load), double buffered (a pass clears the
//   other buffer while it scans, so no barrier is spent clearing): 64 B
//   per 32 ranks, 128 KB at H = 65,535.  A pass on a cluster: each CTA
//   marks its haplotypes' ranks in its own masks (local atomics, where
//   remote ones through distributed shared memory would contend); cluster
//   barrier; CTA q ORs the K CTAs' masks of its share of the words (rank
//   range) and scans them, publishing its digit totals to every CTA;
//   cluster barrier; every CTA copies the other shares' words, their
//   prefixes rebased, and updates its ranks from its own copy (reading
//   each rank's word from its owner instead ran slower: the copy's loads
//   are coalesced, those are not).  At a
//   chunk's start each CTA reads its part of T's row twice (its OR / AND,
//   exchanged over the cluster, then one warp ballot per varying bit) into
//   bit planes in shared memory, one word per 32 haplotypes and bit; in a
//   pass each lane loads one plane word per 32 of its haplotypes and the
//   warp shares them by shuffles.
//
// MIXED DECODE SCAN replaces the XLA function pbwt_jax.py
// pbwt_decode_scan_mixed (:563-604, a lax.scan over the WAH lines of a
// mixed-ploidy block, called at codec/decoder_jax.py:150).
//   What it computes, per line l (block start a = identity):
//     a haploid line stores only its N even-parity bits, front-packed; the
//     slot-duplicated line is y[i] = stored[e[a[i] >> 1]], where e[s] is
//     the number of even-parity positions before the position that holds
//     haplotype 2s; a diploid line is y = stored.  Then vals[l][a[i]] =
//     y[i], and a sorting line stably partitions a by y.
//   Outputs vals u8[Lw, H] and a_final int64[H].
//   Bound: the bytes of the stored lines read once (a haploid line's
//   ceil(H / 2), a diploid line's H) and of vals written once; what
//   holds it above that is one pass over the row per line, with two
//   rankings (the even ranks and the partition) and their barriers.
//   Layout: one CTA (its threads follow from H) over the Lw lines
//   in order; the sort and haploid flags are read on the device.  Warp w
//   owns a contiguous segment of positions and walks it 32 at a time,
//   lanes on consecutive positions: a ballot ranks the 32, a running count
//   carries the segment, and one barrier publishes the warps' totals,
//   which every warp sums itself (no block scan).  The arrangement, its
//   double buffer, e, the staged line, y and the line in natural order
//   live in shared memory while they fit (13 B per haplotype: H <= 17,801;
//   the chrX PAR block is 2466), else in a device-memory scratch the
//   wrapper allocates (any H), vals then being written in place.
#include <cooperative_groups.h>
#include <stdint.h>

#include "scan.cuh"

namespace cg = cooperative_groups;

constexpr int MAX_THREADS = 1024;
// Threads of a rank-chain CTA: a pass's floor is its barriers, which more
// threads do not lengthen, and more threads hold fewer ranks each.
constexpr int RANK_THREADS = MAX_THREADS;
// Positions per thread the mixed scan aims at (its thread count, a multiple
// of 32 in [64, 1024], follows from H: 512 at the chrX PAR block's 2466).
constexpr int MIXED_PER_THREAD = 5;
constexpr int MAX_RANK_H = 65535;  // the ranks are held as u16
constexpr int MAX_CLUSTER = 8;     // the portable cluster size
constexpr int PLANES = 32;         // bit planes: one per bit of T
constexpr int DIGITS = 4;          // two bits of T per pass
constexpr unsigned FULL = 0xffffffffu;
// Dynamic shared memory one CTA may use, less what the static arrays take.
constexpr int DYN_SMEM_LIMIT = 227 * 1024 - 1024;
// Returned when no cluster of the requested shape fits on the device (the
// code csrc/pbwt_chain.cu's xsi_cuda_error_string names).
constexpr int XSI_ERR_NO_CLUSTER = 100001;

__host__ __device__ inline int mask_words(int H) { return (H + 31) >> 5; }

// The rank chain's split over K CTAs: each owns `hc` haplotypes (the last
// the rest; their plane words `lw`) and the mask words of `sw` * 32
// consecutive ranks.
struct RankSplit {
    int hc, lw, sw;
    __host__ __device__ RankSplit(int H, int K)
        : hc((H + K - 1) / K),
          lw(mask_words((H + K - 1) / K)),
          sw((mask_words(H) + K - 1) / K) {}
};

// Dynamic shared memory of a rank-chain CTA: the double-buffered digit
// words of every rank (u64: mask | prefix << 32) and the bit planes of its
// haplotypes (mirrors ops/pbwt_kernels.py rank_smem_bytes).
static size_t rank_smem_bytes(int H, int K) {
    return 2 * DIGITS * 8 * (size_t)mask_words(H) +
           4 * (size_t)PLANES * RankSplit(H, K).lw;
}

// Sum of the first `w` of the `n` warps' published counts `tot`, and of
// all of them.
__device__ __forceinline__ void warp_prefix(const int* tot, int w, int n,
                                            int* before, int* total) {
    int b = 0, t = 0;
    for (int i = 0; i < n; ++i) {
        const int c = tot[i];
        if (i < w) b += c;
        t += c;
    }
    *before = b;
    *total = t;
}

// Rank j of a thread's E, two u16 to a register (j a constant after
// unrolling, so the array stays in registers).
template <int E>
__device__ __forceinline__ int get_rank(const uint32_t (&rp)[E / 2], int j) {
    return (rp[j >> 1] >> ((j & 1) * 16)) & 0xFFFF;
}

template <int E>
__device__ __forceinline__ void set_rank(uint32_t (&rp)[E / 2], int j,
                                         int r) {
    const int sh = (j & 1) * 16;
    rp[j >> 1] = (rp[j >> 1] & ~(0xFFFFu << sh)) | ((uint32_t)r << sh);
}

// The bits of plane k at this thread's E haplotypes, bit j = local
// haplotype tid + j * threads: lane l loads the plane word of local
// haplotypes [32 (warp + (l + 32 i) * warps), + 32) and the warp shuffles
// them.
template <int E>
__device__ __forceinline__ uint64_t plane_bits(const uint32_t* plane, int LW,
                                               int warp, int nwarps,
                                               int lane) {
    constexpr int R = (E + 31) / 32;
    uint32_t word[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
        const int j = lane + 32 * i;
        const int w = warp + j * nwarps;
        word[i] = (j < E && w < LW) ? plane[w] : 0u;
    }
    uint64_t bits = 0;
#pragma unroll
    for (int j = 0; j < E; ++j) {
        const uint32_t x = __shfl_sync(FULL, word[j >> 5], j & 31);
        bits |= (uint64_t)((x >> lane) & 1u) << j;
    }
    return bits;
}

// Field c (16 bits) of four packed digit counts.
__device__ __forceinline__ int field(unsigned long long x, int c) {
    return (int)((x >> (16 * c)) & 0xFFFF);
}

// A barrier over the CTA, or over the cluster (with release / acquire of
// shared memory across its CTAs) when CL.
template <bool CL>
__device__ __forceinline__ void chain_sync() {
    if (CL)
        cg::this_cluster().sync();
    else
        __syncthreads();
}

// Address of `p` (this CTA's shared memory) in CTA `rank` of the cluster.
template <bool CL, typename U>
__device__ __forceinline__ U* in_cta(U* p, int rank) {
    if (CL) return cg::this_cluster().map_shared_rank(p, rank);
    return p;
}

template <int E, bool CL>
__global__ void __launch_bounds__(MAX_THREADS, 1)
    rank_chain_kernel(const int32_t* __restrict__ T,
                      const int64_t* __restrict__ r0,
                      int64_t* __restrict__ r_starts,
                      int64_t* __restrict__ r_final, int n_ch, int H) {
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ unsigned long long scan_scratch[32];
    __shared__ uint32_t red_or[32], red_and[32];
    __shared__ uint32_t cred[2][2][MAX_CLUSTER];  // [chunk & 1][or|and][CTA]
    __shared__ unsigned long long ctot[MAX_CLUSTER];  // digit counts by CTA
    __shared__ unsigned long long cbase[MAX_CLUSTER + 1];
    const int K = CL ? (int)cg::this_cluster().num_blocks() : 1;
    const int crank = CL ? (int)cg::this_cluster().block_rank() : 0;
    const RankSplit sp(H, K);
    const int NW = mask_words(H);
    const int hbase = crank * sp.hc;
    const int nloc = max(0, min(sp.hc, H - hbase));  // my haplotypes
    const int o0 = min(crank * sp.sw, NW);           // my mask words
    const int o1 = min(o0 + sp.sw, NW);
    // [2][DIGITS][NW]: mask word in the low half, a prefix in the high
    unsigned long long* dig = reinterpret_cast<unsigned long long*>(smem);
    uint32_t* planes = reinterpret_cast<uint32_t*>(dig + 2 * DIGITS * NW);
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int warp = tid >> 5;
    const int nthr = blockDim.x;
    const int nwarps = nthr >> 5;
    // my mask words of this thread in the scan: contiguous
    const int wpt = (o1 - o0 + nthr - 1) / nthr;
    const int w0 = min(o0 + tid * wpt, o1), w1 = min(w0 + wpt, o1);

    uint32_t rp[E / 2] = {};
#pragma unroll
    for (int j = 0; j < E; ++j) {
        const int i = tid + j * nthr;
        set_rank<E>(rp, j, i < nloc ? (int)r0[hbase + i] : 0);
    }
    for (int w = tid; w < 2 * DIGITS * NW; w += nthr) dig[w] = 0;
    chain_sync<CL>();
    int cur = 0;  // the digit buffer of the next pass
    for (int t = 0; t < n_ch; ++t) {
        const int32_t* Tt = T + (size_t)t * H + hbase;
        int64_t* rs = r_starts + (size_t)t * H + hbase;
        uint32_t o = 0, a = FULL;
#pragma unroll
        for (int j = 0; j < E; ++j) {
            const int i = tid + j * nthr;
            if (i < nloc) {
                rs[i] = get_rank<E>(rp, j);
                const uint32_t v = (uint32_t)__ldg(Tt + i);
                o |= v;
                a &= v;
            }
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
        for (int i = 0; i < nwarps; ++i) {
            o |= red_or[i];
            a &= red_and[i];
        }
        if (CL) {  // the cluster's OR / AND: every CTA's, to every CTA
            if (tid < K) {
                uint32_t* dst = in_cta<CL>(&cred[t & 1][0][0], tid);
                dst[crank] = o;
                dst[MAX_CLUSTER + crank] = a;
            }
            chain_sync<CL>();
            o = 0;
            a = FULL;
            for (int c = 0; c < K; ++c) {
                o |= cred[t & 1][0][c];
                a &= cred[t & 1][1][c];
            }
        }
        uint32_t vary = o & ~a;  // the bits that move someone
        // the planes of the varying bits (a warp holds 32 consecutive
        // local haplotypes)
        if (vary)
            for (int j = 0; j < E; ++j) {
                const int i = tid + j * nthr;
                if (i - lane >= nloc) break;  // the same for the whole warp
                const uint32_t v = i < nloc ? (uint32_t)__ldg(Tt + i) : 0u;
                for (uint32_t bits = vary; bits; bits &= bits - 1) {
                    const int k = __ffs(bits) - 1;
                    const uint32_t word = __ballot_sync(FULL, (v >> k) & 1u);
                    if (lane == 0) planes[k * sp.lw + (i >> 5)] = word;
                }
            }
        __syncthreads();  // planes complete; red_* free for the next chunk
        while (vary) {
            const int k1 = __ffs(vary) - 1;
            vary &= vary - 1;
            uint64_t hi = 0;
            if (vary) {
                const int k2 = __ffs(vary) - 1;
                vary &= vary - 1;
                hi = plane_bits<E>(planes + k2 * sp.lw, sp.lw, warp, nwarps,
                                   lane);
            }
            const uint64_t lo =
                plane_bits<E>(planes + k1 * sp.lw, sp.lw, warp, nwarps, lane);
            unsigned long long* d = dig + cur * DIGITS * NW;
            // 1. mark my haplotypes' ranks in their digits' masks
#pragma unroll
            for (int j = 0; j < E; ++j) {
                if (tid + j * nthr < nloc) {
                    const int c = (int)((lo >> j) & 1) | (int)((hi >> j) & 1)
                                                             << 1;
                    const int r = get_rank<E>(rp, j);
                    atomicOr(reinterpret_cast<unsigned*>(d + c * NW +
                                                         (r >> 5)),
                             1u << (r & 31));
                }
            }
            chain_sync<CL>();
            // 2. my words: every CTA's marks ORed together (one word and
            //    digit a thread, all loads in flight), then their prefixes
            //    per digit; the other buffer (last read in the previous
            //    pass) is cleared meanwhile
            unsigned long long* other = dig + (cur ^ 1) * DIGITS * NW;
            for (int w = tid; w < DIGITS * NW; w += nthr) other[w] = 0;
            if (CL) {
                const int n = o1 - o0;
                for (int x = tid; x < DIGITS * n; x += nthr) {
                    const int c = x / n;
                    const int w = c * NW + o0 + x - c * n;
                    unsigned v[MAX_CLUSTER];
#pragma unroll
                    for (int q = 0; q < MAX_CLUSTER; ++q)
                        v[q] = q < K && q != crank
                                   ? (unsigned)in_cta<CL>(d, q)[w]
                                   : 0u;
                    unsigned m = (unsigned)d[w];
#pragma unroll
                    for (int q = 0; q < MAX_CLUSTER; ++q) m |= v[q];
                    d[w] = m;
                }
                __syncthreads();
            }
            unsigned long long cnt = 0;  // four 16-bit fields (<= H each)
            for (int w = w0; w < w1; ++w) {
#pragma unroll
                for (int c = 0; c < DIGITS; ++c)
                    cnt += (unsigned long long)__popc((unsigned)d[c * NW + w])
                           << (16 * c);
            }
            unsigned long long total;
            unsigned long long ex =
                block_exclusive_scan<SumU64Op>(cnt, scan_scratch, &total);
            for (int w = w0; w < w1; ++w) {
#pragma unroll
                for (int c = 0; c < DIGITS; ++c) {
                    const unsigned long long m = d[c * NW + w];
                    d[c * NW + w] = m | (unsigned long long)field(ex, c)
                                            << 32;
                    ex += (unsigned long long)__popc((unsigned)m) << (16 * c);
                }
            }
            if (CL && tid < K) in_cta<CL>(ctot, tid)[crank] = total;
            chain_sync<CL>();
            // 3. the ranks before each CTA's words, per digit
            if (CL) {
                if (tid == 0) {
                    unsigned long long run = 0;
                    for (int q = 0; q < K; ++q) {
                        cbase[q] = run;
                        run += ctot[q];
                    }
                    cbase[K] = run;
                }
                __syncthreads();
            }
            // 4. the other CTAs' words, their prefixes made relative to
            //    my words' base (mine stay as they are: the others read
            //    them now); every owner's words at once, U loads in flight
            //    a thread (one round at HRC width)
            if (CL) {
                constexpr int U = 8;
                for (int x0 = tid; x0 < DIGITS * NW; x0 += U * nthr) {
                    unsigned long long y[U];
#pragma unroll
                    for (int u = 0; u < U; ++u) {
                        const int x = x0 + u * nthr;
                        const int q = x < DIGITS * NW ? (x % NW) / sp.sw
                                                      : crank;
                        y[u] = q != crank ? in_cta<CL>(d, q)[x] : 0ull;
                    }
#pragma unroll
                    for (int u = 0; u < U; ++u) {
                        const int x = x0 + u * nthr;
                        if (x >= DIGITS * NW) break;
                        const int q = (x % NW) / sp.sw;
                        if (q == crank) continue;
                        const int c = x / NW;
                        const int rel = (int)(y[u] >> 32) +
                                        field(cbase[q], c) -
                                        field(cbase[crank], c);
                        d[x] = (y[u] & 0xFFFFFFFFull) |
                               (unsigned long long)(unsigned)rel << 32;
                    }
                }
                __syncthreads();
            }
            // 5. the new ranks, from my copy of every word
            const unsigned long long all = CL ? cbase[K] : total;
            const int n0 = field(all, 0), n1 = field(all, 1);
            const int start[DIGITS] = {0, n0, n0 + n1,
                                       n0 + n1 + field(all, 2)};
            int mine[DIGITS];
#pragma unroll
            for (int c = 0; c < DIGITS; ++c)
                mine[c] = start[c] + (CL ? field(cbase[crank], c) : 0);
#pragma unroll
            for (int j = 0; j < E; ++j) {
                if (tid + j * nthr < nloc) {
                    const int c = (int)((lo >> j) & 1) | (int)((hi >> j) & 1)
                                                             << 1;
                    const int r = get_rank<E>(rp, j);
                    const unsigned long long x = d[c * NW + (r >> 5)];
                    const int before =
                        (int)(x >> 32) +
                        __popc((unsigned)x & ((1u << (r & 31)) - 1u));
                    set_rank<E>(rp, j, mine[c] + before);
                }
            }
            cur ^= 1;
        }
    }
#pragma unroll
    for (int j = 0; j < E; ++j) {
        const int i = tid + j * nthr;
        if (i < nloc) r_final[hbase + i] = get_rank<E>(rp, j);
    }
    // no CTA may leave while another still reads its shared memory
    chain_sync<CL>();
}

// Bytes of the mixed scan's state per the layout above; the shared route
// holds all of it, the device-memory route's scratch the int32 arrays and
// y (mirrors ops/pbwt_kernels.py mixed_smem_bytes / mixed_scratch_bytes).
static size_t mixed_smem_bytes(int H) {
    return 4 * (2 * (size_t)H + (size_t)(H + 1) / 2) + 3 * (size_t)H;
}

template <bool SH>
__global__ void __launch_bounds__(MAX_THREADS)
    decode_scan_mixed_kernel(const uint8_t* __restrict__ ys,
                             const uint8_t* __restrict__ sorts,
                             const uint8_t* __restrict__ hap,
                             uint8_t* __restrict__ vals,
                             int64_t* __restrict__ a_final,
                             int32_t* __restrict__ gscratch, int Lw, int H) {
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ int tot_even[32], tot_ones[32];
    const int NS = (H + 1) >> 1;
    int32_t* base = SH ? reinterpret_cast<int32_t*>(smem) : gscratch;
    int32_t* a = base;          // [H] haplotype at each position
    int32_t* b = base + H;      // [H] the next arrangement
    int32_t* e = base + 2 * H;  // [NS] even rank of each sample
    uint8_t* y = reinterpret_cast<uint8_t*>(e + NS);  // [H] the line's bits
    uint8_t* row = y + H;       // [H] the stored line (shared route)
    uint8_t* nat = row + H;     // [H] the line in natural order (shared)
    const int tid = threadIdx.x;
    const int lane = tid & 31;
    const int w = tid >> 5;
    const int nthr = blockDim.x;
    const int nwarps = nthr >> 5;
    const unsigned lt = (1u << lane) - 1u;
    // this warp's segment [s0, s1), whole groups of 32 positions
    const int seg = ((H + nwarps - 1) / nwarps + 31) & ~31;
    const int s0 = min(w * seg, H), s1 = min(s0 + seg, H);

    for (int i = tid; i < H; i += nthr) a[i] = i;
    __syncthreads();
    for (int l = 0; l < Lw; ++l) {
        const uint8_t* src = ys + (size_t)l * H;
        uint8_t* out = vals + (size_t)l * H;
        const bool hp = hap[l] != 0;
        const bool srt = sorts[l] != 0;
        if (SH) {
            for (int i = tid; i < H; i += nthr) row[i] = src[i];
            src = row;
        }
        if (hp) {  // e[a[p] >> 1] = even-parity positions before p
            int cnt = 0;
            for (int g = s0; g < s1; g += 32) {
                const int p = g + lane;
                cnt += __popc(__ballot_sync(FULL, p < s1 && !(a[p] & 1)));
            }
            if (lane == 0) tot_even[w] = cnt;
        }
        __syncthreads();  // the staged line and the even totals
        if (hp) {
            int before, total;
            warp_prefix(tot_even, w, nwarps, &before, &total);
            for (int g = s0; g < s1; g += 32) {
                const int p = g + lane;
                const int v = p < s1 ? a[p] : 1;
                const unsigned ev = __ballot_sync(FULL, !(v & 1));
                if (!(v & 1)) e[v >> 1] = before + __popc(ev & lt);
                before += __popc(ev);
            }
            __syncthreads();  // e complete
        }
        int ones = 0;
        for (int g = s0; g < s1; g += 32) {
            const int p = g + lane;
            uint8_t bit = 0;
            if (p < s1) {
                const int v = a[p];
                bit = src[hp ? e[v >> 1] : p];
                y[p] = bit;
                if (SH)
                    nat[v] = bit;
                else
                    out[v] = bit;
            }
            ones += __popc(__ballot_sync(FULL, bit != 0));
        }
        if (srt) {  // stable partition of a by y: zeros first, in order
            if (lane == 0) tot_ones[w] = ones;
            __syncthreads();
            int ob, total;
            warp_prefix(tot_ones, w, nwarps, &ob, &total);
            int zb = s0 - ob;
            ob += H - total;
            for (int g = s0; g < s1; g += 32) {
                const int p = g + lane;
                const bool valid = p < s1;
                const bool one = valid && y[p] != 0;
                const unsigned b1 = __ballot_sync(FULL, one);
                const unsigned b0 = __ballot_sync(FULL, valid && !one);
                if (one)
                    b[ob + __popc(b1 & lt)] = a[p];
                else if (valid)
                    b[zb + __popc(b0 & lt)] = a[p];
                ob += __popc(b1);
                zb += __popc(b0);
            }
        }
        __syncthreads();  // b and nat complete; a, e and the totals read
        if (srt) {
            int32_t* s = a;
            a = b;
            b = s;
        }
        if (SH)
            for (int i = tid; i < H; i += nthr) out[i] = nat[i];
    }
    for (int i = tid; i < H; i += nthr) a_final[i] = a[i];
}

template <int E, bool CL>
static int launch_rank_chain(const void* T, const void* r0, void* r_starts,
                             void* r_final, int n_ch, int H, int K,
                             cudaStream_t stream) {
    const size_t smem = rank_smem_bytes(H, K);
    if (smem > (size_t)DYN_SMEM_LIMIT) return (int)cudaErrorInvalidValue;
    auto kernel = rank_chain_kernel<E, CL>;
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = K;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)K);
    cfg.blockDim = dim3((unsigned)RANK_THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cfg.attrs = CL ? attr : nullptr;
    cfg.numAttrs = CL ? 1 : 0;
    if (CL) {
        int n_clusters = 0;
        e = cudaOccupancyMaxActiveClusters(&n_clusters, kernel, &cfg);
        if (e != cudaSuccess) return (int)e;
        if (n_clusters < 1) return XSI_ERR_NO_CLUSTER;
    }
    e = cudaLaunchKernelEx(&cfg, kernel, (const int32_t*)T,
                           (const int64_t*)r0, (int64_t*)r_starts,
                           (int64_t*)r_final, n_ch, H);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}

// One CTA (K = 1, H <= 16,384) or a cluster of K <= 8 CTAs of at most 8192
// haplotypes each (the wrapper's rank_route).  Each thread owns
// ceil(ceil(H / K) / 1024) haplotypes, rounded up to 4, 8 or 16 on one CTA
// and to 8 on a cluster.
extern "C" int xsi_rank_chain(const void* T, const void* r0, void* r_starts,
                              void* r_final, int n_ch, int H, int K,
                              void* stream) {
    if (H < 1 || H > MAX_RANK_H || n_ch < 0 || K < 1 || K > MAX_CLUSTER)
        return (int)cudaErrorInvalidValue;
    const cudaStream_t st = (cudaStream_t)stream;
    const int need = (RankSplit(H, K).hc + RANK_THREADS - 1) / RANK_THREADS;
    if (K > 1)
        return need <= 8 ? launch_rank_chain<8, true>(T, r0, r_starts,
                                                      r_final, n_ch, H, K, st)
                         : (int)cudaErrorInvalidValue;
    if (need <= 4)
        return launch_rank_chain<4, false>(T, r0, r_starts, r_final, n_ch, H,
                                           K, st);
    if (need <= 8)
        return launch_rank_chain<8, false>(T, r0, r_starts, r_final, n_ch, H,
                                           K, st);
    if (need <= 16)
        return launch_rank_chain<16, false>(T, r0, r_starts, r_final, n_ch,
                                            H, K, st);
    return (int)cudaErrorInvalidValue;
}

// scratch: null for the shared-memory route, else a device buffer of
// mixed_scratch_bytes(H) for the device-memory route.
extern "C" int xsi_decode_scan_mixed(const void* ys, const void* sorts,
                                     const void* hap, void* vals,
                                     void* a_final, void* scratch, int Lw,
                                     int H, void* stream) {
    if (H < 1 || Lw < 0) return (int)cudaErrorInvalidValue;
    const size_t smem = scratch == nullptr ? mixed_smem_bytes(H) : 0;
    if (smem > (size_t)DYN_SMEM_LIMIT) return (int)cudaErrorInvalidValue;
    auto kernel = scratch == nullptr ? decode_scan_mixed_kernel<true>
                                     : decode_scan_mixed_kernel<false>;
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    const int want = (H + MIXED_PER_THREAD - 1) / MIXED_PER_THREAD;
    int threads = (want + 31) / 32 * 32;
    threads = threads < 64 ? 64 : threads > MAX_THREADS ? MAX_THREADS
                                                        : threads;
    kernel<<<1, threads, smem, (cudaStream_t)stream>>>(
        (const uint8_t*)ys, (const uint8_t*)sorts, (const uint8_t*)hap,
        (uint8_t*)vals, (int64_t*)a_final, (int32_t*)scratch, Lw, H);
    return (int)cudaGetLastError();
}
