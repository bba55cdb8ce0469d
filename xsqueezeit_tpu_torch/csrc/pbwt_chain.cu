// PBWT chunk chains: encode and decode, one CTA or one thread-block
// cluster per chunk of C <= 16 lines.
//
// Replaces xsqueezeit_tpu/ops/pbwt_pallas.py _chain_encode_kernel (:133-170)
// and _chain_decode_kernel (:76-130), and above 65,535 haplotypes, with the
// rank chain and the run flush, the XLA programs the JAX package runs there:
// pbwt_jax.py pbwt_encode_scan (:48) and pbwt_decode_blocked (:456).
//
// What they compute.  A chunk's state is one value per haplotype slot in
// arrangement order.  For each line j of the chunk the bit of line j is read
// at every slot; if the line sorts, the slots are stably partitioned by that
// bit (zeros keep their order at the front, ones follow in order).
//   encode: the state is each haplotype's 16-bit register of the chunk's
//           bits (bit j = line j); line j's output is bit j of every slot.
//           With the parity payload (PAR, the mixed-ploidy encode) a chunk
//           holds C <= 15 lines and bit 15 holds the haplotype's slot
//           parity h & 1, which rides through every partition with its
//           register (no line sorts on it); each output byte is then
//           bit j | (bit 15 << 1): the line's bit and the parity of the
//           haplotype at that slot, in place of pbwt_jax.py
//           pbwt_encode_scan_parity (:80).
//   decode: the state is (chunk-start slot << sh) | beta; line j's input bit
//           is ORed into beta at bit j before the partition, so it travels
//           with its haplotype.  The final state is the kernel's output.
//           sh = 16 up to 65,536 slots (the narrow form); above that the
//           wrapper makes the chunks C = 32 - ceil(log2 H) lines long and
//           sh = C, so the slot's bits and beta share the 32 bits (14 lines
//           at TOPMed's 194,512 haplotypes, 13 at the format's 491,505);
//           the state's top bit may then be set: it is unsigned throughout.
//
// What bounds them on this card.  The chain is sequential over the C lines
// of a chunk and every partition is a permutation of the whole row, so the
// row stays in shared memory for the whole chain, double buffered: 2 x 2 B
// per haplotype for encode, 2 x 4 B for decode.  Device memory sees the
// chunk's input once and its output once (the bound is those bytes over the
// memory rate); what holds the kernels far above it is the latency of the
// 16 dependent lines, each a pass over the row, a scan and a scatter with
// barriers between them, and the shared-memory traffic of those passes.
//
// Design.  Ownership is by warp tiles: lane l of a warp owns one 16-byte
// group of the row (8 u16 registers or 4 u32 states), and a warp's 32
// groups make a tile of 512 bytes.  Tile t belongs to warp t % 16, so a
// thread owns the same groups in every pass.  One sorting line costs:
//   1. the count pass: each lane reads its group with one 128-bit load (no
//      bank conflict), decode ORs line j's 4 input bytes into it and stores
//      it back, encode emits its 8 output bytes with one 8-byte store; the
//      lane's ones are summed and reduced over the warp into the tile's
//      count.  A line that does not sort stops here, with no barrier.
//   2. one barrier; every warp then scans the tile counts itself (8 loads
//      and a warp scan per lane), which replaces a block scan and its two
//      barriers.
//   3. the scatter: a warp reads its tile striped (element i*32 + lane at
//      step i, consecutive lanes on consecutive slots), ranks the step's
//      bits with __ballot_sync/__popc, and the tile's zeros land in one
//      contiguous run of the next buffer, its ones in another, so the
//      stores of a step hit consecutive slots (no bank conflict).
//   4. one barrier (the buffer is complete), then the buffers swap.
// The row is padded to whole tiles with pad elements whose every bit is 1:
// they sort as ones behind every real one, so they stay at the tail and the
// first H slots are the real row (only those are emitted, so a pad's bit
// 15 never reads as a parity).
//
// Routes, chosen by the wrapper (ops/pbwt_kernels.py) from H:
//
// One CTA per chunk (xsi_chain_encode / xsi_chain_decode, and
// xsi_chain_encode_parity) while the double-buffered row fits the 227 KB
// one CTA may use: H <= 57,856 (encode) or 28,928 (decode), 226 tiles.  The
// runs are written straight into the next buffer.
//
// The encode on a cluster of K <= 16 CTAs per chunk
// (xsi_chain_encode_cluster, xsi_chain_encode_parity_cluster) above that:
// 8 up to 428,032 haplotypes, 16
// above (a non-portable cluster size, checked with
// cudaOccupancyMaxActiveClusters before the launch), up to the format's
// 491,505.  Global slots, run offsets and counters are ints (< 2^19 at
// 491,505).  CTA r owns the global
// slots [r*S, r*S + S), S = ceil(H / K) rounded up to whole tiles.  A warp
// first stages its two runs in its own shared memory, shifted so that a
// staged index and its destination slot agree modulo 16 bytes; then each
// lane stores whole 16-byte chunks of a run into the owning CTA's next
// buffer through distributed shared memory (element stores only at a run's
// two ragged ends).  A run is at most one tile and S is whole tiles, so it
// spans at most two owners: the owner is computed once per run.
// Barriers: one cluster barrier per sorting line.  Placing CTA r's slots
// needs the ones count of the line before slot r*S and in all.  The bits
// live only in the registers, so while the runs of line j are stored, each
// warp also counts the next sorting line's bits per destination CTA and
// adds them to that CTA's counter with one warp-aggregated atomic per run
// through distributed shared memory; the barrier that ends line j then also
// completes every count the next sorting line needs.  The counters rotate
// over three slots: one is read by line j, one is filled during line j, and
// the CTA clears the third, which every CTA finished reading before the
// previous barrier.  The first sorting line of a chunk takes one extra
// barrier for its counts.
//
// The decode on a cluster of K <= 16 CTAs per chunk (xsi_chain_decode_rows)
// above one CTA's bound, up to the format's 491,505, with both rows in
// device memory (a scratch of 2 K S states a chunk; 16 CTAs by default).
// CTA r owns the slots [r S, r S + S) of the current row, as the encode's
// CTAs do.  The decode's bit of line j at slot g is the input byte yc[j][g]
// in the arrangement line j partitions, so all C lines' counts are known
// before the chain starts: each CTA counts every line in its own slots, one
// cluster barrier at the chunk's start publishes them, and no count crosses
// between CTAs after that.  The scatter stores every element straight at
// its global slot of the next row, as the one-CTA route does in shared
// memory, and the cluster barrier that ends the line orders those stores
// before any CTA reads them.  It moves each line's row through device
// memory (or L2) three times; at HRC and TOPMed widths it ran faster than
// the same chain with its rows in the cluster's shared memory, which this
// route replaced (PERF.md has the times).
#include <cooperative_groups.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

constexpr int CHAIN_THREADS = 512;
constexpr int CHAIN_WARPS = CHAIN_THREADS / 32;
constexpr int PORTABLE_CLUSTER = 8;
constexpr int MAX_CLUSTER = 16;  // non-portable above 8 (an H100 takes 16)
constexpr int LANE_BYTES = 16;
constexpr int TILE_BYTES = 32 * LANE_BYTES;
// Shared memory one CTA may use on an H100, and what is left of it for the
// double-buffered row once the static arrays are placed (912 B on the
// one-CTA route; the cluster route's rows are far below the limit).
constexpr int SMEM_LIMIT = 227 * 1024;
constexpr int STATIC_RESERVE = 1024;
constexpr int MAX_TILES = (SMEM_LIMIT - STATIC_RESERVE) / (2 * TILE_BYTES);
// Tiles a CTA owns on the decode's cluster route, rows in device memory
// (65,536 slots).
constexpr int MAX_TILES_ROWS = 512;
// Returned when no cluster of the requested shape fits on the device.
constexpr int XSI_ERR_NO_CLUSTER = 100001;

template <bool DEC>
struct Chain {
    using T = typename std::conditional<DEC, uint32_t, uint16_t>::type;
    static constexpr int VEC = LANE_BYTES / sizeof(T);  // elements per lane
    static constexpr int TILE = 32 * VEC;               // elements per tile
    // staging of one warp (the encode's cluster route): two runs, each
    // shifted by < VEC
    static constexpr int STAGE = 2 * (TILE + VEC);
};

template <typename T>
union Group {
    uint4 u;
    T v[LANE_BYTES / sizeof(T)];
};

// Line j's input bits (0 or 1 per byte) at the 4 slots [g, g + 4) of a
// decode row; 0 past H.
__device__ __forceinline__ uint32_t load_bits4(const uint8_t* row, int g,
                                               int H) {
    if ((H & 3) == 0 && g + 4 <= H)
        return *reinterpret_cast<const uint32_t*>(row + g) & 0x01010101u;
    uint32_t b = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i)
        if (g + i < H) b |= (uint32_t)(row[g + i] & 1) << (8 * i);
    return b;
}

// Load the chunk's starting row into this CTA's slots, pads past H; a
// decode state starts as (slot << sh).
template <bool DEC>
__device__ __forceinline__ void load_row(typename Chain<DEC>::T* cur,
                                         const void* in, long ch, int H,
                                         int base, int S, int sh) {
    using T = typename Chain<DEC>::T;
    constexpr int VEC = Chain<DEC>::VEC;
    for (int gi = threadIdx.x; gi < S / VEC; gi += CHAIN_THREADS) {
        const int g = base + gi * VEC;
        Group<T> grp;
        if constexpr (DEC) {
#pragma unroll
            for (int i = 0; i < VEC; ++i)
                grp.v[i] = g + i < H ? (T)((uint32_t)(g + i) << sh) : (T)~0u;
        } else {
            const int32_t* q = static_cast<const int32_t*>(in) + ch * H;
            if ((H & 3) == 0 && g + VEC <= H) {
                const int4 a = *reinterpret_cast<const int4*>(q + g);
                const int4 b = *reinterpret_cast<const int4*>(q + g + 4);
                grp.v[0] = (T)a.x; grp.v[1] = (T)a.y;
                grp.v[2] = (T)a.z; grp.v[3] = (T)a.w;
                grp.v[4] = (T)b.x; grp.v[5] = (T)b.y;
                grp.v[6] = (T)b.z; grp.v[7] = (T)b.w;
            } else {
#pragma unroll
                for (int i = 0; i < VEC; ++i)
                    grp.v[i] = g + i < H ? (T)q[g + i] : (T)0xFFFFu;
            }
        }
        *reinterpret_cast<uint4*>(cur + gi * VEC) = grp.u;
    }
}

// The encode's cluster route: store one staged run -- global slots [d, d +
// n), staged so that `staged[k]` belongs at slot (d - d % VEC) + k -- into
// the owners' next buffers, and add its elements' bits of the next sorting
// line `jn` (if any) to the owners' counters `cnt`.  Warp-uniform
// arguments.
__device__ __forceinline__ void store_run(const uint16_t* staged,
                                          uint16_t* nxt, int* cnt, int d,
                                          int n, int S, int K, int jn) {
    using T = uint16_t;
    constexpr int VEC = Chain<false>::VEC;
    if (n == 0) return;
    cg::cluster_group cluster = cg::this_cluster();
    const int lane = threadIdx.x & 31;
    const int a0 = d - d % VEC;
    const int n_chunks = (d % VEC + n + VEC - 1) / VEC;
    const int lo = a0 / S;  // the run's owners: lo, and lo + 1 past `bound`
    const int bound = (lo + 1) * S;
    T* dst_lo = cluster.map_shared_rank(nxt, lo);
    T* dst_hi = lo + 1 < K ? cluster.map_shared_rank(nxt, lo + 1) : dst_lo;
    int ones_lo = 0, ones_hi = 0;
    for (int c = lane; c < n_chunks; c += 32) {
        const int g = a0 + c * VEC;
        const bool hi = g >= bound;
        T* dst = hi ? dst_hi + (g - bound) : dst_lo + (g - lo * S);
        const T* src = staged + c * VEC;
        int ones = 0;
        if (g >= d && g + VEC <= d + n) {
            *reinterpret_cast<uint4*>(dst) =
                *reinterpret_cast<const uint4*>(src);
            if (jn >= 0) {
#pragma unroll
                for (int i = 0; i < VEC; ++i) ones += (src[i] >> jn) & 1;
            }
        } else {
#pragma unroll
            for (int i = 0; i < VEC; ++i) {
                if (g + i >= d && g + i < d + n) {
                    dst[i] = src[i];
                    if (jn >= 0) ones += (src[i] >> jn) & 1;
                }
            }
        }
        if (hi) ones_hi += ones; else ones_lo += ones;
    }
    if (jn >= 0) {
        ones_lo = __reduce_add_sync(0xffffffffu, ones_lo);
        ones_hi = __reduce_add_sync(0xffffffffu, ones_hi);
        if (lane == 0) {
            if (ones_lo) atomicAdd(cluster.map_shared_rank(cnt, lo), ones_lo);
            if (ones_hi) atomicAdd(cluster.map_shared_rank(cnt, lo + 1),
                                   ones_hi);
        }
    }
}

// The encode's output byte of line j at one slot: the register's bit j,
// and with the parity payload its bit 15 (the slot's parity) above it.
template <bool PAR>
__device__ __forceinline__ uint32_t emit_bits(uint16_t v, int j) {
    uint32_t b = (v >> j) & 1u;
    if constexpr (PAR) b |= (uint32_t)(v >> 15) << 1;
    return b;
}

// One chunk per CTA (CL false) or per cluster of K CTAs (CL true), the
// rows in shared memory, or (the decode on a cluster, GM) in device memory
// at `rows` (2 K S states a chunk).
//   encode (DEC false): in = q0 int32[n_ch, H], out = y uint8[n_ch, C, H]
//                       (PAR: C <= 15, bit 15 of q0 the slot parity);
//   decode (DEC true):  in = yc uint8[n_ch, C, H], out = uint32[n_ch, H],
//                       the states (slot << sh) | beta (C <= sh).
// S: slots per CTA, a whole number of tiles (K * S >= H).
template <bool DEC, bool CL, bool PAR>
__global__ void __launch_bounds__(CHAIN_THREADS)
chain_kernel(const void* __restrict__ in, const uint8_t* __restrict__ ss,
             void* __restrict__ out, uint32_t* __restrict__ rows, int H,
             int C, int S, int sh) {
    constexpr bool GM = DEC && CL;
    using T = typename Chain<DEC>::T;
    constexpr int VEC = Chain<DEC>::VEC;
    constexpr int TILE = Chain<DEC>::TILE;
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ int tile_ones[GM ? MAX_TILES_ROWS : MAX_TILES];
    __shared__ int cta_ones[3];  // cluster encode: rotating line counters
    // cluster decode: each line's ones in this CTA's slots, and in the
    // slots before them and in all (pads included)
    __shared__ int line_ones[16], line_before[16], line_total[16];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    int K = 1, rank = 0;
    if constexpr (CL) {
        cg::cluster_group cluster = cg::this_cluster();
        K = (int)cluster.num_blocks();
        rank = (int)cluster.block_rank();
    }
    const long ch = blockIdx.x / K;
    const int base = rank * S;  // global slot of this CTA's first slot
    const int NT = S / TILE;
    const int per = (NT + 31) >> 5;  // tiles per lane in the tile scan
    // the rows: this CTA's share of the current one (`cur`) and where the
    // scatter stores (`nxt`: the next row's own share in shared memory on
    // the cluster route, whole rows on the one-CTA and device routes)
    T* cur = reinterpret_cast<T*>(smem);
    T* nxt = cur + S;
    T* stage = nxt + S + warp * Chain<DEC>::STAGE;  // the encode's cluster
    T* cur_row = nullptr;
    if constexpr (GM) {
        cur_row = reinterpret_cast<T*>(rows) + ch * 2 * (long)K * S;
        nxt = cur_row + (long)K * S;
        cur = cur_row + base;
    }
    const uint8_t* yc = static_cast<const uint8_t*>(in);
    unsigned sorts = 0;  // bit j: line j sorts (uniform in the cluster)
    for (int j = 0; j < C; ++j)
        sorts |= (unsigned)(ss[ch * C + j] != 0) << j;

    load_row<DEC>(cur, in, ch, H, base, S, sh);
    if constexpr (CL && DEC) {
        if (sorts) {
            // Decode's bit of line j at slot g is the input byte yc[j][g]
            // in the arrangement line j partitions, so every line's counts
            // are known before the chain starts: warp j counts line j in
            // this CTA's slots, and one cluster barrier publishes them.
            const int hi = min(H, base + S);
            if (warp < C) {
                const uint8_t* row = yc + (ch * C + warp) * (long)H;
                int ones = 0;
#pragma unroll 4
                for (int g = base + lane * 16; g < hi; g += 32 * 16) {
                    if ((H & 15) == 0) {
                        const uint4 w =
                            *reinterpret_cast<const uint4*>(row + g);
                        ones += __popc(w.x & 0x01010101u) +
                                __popc(w.y & 0x01010101u) +
                                __popc(w.z & 0x01010101u) +
                                __popc(w.w & 0x01010101u);
                    } else {
                        for (int i = g; i < min(hi, g + 16); ++i)
                            ones += row[i] & 1;
                    }
                }
                ones = __reduce_add_sync(0xffffffffu, ones);
                if (lane == 0)  // pads (slots past H) are ones
                    line_ones[warp] = ones + max(0, base + S - max(H, base));
            }
            cg::cluster_group cluster = cg::this_cluster();
            cluster.sync();
            if (threadIdx.x < C) {
                int before = 0, total = 0;
                for (int q = 0; q < K; ++q) {
                    const int c =
                        *cluster.map_shared_rank(&line_ones[threadIdx.x], q);
                    total += c;
                    if (q < rank) before += c;
                }
                line_before[threadIdx.x] = before;
                line_total[threadIdx.x] = total;
            }
            // read after the count pass's barrier; every remote read is
            // done before the first sorting line's cluster barrier
        }
    }
    if constexpr (CL && !DEC) {
        if (sorts) {
            // the first sorting line's count of this CTA's slots
            const int j0 = __ffs(sorts) - 1;
            if (threadIdx.x == 0) cta_ones[0] = cta_ones[1] = cta_ones[2] = 0;
            __syncthreads();
            int ones = 0;
            for (int gi = threadIdx.x; gi < S / VEC; gi += CHAIN_THREADS) {
#pragma unroll
                for (int i = 0; i < VEC; ++i)
                    ones += (cur[gi * VEC + i] >> j0) & 1;
            }
            ones = __reduce_add_sync(0xffffffffu, ones);
            if (lane == 0 && ones) atomicAdd(&cta_ones[0], ones);
            cg::this_cluster().sync();
        }
    }

    int s = 0;  // sorting lines done
    for (int j = 0; j < C; ++j) {
        const bool sorting = (sorts >> j) & 1;
        // ---- 1. the count pass (and decode's OR, encode's emit) ----------
#pragma unroll 4
        for (int t = warp; t < NT; t += CHAIN_WARPS) {
            const int gi = t * 32 + lane;
            const int g = base + gi * VEC;
            Group<T> grp;
            grp.u = *reinterpret_cast<const uint4*>(cur + gi * VEC);
            if constexpr (DEC) {
                const uint32_t b4 =
                    load_bits4(yc + (ch * C + j) * (long)H, g, H);
#pragma unroll
                for (int i = 0; i < VEC; ++i)
                    grp.v[i] |= ((b4 >> (8 * i)) & 1u) << j;
                *reinterpret_cast<uint4*>(cur + gi * VEC) = grp.u;
            } else {
                uint8_t* y_row =
                    static_cast<uint8_t*>(out) + (ch * C + j) * (long)H;
                uint32_t lo = 0, hi = 0;
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    lo |= emit_bits<PAR>(grp.v[i], j) << (8 * i);
                    hi |= emit_bits<PAR>(grp.v[i + 4], j) << (8 * i);
                }
                if ((H & 7) == 0 && g + VEC <= H) {
                    *reinterpret_cast<uint2*>(y_row + g) = make_uint2(lo, hi);
                } else {
#pragma unroll
                    for (int i = 0; i < VEC; ++i)
                        if (g + i < H)
                            y_row[g + i] =
                                (uint8_t)emit_bits<PAR>(grp.v[i], j);
                }
            }
            if (sorting) {
                int ones = 0;
#pragma unroll
                for (int i = 0; i < VEC; ++i) ones += (grp.v[i] >> j) & 1;
                ones = __reduce_add_sync(0xffffffffu, ones);
                if (lane == 0) tile_ones[t] = ones;
            }
        }
        if (!sorting) continue;
        __syncthreads();  // every tile count (and decode's ORed row) is in

        // ---- 2. each warp scans the tile counts itself --------------------
        int lsum = 0;
        for (int u = 0; u < per; ++u) {
            const int t = lane * per + u;
            if (t < NT) lsum += tile_ones[t];
        }
        int incl = lsum;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const int y = __shfl_up_sync(0xffffffffu, incl, o);
            if (lane >= o) incl += y;
        }
        const int lexcl = incl - lsum;
        int ones_before_cta = 0;
        int ones_total = __shfl_sync(0xffffffffu, incl, 31);
        int jn = -1;  // the next sorting line, whose counts the stores take
        if constexpr (CL && DEC) {
            ones_before_cta = line_before[j];
            ones_total = line_total[j];
        } else if constexpr (CL) {
            cg::cluster_group cluster = cg::this_cluster();
            const int c = lane < K
                ? *cluster.map_shared_rank(&cta_ones[s % 3], lane) : 0;
            ones_total = __reduce_add_sync(0xffffffffu, c);
            ones_before_cta = __reduce_add_sync(0xffffffffu,
                                                lane < rank ? c : 0);
            const unsigned later = sorts & ~((2u << j) - 1u);
            jn = later ? __ffs(later) - 1 : -1;
        }
        const int n_zeros = K * S - ones_total;

        // ---- 3. the scatter, a tile's zeros and ones as two runs ----------
        for (int t = warp; t < NT; t += CHAIN_WARPS) {
            const int src_lane = t / per;
            int tb = __shfl_sync(0xffffffffu, lexcl, src_lane);
            for (int u = src_lane * per; u < t; ++u) tb += tile_ones[u];
            const int ones_before = ones_before_cta + tb;
            const int n_ones = tile_ones[t];
            const int zdst = base + t * TILE - ones_before;  // zeros' run
            const int odst = n_zeros + ones_before;           // ones' run
            T* zst = stage + zdst % VEC;
            T* ost = stage + (TILE + VEC) + odst % VEC;
            int zs = 0, os = 0;
#pragma unroll
            for (int i = 0; i < VEC; ++i) {
                const T v = cur[t * TILE + i * 32 + lane];
                const bool b = (v >> j) & 1;
                const unsigned bal = __ballot_sync(0xffffffffu, b);
                const int ob = __popc(bal & ((1u << lane) - 1u));
                if constexpr (CL && !DEC) {
                    if (b) ost[os + ob] = v;
                    else zst[zs + lane - ob] = v;
                } else {
                    nxt[b ? odst + os + ob : zdst + zs + lane - ob] = v;
                }
                os += __popc(bal);
                zs += 32 - __popc(bal);
            }
            if constexpr (CL && !DEC) {
                __syncwarp();
                int* cnt = &cta_ones[(s + 1) % 3];
                store_run(stage, nxt, cnt, zdst, TILE - n_ones, S, K, jn);
                store_run(stage + TILE + VEC, nxt, cnt, odst, n_ones, S, K,
                          jn);
                __syncwarp();  // the staging is free for the next tile
            }
        }

        // ---- 4. the next buffer is complete -------------------------------
        if constexpr (CL) {
            if (!DEC && threadIdx.x == 0) cta_ones[(s + 2) % 3] = 0;
            cg::this_cluster().sync();
        } else {
            __syncthreads();
        }
        if constexpr (GM) {
            T* tmp = cur_row;
            cur_row = nxt;
            nxt = tmp;
            cur = cur_row + base;
        } else {
            T* tmp = cur;
            cur = nxt;
            nxt = tmp;
        }
        ++s;
    }

    if constexpr (DEC) {
        uint32_t* o_row = static_cast<uint32_t*>(out) + ch * H;
        for (int gi = threadIdx.x; gi < S / VEC; gi += CHAIN_THREADS) {
            const int g = base + gi * VEC;
            const uint4 v = *reinterpret_cast<const uint4*>(cur + gi * VEC);
            if ((H & 3) == 0 && g + VEC <= H) {
                *reinterpret_cast<uint4*>(o_row + g) = v;
            } else {
                const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
                for (int i = 0; i < 4; ++i)
                    if (g + i < H) o_row[g + i] = w[i];
            }
        }
    }
}

// Slots per CTA of a K-CTA chain at width H (whole tiles), and its dynamic
// shared memory: the double-buffered slots, plus every warp's staging on
// the encode's cluster route; the decode's cluster keeps its rows in device
// memory and takes none.  Mirrors ops/pbwt_kernels.py chain_smem_bytes.
template <bool DEC>
static int slots_per_cta(int H, int K) {
    constexpr int TILE = Chain<DEC>::TILE;
    const int share = (H + K - 1) / K;
    return (share + TILE - 1) / TILE * TILE;
}

template <bool DEC>
static size_t smem_bytes(int S, int K) {
    using T = typename Chain<DEC>::T;
    if (DEC && K > 1) return 0;
    size_t b = 2 * sizeof(T) * (size_t)S;
    if (K > 1) b += sizeof(T) * (size_t)CHAIN_WARPS * Chain<DEC>::STAGE;
    return b;
}

template <bool DEC, bool PAR = false>
static int launch_one_cta(const void* in, const void* ss, void* out,
                          int n_ch, int H, int C, int sh,
                          cudaStream_t stream) {
    const int S = slots_per_cta<DEC>(H, 1);
    if (S / Chain<DEC>::TILE > MAX_TILES) return (int)cudaErrorInvalidValue;
    const size_t smem = smem_bytes<DEC>(S, 1);
    const cudaError_t e = cudaFuncSetAttribute(
        chain_kernel<DEC, false, PAR>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    if (n_ch > 0)
        chain_kernel<DEC, false, PAR><<<n_ch, CHAIN_THREADS, smem, stream>>>(
            in, (const uint8_t*)ss, out, nullptr, H, C, S, sh);
    return (int)cudaGetLastError();
}

// Launch the K-CTA route on n_ch clusters (the decode's with its rows at
// `rows`).  Refuses (XSI_ERR_NO_CLUSTER) when the device cannot hold one
// such cluster.
template <bool DEC, bool PAR = false>
static int launch_cluster(const void* in, const void* ss, void* out,
                          void* rows, int n_ch, int H, int C, int sh, int K,
                          cudaStream_t stream) {
    if (K < 1 || K > MAX_CLUSTER || (DEC && rows == nullptr))
        return (int)cudaErrorInvalidValue;
    const int S = slots_per_cta<DEC>(H, K);
    if (S / Chain<DEC>::TILE > (DEC ? MAX_TILES_ROWS : MAX_TILES))
        return (int)cudaErrorInvalidValue;
    const size_t smem = smem_bytes<DEC>(S, K);
    auto kernel = chain_kernel<DEC, true, PAR>;
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    if (K > PORTABLE_CLUSTER) {
        e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
        if (e != cudaSuccess) return (int)e;
    }
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = K;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)((n_ch > 0 ? n_ch : 1) * K));
    cfg.blockDim = dim3(CHAIN_THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int n_clusters = 0;
    e = cudaOccupancyMaxActiveClusters(&n_clusters, kernel, &cfg);
    if (e != cudaSuccess) return (int)e;
    if (n_clusters < 1) return XSI_ERR_NO_CLUSTER;
    if (n_ch == 0) return 0;
    e = cudaLaunchKernelEx(&cfg, kernel, in, (const uint8_t*)ss, out,
                           (uint32_t*)rows, H, C, S, sh);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}

// The decode entry points take the state's shift sh: C <= sh <= 16 and
// the slots below 2^(32 - sh).
static bool bad_shift(int H, int C, int sh) {
    return sh < C || sh > 16 || (H > 1 && ((uint32_t)(H - 1) >> (32 - sh)));
}

extern "C" int xsi_chain_encode(const void* q0, const void* ss, void* y,
                                int n_ch, int H, int C, void* stream) {
    return launch_one_cta<false>(q0, ss, y, n_ch, H, C, 0,
                                 (cudaStream_t)stream);
}

extern "C" int xsi_chain_decode(const void* yc, const void* ss, void* out,
                                int n_ch, int H, int C, int sh,
                                void* stream) {
    if (bad_shift(H, C, sh)) return (int)cudaErrorInvalidValue;
    return launch_one_cta<true>(yc, ss, out, n_ch, H, C, sh,
                                (cudaStream_t)stream);
}

extern "C" int xsi_chain_encode_cluster(const void* q0, const void* ss,
                                        void* y, int n_ch, int H, int C,
                                        int K, void* stream) {
    return launch_cluster<false>(q0, ss, y, nullptr, n_ch, H, C, 0, K,
                                 (cudaStream_t)stream);
}

// The encode with the parity payload (bit 15 of each register, C <= 15):
// each output byte is the line's bit | (the slot's parity << 1).
extern "C" int xsi_chain_encode_parity(const void* q0, const void* ss,
                                       void* y, int n_ch, int H, int C,
                                       void* stream) {
    if (C > 15) return (int)cudaErrorInvalidValue;
    return launch_one_cta<false, true>(q0, ss, y, n_ch, H, C, 0,
                                       (cudaStream_t)stream);
}

extern "C" int xsi_chain_encode_parity_cluster(const void* q0,
                                               const void* ss, void* y,
                                               int n_ch, int H, int C, int K,
                                               void* stream) {
    if (C > 15) return (int)cudaErrorInvalidValue;
    return launch_cluster<false, true>(q0, ss, y, nullptr, n_ch, H, C, 0, K,
                                       (cudaStream_t)stream);
}

// The decode on a cluster of K CTAs with both rows in device memory:
// `rows` holds 2 K S uint32 states a chunk, S = ceil(H / K) in whole tiles
// (mirrors ops/pbwt_kernels.py chain_rows_slots).
extern "C" int xsi_chain_decode_rows(const void* yc, const void* ss,
                                     void* out, void* rows, int n_ch, int H,
                                     int C, int sh, int K, void* stream) {
    if (bad_shift(H, C, sh)) return (int)cudaErrorInvalidValue;
    return launch_cluster<true>(yc, ss, out, rows, n_ch, H, C, sh, K,
                                (cudaStream_t)stream);
}

extern "C" const char* xsi_cuda_error_string(int code) {
    if (code == XSI_ERR_NO_CLUSTER)
        return "no thread-block cluster of this size and shared memory "
               "fits on the device";
    return cudaGetErrorString((cudaError_t)code);
}
