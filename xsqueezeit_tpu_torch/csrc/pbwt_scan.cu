// The mixed-ploidy decode scan's two kernels (the encode's rank chain is
// csrc/rank_chain.cu).  Both replace, with ops/pbwt_torch.py
// pbwt_decode_scan_mixed around them, the XLA function pbwt_jax.py
// pbwt_decode_scan_mixed (:563-604, a lax.scan over the WAH lines of a
// mixed-ploidy block, called at codec/decoder_jax.py:150).
//   What the scan computes, per line l (block start a = a0, the identity in
//   the codec): a haploid line stores only its N = ceil(H / 2) even-parity
//   bits, front-packed; the slot-duplicated line is y[i] = stored[e[a[i] >>
//   1]], where e[s] is the number of even-parity positions before the
//   position that holds haplotype 2s; a diploid line is y = stored.  Then
//   vals[l][a[i]] = y[i], and a sorting line stably partitions a by y.
//   Outputs vals u8[Lw, H] and a_final int64[H].
//   Bound: the bytes of the stored lines read once (a haploid line's
//   ceil(H / 2), a diploid line's H) and of vals written once.
//
// The route (pbwt_torch.pbwt_decode_scan_mixed) cuts the block into its
// maximal runs of one ploidy.  A diploid line moves the arrangement by a
// stable partition of positions that depends only on its stored bits; so
// does a haploid line on the order of the even slots (the samples).  A
// long run is therefore a uniform PBWT decode, of width H (diploid) or N
// (haploid, from the samples' start order E = a[a even] >> 1): the chunk
// chains (csrc/pbwt_chain.cu chain_decode) and the run flush below (the
// chunks' composition, then their rows), spread over every SM.  A haploid
// run's end arrangement is the rank chain (csrc/rank_chain.cu) of the
// per-chunk histories the flush writes.  Short runs take the stepping
// kernel.
//
// DECODE RUN FLUSH (xsi_decode_run_flush): a run's chunk-chain states back
// to natural order, in place of a composition, scatter and 16 shifts in
// torch; one call a run, and one a block of the uniform decode
// (pbwt_torch.pbwt_decode_chunked, a diploid run from the identity).  At
// W > 65,535 slots it replaces the blocked decode's phases 2 and 3
// (pbwt_jax.py pbwt_decode_blocked, :456).
//   In: per chunk t and end slot j, p_fin[t][j] = (chunk-start slot << sh)
//   | beta (chain_decode's u32 states, read as the chain kernel wrote
//   them; sh = 16 up to 65,536 slots, else the chunk's C lines); start[p],
//   the haplotype (diploid) or sample
//   (haploid) at run-start position p; the chunks' sort flags.
//   Out: rows l = C t + k < n of vals, rows[l][h] = bit k of beta of h's
//   slot (a haploid sample's bit at both of its slots 2s, 2s + 1 < H),
//   each stored at its block line line_of[l] where a line map is given (the
//   uniform decode writes its WAH rows straight into the block's plane); for
//   a haploid run also T[t][h], the bits of h's sorting lines in chunk t,
//   latest highest (the rank chain's histories, pbwt_encode_chunked's T);
//   last[j], the haplotype (sample) at end slot j of the run.
//   Layout: the composition inc[t] = inc[t - 1][p_fin[t] >> sh], the
//   run-start position at each end slot, as a doubling scan of gathers
//   (compose_level_kernel, one launch a level over all chunks and slots,
//   int32, double-buffered; pbwt_torch._compose_prefix is its plain form):
//   in torch it took five dispatched ops a level, and the route was bound
//   by the host.  Then decode_run_flush_kernel<HAP>, a CTA a chunk, up to
//   W = 65,535: it scatters beta into natural order in shared memory (2 B a
//   slot), then writes the chunk's rows with consecutive threads on
//   consecutive haplotypes (coalesced), and T likewise.  Above 65,535 slots
//   decode_run_flush_cluster_kernel<HAP> takes a chunk on a cluster of K =
//   8 CTAs: CTA r holds the natural-order columns [r Q, r Q + Q), Q =
//   ceil(W / K), as 2 B of shared memory each; each CTA reads its share of
//   the end slots and stores every beta into the owner's shared memory
//   (distributed shared memory), one cluster barrier completes them, and
//   each CTA writes its columns of the chunk's rows (and T), coalesced.
//   Bound: p_fin read (4 B a slot), rows (and T) written; the levels'
//   gathers stay in L2 at the chrX PAR block's width.
//
// STEPPING KERNEL (decode_scan_mixed_kernel<SH>): the scan line by line.
//   Layout: one CTA (its threads follow from H) over the lines in order;
//   the sort and haploid flags are read on the device.  Warp w owns a
//   contiguous segment of positions and walks it 32 at a time, lanes on
//   consecutive positions: a ballot ranks the 32, a running count carries
//   the segment, and one barrier publishes the warps' totals, which every
//   warp sums itself (no block scan).  The arrangement, its double buffer,
//   e, the staged line, y and the line in natural order live in shared
//   memory while they fit (13 B per haplotype: H <= 17,801; the chrX PAR
//   block is 2466), else in a device-memory scratch the wrapper allocates
//   (any H), vals then being written in place.  What holds it above its
//   bound is one pass over the row per line, with two rankings (the even
//   ranks and the partition) and their barriers: about 2.9 us a line at
//   the chrX PAR block's width on an H100.
#include <cooperative_groups.h>
#include <stdint.h>

#include <algorithm>

#include "scan.cuh"

namespace cg = cooperative_groups;

constexpr int MAX_THREADS = 1024;
// Positions per thread the mixed scan aims at (its thread count, a multiple
// of 32 in [64, 1024], follows from H: 512 at the chrX PAR block's 2466).
constexpr int MIXED_PER_THREAD = 5;
constexpr unsigned FULL = 0xffffffffu;
// Dynamic shared memory one CTA may use, less what the static arrays take.
constexpr int DYN_SMEM_LIMIT = 227 * 1024 - 1024;

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
                             const int64_t* __restrict__ a0,
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

    for (int i = tid; i < H; i += nthr)
        a[i] = a0 == nullptr ? i : (int32_t)a0[i];
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

// a0: the arrangement at the first line (int64[H]), null for the identity;
// scratch: null for the shared-memory route, else a device buffer of
// mixed_scratch_bytes(H) for the device-memory route.
extern "C" int xsi_decode_scan_mixed(const void* ys, const void* sorts,
                                     const void* hap, void* vals,
                                     void* a_final, const void* a0,
                                     void* scratch, int Lw, int H,
                                     void* stream) {
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
        (uint8_t*)vals, (int64_t*)a_final, (const int64_t*)a0,
        (int32_t*)scratch, Lw, H);
    return (int)cudaGetLastError();
}

constexpr int FLUSH_THREADS = 512;
constexpr int COMPOSE_THREADS = 256;
// The widest run one CTA flushes, and the cluster the wider ones take.  The
// cut is where the one-CTA route stood before the wide state (slots in 16
// bits); its 2 B a slot would fit about 115,000 slots.
constexpr int FLUSH_ONE_CTA_W = 65535;
constexpr int FLUSH_CLUSTER = 8;
// Returned when no cluster of the requested shape fits on the device (as
// csrc/pbwt_chain.cu, whose xsi_cuda_error_string names it).
constexpr int XSI_ERR_NO_CLUSTER = 100001;

// One level of the composition scan (pbwt_torch._compose_prefix): dst[t][j]
// = src[t - d][src[t][j]] for chunks t >= d, else src[t][j]; src null reads
// the chunk-start slots p_fin >> sh (the first level).
__global__ void __launch_bounds__(COMPOSE_THREADS)
    compose_level_kernel(const uint32_t* __restrict__ p_fin,
                         const int32_t* __restrict__ src,
                         int32_t* __restrict__ dst, int n_ch, int W, int d,
                         int sh) {
    const size_t total = (size_t)n_ch * W;
    for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
         i += (size_t)gridDim.x * blockDim.x) {
        int v = src != nullptr ? src[i] : (int)(p_fin[i] >> sh);
        if (i >= (size_t)d * W) {  // row t - d, column v
            const size_t prev = i - i % W - (size_t)d * W + v;
            v = src != nullptr ? src[prev] : (int)(p_fin[prev] >> sh);
        }
        dst[i] = v;
    }
}

// The chunk's rows (and T) from beta in natural order, X[c - c0] for the
// columns c in [c0, c1) (samples of a haploid run, else haplotypes); each
// thread on consecutive haplotypes.
template <bool HAP>
__device__ __forceinline__ void flush_rows(const uint16_t* X, int c0, int c1,
                                           const uint8_t* __restrict__ ss,
                                           uint8_t* __restrict__ rows,
                                           const int64_t* __restrict__ line_of,
                                           int32_t* __restrict__ T, int t,
                                           int C, int H, int n) {
    const int h0 = HAP ? 2 * c0 : c0;
    const int h1 = min(H, HAP ? 2 * c1 : c1);
    const int l0 = t * C;
    const int nl = min(C, n - l0);
    for (int k = 0; k < nl; ++k) {
        const int64_t l = line_of != nullptr ? line_of[l0 + k] : l0 + k;
        uint8_t* row = rows + (size_t)l * H;
        for (int h = h0 + threadIdx.x; h < h1; h += blockDim.x)
            row[h] = (uint8_t)((X[(HAP ? h >> 1 : h) - c0] >> k) & 1);
    }
    if (T == nullptr) return;
    unsigned mask = 0;  // the chunk's sorting lines
    for (int k = 0; k < C; ++k) mask |= (unsigned)(ss[l0 + k] != 0) << k;
    int32_t* out = T + (size_t)t * H;
    for (int h = h0 + threadIdx.x; h < h1; h += blockDim.x) {
        const unsigned x = X[(HAP ? h >> 1 : h) - c0];
        unsigned v = 0;
        int s = 0;
        for (unsigned m = mask; m != 0; m &= m - 1, ++s)
            v |= ((x >> (__ffs(m) - 1)) & 1u) << s;
        out[h] = (int32_t)v;
    }
}

template <bool HAP>
__global__ void __launch_bounds__(FLUSH_THREADS)
    decode_run_flush_kernel(const uint32_t* __restrict__ p_fin,
                            const int32_t* __restrict__ inc,
                            const int64_t* __restrict__ start,
                            const uint8_t* __restrict__ ss,
                            uint8_t* __restrict__ rows,
                            const int64_t* __restrict__ line_of,
                            int32_t* __restrict__ T,
                            int64_t* __restrict__ last, int C, int W, int H,
                            int n, int sh) {
    extern __shared__ __align__(16) unsigned char smem[];
    uint16_t* X = reinterpret_cast<uint16_t*>(smem);  // [W] beta, natural
    const int t = blockIdx.x;
    const size_t base = (size_t)t * W;
    const bool final_chunk = t == (int)gridDim.x - 1;
    const uint32_t beta = (1u << sh) - 1u;
    for (int j = threadIdx.x; j < W; j += blockDim.x) {
        const uint32_t p = p_fin[base + j];
        const int64_t s = start[inc != nullptr ? inc[base + j] : p >> sh];
        X[s] = (uint16_t)(p & beta);
        if (final_chunk) last[j] = s;
    }
    __syncthreads();
    flush_rows<HAP>(X, 0, W, ss, rows, line_of, T, t, C, H, n);
}

// A chunk on a cluster of K CTAs (W > FLUSH_ONE_CTA_W): CTA r reads the end
// slots [r Q, r Q + Q) and owns the natural-order columns of the same
// range, Q = ceil(W / K); beta goes to the owner's shared memory.
template <bool HAP>
__global__ void __launch_bounds__(FLUSH_THREADS)
    decode_run_flush_cluster_kernel(const uint32_t* __restrict__ p_fin,
                                    const int32_t* __restrict__ inc,
                                    const int64_t* __restrict__ start,
                                    const uint8_t* __restrict__ ss,
                                    uint8_t* __restrict__ rows,
                                    const int64_t* __restrict__ line_of,
                                    int32_t* __restrict__ T,
                                    int64_t* __restrict__ last, int C, int W,
                                    int H, int n, int sh) {
    extern __shared__ __align__(16) unsigned char smem[];
    uint16_t* X = reinterpret_cast<uint16_t*>(smem);  // [Q] beta, natural
    cg::cluster_group cluster = cg::this_cluster();
    const int K = (int)cluster.num_blocks();
    const int r = (int)cluster.block_rank();
    const int t = blockIdx.x / K;
    const int Q = (W + K - 1) / K;
    const int c0 = min(W, r * Q), c1 = min(W, c0 + Q);
    const size_t base = (size_t)t * W;
    const bool final_chunk = t == (int)(gridDim.x / K) - 1;
    const uint32_t beta = (1u << sh) - 1u;
    cluster.sync();  // every CTA of the cluster runs: remote stores may go
    for (int j = c0 + threadIdx.x; j < c1; j += blockDim.x) {
        const uint32_t p = p_fin[base + j];
        const int s = (int)start[inc != nullptr ? inc[base + j] : p >> sh];
        const int owner = s / Q;
        *cluster.map_shared_rank(X + (s - owner * Q), owner) =
            (uint16_t)(p & beta);
        if (final_chunk) last[j] = s;
    }
    cluster.sync();  // every beta is in its owner's shared memory
    flush_rows<HAP>(X, c0, c1, ss, rows, line_of, T, t, C, H, n);
}

// The composition (ceil(log2 n_ch) launches of compose_level_kernel through
// `scratch`, two int32 [n_ch, W] buffers), then the flush, a CTA a chunk
// (W <= FLUSH_ONE_CTA_W) or a cluster of FLUSH_CLUSTER CTAs a chunk (wider;
// ops/pbwt_kernels.py flush_cluster mirrors the choice):
// p_fin u32[n_ch, W], states (slot << sh) | beta; start int64[W]; ss
// u8[n_ch, C]; rows u8[n, H] (the run's rows of vals), or with line_of
// (int64[n], null for contiguous rows) u8[L, H], the run's row k stored at
// rows[line_of[k]] (each row still H contiguous bytes); T int32[n_ch, H] or
// null; last int64[W], the haplotype (sample) at each of the run's end
// slots.  W = ceil(H / 2) for a haploid run (hap != 0), else H; C <= sh <=
// 16 lines a chunk, n in all, (n_ch - 1) C < n <= n_ch C.
extern "C" int xsi_decode_run_flush(const void* p_fin, void* scratch,
                                    const void* start, const void* ss,
                                    void* rows, const void* line_of, void* T,
                                    void* last,
                                    int n_ch, int C, int W, int H, int n,
                                    int hap, int sh, void* stream) {
    if (n_ch < 1 || C < 1 || C > sh || sh > 16 || H < 1 ||
        n <= (n_ch - 1) * C || n > n_ch * C ||
        W != (hap ? (H + 1) / 2 : H) ||
        ((uint32_t)(W - 1) >> (32 - sh)) != 0 ||
        (n_ch > 1 && scratch == nullptr))
        return (int)cudaErrorInvalidValue;
    const int K = W > FLUSH_ONE_CTA_W ? FLUSH_CLUSTER : 1;
    const size_t smem = 2 * (size_t)((W + K - 1) / K);
    if (smem > (size_t)DYN_SMEM_LIMIT) return (int)cudaErrorInvalidValue;
    const cudaStream_t st = (cudaStream_t)stream;
    const size_t total = (size_t)n_ch * W;
    int32_t* buf[2] = {(int32_t*)scratch, (int32_t*)scratch + total};
    const int32_t* inc = nullptr;
    int k = 0;
    const int blocks =
        (int)std::min<size_t>((total + COMPOSE_THREADS - 1) / COMPOSE_THREADS,
                              4096);
    for (int d = 1; d < n_ch; d <<= 1, k ^= 1) {
        compose_level_kernel<<<blocks, COMPOSE_THREADS, 0, st>>>(
            (const uint32_t*)p_fin, inc, buf[k], n_ch, W, d, sh);
        const cudaError_t e = cudaGetLastError();
        if (e != cudaSuccess) return (int)e;
        inc = buf[k];
    }
    if (K == 1) {
        auto kernel = hap ? decode_run_flush_kernel<true>
                          : decode_run_flush_kernel<false>;
        const cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
        kernel<<<n_ch, FLUSH_THREADS, smem, st>>>(
            (const uint32_t*)p_fin, inc, (const int64_t*)start,
            (const uint8_t*)ss, (uint8_t*)rows, (const int64_t*)line_of,
            (int32_t*)T, (int64_t*)last, C, W, H, n, sh);
        return (int)cudaGetLastError();
    }
    auto kernel = hap ? decode_run_flush_cluster_kernel<true>
                      : decode_run_flush_cluster_kernel<false>;
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = K;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)(n_ch * K));
    cfg.blockDim = dim3(FLUSH_THREADS);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int n_clusters = 0;
    e = cudaOccupancyMaxActiveClusters(&n_clusters, kernel, &cfg);
    if (e != cudaSuccess) return (int)e;
    if (n_clusters < 1) return XSI_ERR_NO_CLUSTER;
    e = cudaLaunchKernelEx(&cfg, kernel, (const uint32_t*)p_fin, inc,
                           (const int64_t*)start, (const uint8_t*)ss,
                           (uint8_t*)rows, (const int64_t*)line_of,
                           (int32_t*)T, (int64_t*)last, C, W, H, n, sh);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}
