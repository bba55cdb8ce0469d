// The mixed-ploidy decode scan: one launch stepping through a whole block's
// WAH lines on one CTA (the encode's rank chain is csrc/rank_chain.cu).
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
#include <stdint.h>

#include "scan.cuh"

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
