// PBWT chunk chains: encode and decode, one CTA or one thread-block
// cluster per chunk of C <= 16 lines.
//
// Replaces xsqueezeit_tpu/ops/pbwt_pallas.py _chain_encode_kernel (:133-170)
// and _chain_decode_kernel (:76-130).
//
// What they compute.  A chunk's state is one value per haplotype slot in
// arrangement order.  For each line j of the chunk the bit of line j is read
// at every slot; if the line sorts, the slots are stably partitioned by that
// bit (zeros keep their order at the front, ones follow in order).
//   encode: the state is each haplotype's 16-bit register of the chunk's
//           bits (bit j = line j); line j's output is bit j of every slot.
//   decode: the state is (chunk-start slot << 16) | beta; line j's input bit
//           is ORed into beta at bit j before the partition, so it travels
//           with its haplotype.  The final state is the kernel's output.
//
// What bounds them on this card.  The chain is sequential over the C lines
// of a chunk and every partition is a permutation of the whole row, so the
// row stays on chip for the whole chain, double buffered: 2 x 2 B per
// haplotype for encode, 2 x 4 B for decode.  Device memory sees only the
// chunk's input once and its output once.  Per line the work is a scan over
// the row (latency of a few barriers) and one scattered write pass.
//
// Two routes, chosen by the wrapper (ops/pbwt_kernels.py) from H:
//
// One CTA per chunk (chain_*_kernel) while the double-buffered row fits the
// 227 KB one CTA may use: H <= 57,856 (encode) or 28,928 (decode).  At
// H = 5008 a CTA uses 20 KB (encode) or 40 KB (decode).  A partition is one
// block-wide exclusive scan of the bit (ones_before and n_zeros) and one
// scatter to `bit ? n_zeros + ones_before : slot - ones_before` in the other
// buffer.  Each thread owns a run of consecutive slots so one scan serves
// the whole row.  The TPU kernel's log2(H) roll stages, junk shift words,
// 128-lane padding and packed flag words existed because Mosaic has no lane
// scatter; none of them is needed here.
//
// A cluster of K <= 8 CTAs per chunk (chain_*_cluster_kernel) above that, up
// to H = 65,535 (the 16-bit slot field): at HRC width (H = 64,976) the row
// is 254 KiB (encode) or 508 KiB (decode).  CTA r of the cluster owns the
// slots [r*S, r*S + S) of the row, S = ceil(H / K), double buffered in its
// own shared memory (K = 2 for encode and 4 for decode at HRC: 127 KiB per
// CTA).  A partition is the one-CTA scan inside each CTA, then each CTA
// publishes its ones count, a cluster barrier, each CTA reads the lower
// ranks' counts through distributed shared memory to place its slots
// globally, and each element is stored into the owning CTA's next buffer
// (distributed shared memory), then a second cluster barrier.  The second
// barrier also keeps the next line's count from overwriting one that a
// slower CTA has not read yet.  Emitting bits (encode) and ORing them into
// beta (decode) stay local to each CTA's slots.
#include <cooperative_groups.h>

#include "scan.cuh"

namespace cg = cooperative_groups;

constexpr int CHAIN_THREADS = 512;
constexpr int MAX_CLUSTER = 8;  // the portable cluster size
// Returned when no cluster of the requested shape fits on the device.
constexpr int XSI_ERR_NO_CLUSTER = 100001;

// Stable partition of cur[0:H] by bit j into nxt[0:H].
template <typename T>
__device__ void partition_by_bit(const T* cur, T* nxt, int H, int j,
                                 int* scratch) {
    const int per = (H + blockDim.x - 1) / blockDim.x;
    const int lo = min(H, (int)threadIdx.x * per);
    const int hi = min(H, lo + per);
    int count = 0;
    for (int k = lo; k < hi; ++k) count += (cur[k] >> j) & 1;
    int ones_total;
    int ones_before =
        block_inclusive_scan<SumOp>(count, scratch, &ones_total) - count;
    const int n_zeros = H - ones_total;
    for (int k = lo; k < hi; ++k) {
        const T v = cur[k];
        const int bit = (v >> j) & 1;
        nxt[bit ? n_zeros + ones_before : k - ones_before] = v;
        ones_before += bit;
    }
}

__global__ void __launch_bounds__(CHAIN_THREADS)
chain_encode_kernel(const int32_t* __restrict__ q0,
                    const uint8_t* __restrict__ ss,
                    uint8_t* __restrict__ y, int H, int C) {
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ int scratch[32];
    uint16_t* cur = reinterpret_cast<uint16_t*>(smem);
    uint16_t* nxt = cur + H;
    const long ch = blockIdx.x;
    const int32_t* q_row = q0 + ch * H;
    for (int k = threadIdx.x; k < H; k += blockDim.x)
        cur[k] = (uint16_t)q_row[k];
    __syncthreads();
    for (int j = 0; j < C; ++j) {
        uint8_t* y_row = y + (ch * C + j) * (long)H;
        for (int k = threadIdx.x; k < H; k += blockDim.x)
            y_row[k] = (cur[k] >> j) & 1;
        if (ss[ch * C + j]) {  // one flag per chunk line: uniform in the CTA
            partition_by_bit(cur, nxt, H, j, scratch);
            __syncthreads();
            uint16_t* t = cur;
            cur = nxt;
            nxt = t;
        }
    }
}

__global__ void __launch_bounds__(CHAIN_THREADS)
chain_decode_kernel(const uint8_t* __restrict__ yc,
                    const uint8_t* __restrict__ ss,
                    uint32_t* __restrict__ out, int H, int C) {
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ int scratch[32];
    uint32_t* cur = reinterpret_cast<uint32_t*>(smem);
    uint32_t* nxt = cur + H;
    const long ch = blockIdx.x;
    for (int k = threadIdx.x; k < H; k += blockDim.x)
        cur[k] = (uint32_t)k << 16;
    for (int j = 0; j < C; ++j) {
        // beta's bit j is still 0 here, so after the OR bit j of the state
        // is the line's bit and the partition can read it from there
        const uint8_t* y_row = yc + (ch * C + j) * (long)H;
        for (int k = threadIdx.x; k < H; k += blockDim.x)
            cur[k] |= (uint32_t)(y_row[k] & 1) << j;
        __syncthreads();
        if (ss[ch * C + j]) {
            partition_by_bit(cur, nxt, H, j, scratch);
            __syncthreads();
            uint32_t* t = cur;
            cur = nxt;
            nxt = t;
        }
    }
    uint32_t* o_row = out + ch * H;
    for (int k = threadIdx.x; k < H; k += blockDim.x) o_row[k] = cur[k];
}

// ---- cluster route --------------------------------------------------------

// The slots a CTA of a cluster owns: [base, base + n); n is 0 for a CTA
// past the end of a short row.
struct SlotRange {
    int base;
    int n;
};

__device__ __forceinline__ SlotRange slot_range(int H, int S, int rank) {
    const int base = min(H, rank * S);
    return {base, min(H, base + S) - base};
}

// Stable partition of the row by bit j across the cluster: this CTA's
// cur[0:r.n] (global slots r.base + k) go to their destinations in the
// owning CTAs' nxt buffers.  `cta_ones` is this CTA's published count.
template <typename T>
__device__ void cluster_partition_by_bit(const T* cur, T* nxt, int H, int S,
                                         SlotRange r, int j, int* scratch,
                                         int* cta_ones) {
    cg::cluster_group cluster = cg::this_cluster();
    const int per = (r.n + blockDim.x - 1) / blockDim.x;
    const int lo = min(r.n, (int)threadIdx.x * per);
    const int hi = min(r.n, lo + per);
    int count = 0;
    for (int k = lo; k < hi; ++k) count += (cur[k] >> j) & 1;
    int cta_total;
    int ones_before =
        block_inclusive_scan<SumOp>(count, scratch, &cta_total) - count;
    if (threadIdx.x == 0) *cta_ones = cta_total;
    cluster.sync();  // every CTA's count is published
    const int rank = (int)cluster.block_rank();
    const int K = (int)cluster.num_blocks();
    int ones_total = 0;
    for (int q = 0; q < K; ++q) {
        const int c = *cluster.map_shared_rank(cta_ones, q);
        ones_total += c;
        if (q < rank) ones_before += c;
    }
    const int n_zeros = H - ones_total;
    for (int k = lo; k < hi; ++k) {
        const T v = cur[k];
        const int bit = (v >> j) & 1;
        const int dest = bit ? n_zeros + ones_before
                             : r.base + k - ones_before;
        const int owner = dest / S;
        *cluster.map_shared_rank(nxt + (dest - owner * S), owner) = v;
        ones_before += bit;
    }
    cluster.sync();  // every nxt is complete and every count was read
}

__global__ void __launch_bounds__(CHAIN_THREADS)
chain_encode_cluster_kernel(const int32_t* __restrict__ q0,
                            const uint8_t* __restrict__ ss,
                            uint8_t* __restrict__ y, int H, int C, int S) {
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ int scratch[32];
    __shared__ int cta_ones;
    cg::cluster_group cluster = cg::this_cluster();
    const long ch = blockIdx.x / cluster.num_blocks();
    const SlotRange r = slot_range(H, S, (int)cluster.block_rank());
    uint16_t* cur = reinterpret_cast<uint16_t*>(smem);
    uint16_t* nxt = cur + S;
    const int32_t* q_row = q0 + ch * H + r.base;
    for (int k = threadIdx.x; k < r.n; k += blockDim.x)
        cur[k] = (uint16_t)q_row[k];
    __syncthreads();
    for (int j = 0; j < C; ++j) {
        uint8_t* y_row = y + (ch * C + j) * (long)H + r.base;
        for (int k = threadIdx.x; k < r.n; k += blockDim.x)
            y_row[k] = (cur[k] >> j) & 1;
        if (ss[ch * C + j]) {  // uniform in the cluster
            cluster_partition_by_bit(cur, nxt, H, S, r, j, scratch,
                                     &cta_ones);
            uint16_t* t = cur;
            cur = nxt;
            nxt = t;
        }
    }
}

__global__ void __launch_bounds__(CHAIN_THREADS)
chain_decode_cluster_kernel(const uint8_t* __restrict__ yc,
                            const uint8_t* __restrict__ ss,
                            uint32_t* __restrict__ out, int H, int C,
                            int S) {
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ int scratch[32];
    __shared__ int cta_ones;
    cg::cluster_group cluster = cg::this_cluster();
    const long ch = blockIdx.x / cluster.num_blocks();
    const SlotRange r = slot_range(H, S, (int)cluster.block_rank());
    uint32_t* cur = reinterpret_cast<uint32_t*>(smem);
    uint32_t* nxt = cur + S;
    for (int k = threadIdx.x; k < r.n; k += blockDim.x)
        cur[k] = (uint32_t)(r.base + k) << 16;
    for (int j = 0; j < C; ++j) {
        const uint8_t* y_row = yc + (ch * C + j) * (long)H + r.base;
        for (int k = threadIdx.x; k < r.n; k += blockDim.x)
            cur[k] |= (uint32_t)(y_row[k] & 1) << j;
        __syncthreads();
        if (ss[ch * C + j]) {
            cluster_partition_by_bit(cur, nxt, H, S, r, j, scratch,
                                     &cta_ones);
            uint32_t* t = cur;
            cur = nxt;
            nxt = t;
        }
    }
    uint32_t* o_row = out + ch * H + r.base;
    for (int k = threadIdx.x; k < r.n; k += blockDim.x) o_row[k] = cur[k];
}

// Launch `kernel` on n_ch clusters of K CTAs with `smem` dynamic shared
// bytes per CTA.  Refuses (XSI_ERR_NO_CLUSTER) when the device cannot hold
// one such cluster.
template <typename... Params, typename... Args>
static int launch_cluster(void (*kernel)(Params...), int n_ch, int K,
                          size_t smem, cudaStream_t stream, Args... args) {
    if (K < 1 || K > MAX_CLUSTER) return (int)cudaErrorInvalidValue;
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
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
    e = cudaLaunchKernelEx(&cfg, kernel, args...);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}

extern "C" int xsi_chain_encode(const void* q0, const void* ss, void* y,
                                int n_ch, int H, int C, void* stream) {
    const size_t smem = 2 * sizeof(uint16_t) * (size_t)H;
    cudaError_t e = cudaFuncSetAttribute(
        chain_encode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    if (n_ch > 0)
        chain_encode_kernel<<<n_ch, CHAIN_THREADS, smem,
                              (cudaStream_t)stream>>>(
            (const int32_t*)q0, (const uint8_t*)ss, (uint8_t*)y, H, C);
    return (int)cudaGetLastError();
}

extern "C" int xsi_chain_decode(const void* yc, const void* ss, void* out,
                                int n_ch, int H, int C, void* stream) {
    const size_t smem = 2 * sizeof(uint32_t) * (size_t)H;
    cudaError_t e = cudaFuncSetAttribute(
        chain_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    if (n_ch > 0)
        chain_decode_kernel<<<n_ch, CHAIN_THREADS, smem,
                              (cudaStream_t)stream>>>(
            (const uint8_t*)yc, (const uint8_t*)ss, (uint32_t*)out, H, C);
    return (int)cudaGetLastError();
}

extern "C" int xsi_chain_encode_cluster(const void* q0, const void* ss,
                                        void* y, int n_ch, int H, int C,
                                        int K, void* stream) {
    const int S = (H + K - 1) / K;
    return launch_cluster(chain_encode_cluster_kernel, n_ch, K,
                          2 * sizeof(uint16_t) * (size_t)S,
                          (cudaStream_t)stream, (const int32_t*)q0,
                          (const uint8_t*)ss, (uint8_t*)y, H, C, S);
}

extern "C" int xsi_chain_decode_cluster(const void* yc, const void* ss,
                                        void* out, int n_ch, int H, int C,
                                        int K, void* stream) {
    const int S = (H + K - 1) / K;
    return launch_cluster(chain_decode_cluster_kernel, n_ch, K,
                          2 * sizeof(uint32_t) * (size_t)S,
                          (cudaStream_t)stream, (const uint8_t*)yc,
                          (const uint8_t*)ss, (uint32_t*)out, H, C, S);
}

extern "C" const char* xsi_cuda_error_string(int code) {
    if (code == XSI_ERR_NO_CLUSTER)
        return "no thread-block cluster of this size and shared memory "
               "fits on the device";
    return cudaGetErrorString((cudaError_t)code);
}
