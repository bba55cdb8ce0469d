// PBWT chunk chains: encode and decode, one CTA per chunk of C <= 16 lines.
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
// row lives in shared memory for the whole chain, double buffered: 2 x 2 B
// per haplotype for encode, 2 x 4 B for decode.  The 227 KB a CTA may use
// caps H at 57,856 (encode) and 28,928 (decode) haplotypes; the wrappers
// raise above that.  At H = 5008 a CTA uses 20 KB (encode) or 40 KB
// (decode).  Per line the CTA does a block scan over the row (latency of a
// few barriers) and one scattered write pass over shared memory; device
// memory sees only the chunk's input once and its output once.
//
// What the design does about it.  A partition is one block-wide exclusive
// scan of the bit (ones_before and n_zeros) and one scatter to
// `bit ? n_zeros + ones_before : slot - ones_before` in the other buffer.
// Each thread owns a run of consecutive slots so one scan serves the whole
// row.  The TPU kernel's log2(H) roll stages, junk shift words, 128-lane
// padding and packed flag words existed because Mosaic has no lane scatter;
// none of them is needed here.  The grid is the chunk count (about 250 on
// the 1KGP3 block) over 132 SMs.
#include "scan.cuh"

constexpr int CHAIN_THREADS = 512;

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

extern "C" const char* xsi_cuda_error_string(int code) {
    return cudaGetErrorString((cudaError_t)code);
}
