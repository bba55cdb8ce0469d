// The block decode's sparse lines (xsi_sparse_lines): every line of the
// block that is not a WAH line is filled with its negation byte across H,
// then each of its carriers is set to 1 ^ neg.  It replaces XLA glue of
// decoder_jax.py _decode_block_vals (:58-67), not a Pallas kernel: the
// zeros plane, the carriers' scatter of 1s, the where that merges the WAH
// rows and the XOR by neg, each a pass over the whole L x H plane.  With
// the run flush storing each WAH row at its own line (csrc/pbwt_scan.cu,
// line_of), every line of the block's plane is written once, by the kernel
// that produces it.
//   In: is_wah u8[L], neg u8[L] (1 for a negated sparse line, whose stored
//   indices are its REF positions), car_line int64[Nc] and car_idx
//   int64[Nc], the sparse carriers (any order).
//   Out: the rows l of vals u8[L, H] with is_wah[l] == 0; the WAH rows are
//   not touched.
//   Layout: sparse_line_fill_kernel, a CTA a line (a WAH line's CTA returns
//   at once), 16-byte stores across the row with the unaligned head and
//   tail bytes stored alone; then sparse_carrier_kernel, a thread a carrier,
//   in stream order after it.
//   Bound: the sparse lines' (L - Lw) x H bytes written once, plus the
//   carriers (16 B read, 1 B written each) and the flags (2 B a line read).
#include <stdint.h>

#include <algorithm>

constexpr int FILL_THREADS = 256;
constexpr int CARRIER_THREADS = 256;

__global__ void __launch_bounds__(FILL_THREADS)
    sparse_line_fill_kernel(const uint8_t* __restrict__ is_wah,
                            const uint8_t* __restrict__ neg,
                            uint8_t* __restrict__ vals, int H) {
    const int l = blockIdx.x;
    if (is_wah[l]) return;
    const uint8_t v = neg[l];
    uint8_t* row = vals + (size_t)l * H;
    const int mis = (int)((uintptr_t)row & 15);
    const int head = min(H, mis != 0 ? 16 - mis : 0);
    const int n16 = (H - head) >> 4;
    const int tail = head + (n16 << 4);
    for (int i = threadIdx.x; i < head; i += blockDim.x) row[i] = v;
    const uint32_t v4 = 0x01010101u * v;
    const uint4 fill = make_uint4(v4, v4, v4, v4);
    uint4* body = reinterpret_cast<uint4*>(row + head);
    for (int i = threadIdx.x; i < n16; i += blockDim.x) body[i] = fill;
    for (int i = tail + threadIdx.x; i < H; i += blockDim.x) row[i] = v;
}

__global__ void __launch_bounds__(CARRIER_THREADS)
    sparse_carrier_kernel(const uint8_t* __restrict__ neg,
                          const int64_t* __restrict__ car_line,
                          const int64_t* __restrict__ car_idx,
                          uint8_t* __restrict__ vals, size_t n_car, int H) {
    for (size_t k = (size_t)blockIdx.x * blockDim.x + threadIdx.x; k < n_car;
         k += (size_t)gridDim.x * blockDim.x) {
        const int64_t l = car_line[k];
        vals[(size_t)l * H + car_idx[k]] = (uint8_t)(neg[l] ^ 1);
    }
}

// is_wah, neg u8[L]; car_line, car_idx int64[n_car]; vals u8[L, H].  Two
// launches in stream order: the fill, then (where there are carriers) the
// carriers.
extern "C" int xsi_sparse_lines(const void* is_wah, const void* neg,
                                const void* car_line, const void* car_idx,
                                void* vals, int L, int H, size_t n_car,
                                void* stream) {
    if (L < 0 || H < 1) return (int)cudaErrorInvalidValue;
    if (L == 0) return (int)cudaGetLastError();
    const cudaStream_t st = (cudaStream_t)stream;
    sparse_line_fill_kernel<<<L, FILL_THREADS, 0, st>>>(
        (const uint8_t*)is_wah, (const uint8_t*)neg, (uint8_t*)vals, H);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess || n_car == 0) return (int)e;
    const int blocks = (int)std::min<size_t>(
        (n_car + CARRIER_THREADS - 1) / CARRIER_THREADS, 4096);
    sparse_carrier_kernel<<<blocks, CARRIER_THREADS, 0, st>>>(
        (const uint8_t*)neg, (const int64_t*)car_line,
        (const int64_t*)car_idx, (uint8_t*)vals, n_car, H);
    return (int)cudaGetLastError();
}
