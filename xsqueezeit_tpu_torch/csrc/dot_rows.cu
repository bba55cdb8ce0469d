// The dot product of a block's selected rows with the phenotype weights
// (xsi_dot_rows): out[k] = sum_h vals[keep[k], h] * w(k, h).  It is the
// port's hand counterpart of the JAX package's jitted
// `v.astype(jnp.float32) @ y2` (xsqueezeit_tpu/bench/tools.py:171), which
// XLA fuses into one pass; torch's gather, float32 copy of the rows and
// gemv moved about ten times the rows' bytes.
//   In: vals u8[L, H] (contiguous, each byte 0 or 1), keep int64[K] (any
//   order, repeats allowed), y f32[n], hap u8[K] or null.
//   Weights: w(k, h) = y[h] with `haploid`, else y[h >> 1]; where hap[k] is
//   set (a mixed block's haploid line, slot-duplicated) the odd slots
//   weigh 0.
//   Out: out f32[K].  A keep[k] outside [0, L) gives NaN at k and reads
//   nothing.
//   Bound: the K selected rows read once, K x H bytes, plus keep (8 B), out
//   (4 B) and the flags (1 B) a row and the weights (4 B a sample): memory
//   bound, each row byte used once.
//   Layout: a warp owns a tile of TILE = 1024 columns of a group of rows;
//   each lane holds its 32 columns' weights in registers, loaded once for
//   the group, and reads its two 16-byte pieces of every row (neighbouring
//   lanes on neighbouring addresses, the row's address taken from keep by
//   the warp itself), two rows at a time.  A byte becomes its weight or 0 by
//   a byte mask (no int-to-float conversion), summed in float32 in a fixed
//   order: four sums a lane, then the warp's butterfly.  Each (row, tile)
//   partial goes to scratch, and dot_rows_sum_kernel adds a row's partials
//   in a fixed order (a warp a row), so the same inputs give the same bits
//   on every call and no float atomic is used.  One tile: the first kernel
//   writes out itself.  Rows of a width that is a multiple of 16 (in a
//   16-byte aligned plane) take 16-byte loads; others load byte by byte.
#include <cuda_runtime.h>
#include <stdint.h>

constexpr int WARPS = 8;                  // warps a CTA of the first kernel
constexpr int LANE_BYTES = 32;            // columns a lane holds
constexpr int TILE = 32 * LANE_BYTES;     // columns a warp holds
constexpr int HALF = TILE / 2;            // one warp-wide 16-byte load
constexpr int SUM_WARPS = 8;              // rows a CTA of the second kernel
// Rows a warp walks: halved from MAX_GROUP while the grid has fewer warps
// than MIN_WARPS (the narrow panels), down to MIN_GROUP.
constexpr int MAX_GROUP = 32;
constexpr int MIN_GROUP = 4;
constexpr long long MIN_WARPS = 16384;

// Columns col .. col + 15 of a row, as four words of bytes; 0 past H.
template <bool VEC>
__device__ __forceinline__ uint4 load16(const uint8_t* row, int col, int H) {
    if (VEC) {
        if (col < H) return __ldcs(reinterpret_cast<const uint4*>(row + col));
        return make_uint4(0u, 0u, 0u, 0u);
    }
    uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int j = 0; j < 16; ++j)
        if (col + j < H) w[j >> 2] |= (uint32_t)row[col + j] << (8 * (j & 3));
    return make_uint4(w[0], w[1], w[2], w[3]);
}

// Adds the weights of the set bytes of word x (bytes 0 or 1), byte i into
// acc[i]: x * 0xFF turns each byte into 0x00 or 0xFF, a byte permute
// spreads byte i over the word, and the weight's bits pass through it.
__device__ __forceinline__ void add_word(uint32_t x, const float* w,
                                         float* acc) {
    const uint32_t m = x * 0xFFu;
#pragma unroll
    for (int i = 0; i < 4; ++i)
        acc[i] += __int_as_float(__float_as_int(w[i]) &
                                 (int)__byte_perm(m, 0u, 0x1111u * i));
}

__device__ __forceinline__ uint32_t word(const uint4& v, int q) {
    return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

// The lane's sum over its 32 columns of one row (pieces a and b), the odd
// slots masked out where `mask` is 0x00FF00FF, then the warp's sum.
__device__ __forceinline__ float row_sum(const uint4& a, const uint4& b,
                                         const float* w, uint32_t mask) {
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int q = 0; q < 4; ++q) add_word(word(a, q) & mask, w + 4 * q, acc);
#pragma unroll
    for (int q = 0; q < 4; ++q)
        add_word(word(b, q) & mask, w + 16 + 4 * q, acc);
    float s = (acc[0] + acc[1]) + (acc[2] + acc[3]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    return s;
}

// Warp gw of the grid: tile gw % n_tiles of rows [g * R, g * R + R) with
// g = gw / n_tiles.  part: f32[K, n_tiles] (out itself where n_tiles is 1).
template <bool VEC>
__global__ void __launch_bounds__(WARPS * 32)
    dot_rows_kernel(const uint8_t* __restrict__ vals,
                    const int64_t* __restrict__ keep,
                    const float* __restrict__ y,
                    const uint8_t* __restrict__ hap, float* __restrict__ part,
                    int L, int H, int K, int n_tiles, int R, int haploid) {
    const int lane = threadIdx.x & 31;
    const long long gw = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
    const int tile = (int)(gw % n_tiles);
    const long long g = gw / n_tiles;
    const int k0 = (int)(g * R);
    if (k0 >= K) return;
    const int k1 = min(K, k0 + R);
    const int ca = tile * TILE + lane * 16;       // the lane's two pieces
    const int cb = ca + HALF;
    float w[LANE_BYTES];
#pragma unroll
    for (int j = 0; j < LANE_BYTES; ++j) {
        const int c = (j < 16 ? ca : cb) + (j & 15);
        w[j] = c < H ? __ldg(y + (haploid ? c : c >> 1)) : 0.f;
    }
    const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
    for (int k = k0; k < k1; k += 2) {
        const bool two = k + 1 < k1;
        const int64_t r0 = keep[k];
        const int64_t r1 = two ? keep[k + 1] : 0;
        const bool ok0 = (uint64_t)r0 < (uint64_t)L;
        const bool ok1 = two && (uint64_t)r1 < (uint64_t)L;
        const uint8_t* row0 = vals + (size_t)(ok0 ? r0 : 0) * H;
        const uint8_t* row1 = vals + (size_t)(ok1 ? r1 : 0) * H;
        const uint4 a0 = ok0 ? load16<VEC>(row0, ca, H) : zero;
        const uint4 b0 = ok0 ? load16<VEC>(row0, cb, H) : zero;
        const uint4 a1 = ok1 ? load16<VEC>(row1, ca, H) : zero;
        const uint4 b1 = ok1 ? load16<VEC>(row1, cb, H) : zero;
        const uint32_t m0 = hap && hap[k] ? 0x00FF00FFu : 0xFFFFFFFFu;
        const uint32_t m1 = hap && two && hap[k + 1] ? 0x00FF00FFu
                                                     : 0xFFFFFFFFu;
        const float s0 = row_sum(a0, b0, w, m0);
        const float s1 = row_sum(a1, b1, w, m1);
        if (lane == 0) {
            part[(size_t)k * n_tiles + tile] = ok0 ? s0 : __int_as_float(
                0x7fc00000);
            if (two)
                part[(size_t)(k + 1) * n_tiles + tile] =
                    ok1 ? s1 : __int_as_float(0x7fc00000);
        }
    }
}

// out[k] = the sum of part[k, :], a warp a row: lane l adds tiles l, l + 32,
// ... in order, then the warp's butterfly.
__global__ void __launch_bounds__(SUM_WARPS * 32)
    dot_rows_sum_kernel(const float* __restrict__ part,
                        float* __restrict__ out, int K, int n_tiles) {
    const int lane = threadIdx.x & 31;
    const int k = blockIdx.x * SUM_WARPS + (threadIdx.x >> 5);
    if (k >= K) return;
    const float* p = part + (size_t)k * n_tiles;
    float s = 0.f;
    for (int t = lane; t < n_tiles; t += 32) s += p[t];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) out[k] = s;
}

// vals u8[L, H]; keep int64[K]; y f32; hap u8[K] or null; part f32[K,
// n_tiles] scratch with n_tiles = ceil(H / 1024) (unused, and may be null,
// where n_tiles is 1; mirrors ops/product_kernels.py tiles); out f32[K].
// One launch, or two where n_tiles > 1, in stream order; none where K = 0.
extern "C" int xsi_dot_rows(const void* vals, const void* keep,
                            const void* y, const void* hap, void* part,
                            void* out, int L, int H, int K, int haploid,
                            void* stream) {
    if (L < 0 || H < 1 || K < 0) return (int)cudaErrorInvalidValue;
    if (K == 0) return (int)cudaGetLastError();
    const cudaStream_t st = (cudaStream_t)stream;
    const int n_tiles = (H + TILE - 1) / TILE;
    if (n_tiles > 1 && part == nullptr) return (int)cudaErrorInvalidValue;
    float* dst = n_tiles > 1 ? (float*)part : (float*)out;
    int R = MAX_GROUP;
    while (R > MIN_GROUP &&
           (long long)n_tiles * ((K + R - 1) / R) < MIN_WARPS)
        R >>= 1;
    const long long warps = (long long)n_tiles * ((K + R - 1) / R);
    const unsigned blocks = (unsigned)((warps + WARPS - 1) / WARPS);
    const bool vec = H % 16 == 0 && ((uintptr_t)vals & 15) == 0;
    if (vec)
        dot_rows_kernel<true><<<blocks, WARPS * 32, 0, st>>>(
            (const uint8_t*)vals, (const int64_t*)keep, (const float*)y,
            (const uint8_t*)hap, dst, L, H, K, n_tiles, R, haploid);
    else
        dot_rows_kernel<false><<<blocks, WARPS * 32, 0, st>>>(
            (const uint8_t*)vals, (const int64_t*)keep, (const float*)y,
            (const uint8_t*)hap, dst, L, H, K, n_tiles, R, haploid);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess || n_tiles == 1) return (int)e;
    dot_rows_sum_kernel<<<(K + SUM_WARPS - 1) / SUM_WARPS, SUM_WARPS * 32, 0,
                          st>>>((const float*)part, (float*)out, K, n_tiles);
    return (int)cudaGetLastError();
}
