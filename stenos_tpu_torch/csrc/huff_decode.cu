// Anchored Huffman decode (K5) for Hopper (sm_90a), bound through ctypes.
//
// Replaces the TPU kernel stenos_tpu/entropy/huff_decode_pallas.py::
// make_decode_kernel_v6 (v1-v5 are TPU variants with the same output). The
// TPU kernel gathers each segment's window with a one-hot matmul, extracts
// lookaheads with masked sums over 96 window words, finds each code's length
// with 11 compares against the per-length bounds (a gather is dear there)
// and maps ranks to symbols with a 64-way select, eight streams a grid step.
//
// Here a code is decoded by table. One CTA per 32 KiB stream, one thread per
// 128-symbol segment (256 threads). The CTA first builds a 2^11-entry
// lookup in shared memory from the stream's 304-int table: entry W (the
// left-aligned 11-bit window) holds v6's symbol and length for W, computed
// with v6's arithmetic (a code's length is 11 minus the number of bounds
// E_l = (base_l + n_l) << (11 - l) that W reaches, its rank W's top bits
// plus a telescoped per-length offset, the symbol the rank's entry of the
// (length descending, symbol ascending) list, 0 for a rank outside it), so
// any table, valid or not, decodes as v6 decodes it. A thread builds 8
// entries: the bounds of lengths 1-8 are multiples of 8, so their compares
// are made once for the 8. The row's words that the anchors can reach (up
// to the largest anchor) are staged in shared memory beside it.
//
// Thread g then reads the backward bitstream downward from bit anchors[g],
// keeping bits [base, base + 64) of the row in a 64-bit register window
// (base a multiple of 32) refilled 32 bits at a time, the next word loaded
// one refill ahead. Each symbol is one 11-bit peek at bits [r - 11, r), one
// shared load, one extract and one subtract. v6 reads two symbols from one
// 22-bit lookahead; since a length is at most 11, the second symbol's window
// is the 11 bits below the first code, which is the fresh peek at the new
// position: the same bits, bits below bit 0 and past the row reading as
// zeros in both. A thread's 128 output bytes are contiguous: every 32
// symbols, neighbouring lanes trade 16 bytes with a shuffle and each stores
// 16, so that a warp's store fills whole 32-byte sectors (each lane storing
// its own 16 bytes at a 128-byte stride took a fifth longer). Bound: bytes
// (the bitstreams, anchors and tables in, 32 KiB a stream out); the
// per-symbol chain (peek, shared load, subtract) is left to the other warps
// of the SM to hide (40 registers, six CTAs an SM).

#include <cstdint>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

namespace {

constexpr int kStream = 32768;
constexpr int kSegs = 256;
constexpr int kSeg = kStream / kSegs;  // 128 symbols a segment
constexpr int kTable = 304;
constexpr int kLut = 2048;             // 11-bit windows
constexpr int kPer = kLut / kSegs;     // lookup entries a thread builds

// the lookup entries [8g, 8g + 8) of the stream's table: symbol | length << 8
__device__ __forceinline__ void build_lut(const int* s_tab, int g,
                                          uint16_t* s_lut) {
    int E[11], dD[11];
#pragma unroll
    for (int l = 0; l < 11; ++l) {
        E[l] = (s_tab[l + 1] + s_tab[13 + l]) << (10 - l);
        dD[l] = s_tab[25 + l] - s_tab[l + 1];  // D_l, differenced below
    }
    const int d_top = dD[10];
#pragma unroll
    for (int l = 10; l >= 1; --l) dD[l] -= dD[l - 1];
    const int W0 = g * kPer;
    // lengths 1-8 (l <= 7): E_l is a multiple of 8, so W0 .. W0 + 7 agree
    int cnt0 = 0, dd0 = d_top;
#pragma unroll
    for (int l = 0; l < 8; ++l) {
        const int m = W0 >= E[l];
        cnt0 += m;
        if (l >= 1) dd0 -= m * dD[l];
    }
    uint32_t packed[kPer / 2];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
        const int W = W0 + k;
        int cnt = cnt0, dd = dd0;
#pragma unroll
        for (int l = 8; l < 11; ++l) {
            const int m = W >= E[l];
            cnt += m;
            dd -= m * dD[l];
        }
        const int ln = 11 - cnt;
        const int rank = (W >> (11 - ln)) + dd;
        const uint32_t sym =
            (rank >= 0 && rank < 256) ? (uint32_t)s_tab[40 + rank] & 255u : 0u;
        const uint32_t e = sym | (uint32_t)ln << 8;
        if (k & 1) packed[k >> 1] |= e << 16;
        else packed[k >> 1] = e;
    }
    *reinterpret_cast<uint4*>(s_lut + W0) =
        make_uint4(packed[0], packed[1], packed[2], packed[3]);
}

// word i of the staged row, 0 outside [0, n)
__device__ __forceinline__ uint32_t staged(const uint32_t* s_w, int n, int i) {
    return (unsigned)i < (unsigned)n ? s_w[i] : 0u;
}

__global__ void __launch_bounds__(kSegs, 6)
huff_decode(const uint8_t* __restrict__ bytes, long long nbytes,
            const int* __restrict__ anchors, const int* __restrict__ tables,
            uint8_t* __restrict__ out) {
    extern __shared__ __align__(16) uint32_t s_w[];  // the row's staged words
    __shared__ __align__(16) uint16_t s_lut[kLut];
    __shared__ int s_tab[kTable];
    __shared__ int s_max[kSegs / 32];
    const int g = threadIdx.x;
    const long long s = blockIdx.x;
    const int nw = (int)(nbytes >> 2);

    for (int i = g; i < kTable; i += kSegs) s_tab[i] = tables[s * kTable + i];
    // below bit 0 every window is zero: clamping keeps r - 11 - 1408 in range
    const int r0 = max(anchors[s * kSegs + g], -32);
    const int m = __reduce_max_sync(0xffffffffu, r0);
    if ((g & 31) == 0) s_max[g >> 5] = m;
    __syncthreads();

    // stage the words holding bits below the largest anchor: no read of a
    // segment reaches above its anchor
    int mx = s_max[0];
#pragma unroll
    for (int w = 1; w < kSegs / 32; ++w) mx = max(mx, s_max[w]);
    const int n_st = mx <= 0 ? 0 : min(nw, (mx >> 5) + 1);
    const uint8_t* row = bytes + s * nbytes;
    if ((reinterpret_cast<uintptr_t>(row) & 15) == 0) {
        const uint4* src4 = reinterpret_cast<const uint4*>(row);
        uint4* dst4 = reinterpret_cast<uint4*>(s_w);
        for (int i = g; i < n_st >> 2; i += kSegs) dst4[i] = src4[i];
        for (int i = (n_st & ~3) + g; i < n_st; i += kSegs)
            s_w[i] = reinterpret_cast<const uint32_t*>(row)[i];
    } else {
        const uint32_t* src = reinterpret_cast<const uint32_t*>(row);
        for (int i = g; i < n_st; i += kSegs) s_w[i] = src[i];
    }
    build_lut(s_tab, g, s_lut);
    __syncthreads();

    // the window holds bits [32 b, 32 b + 64), b = nx + 1; pos = r - 11 -
    // 32 b is the shift of the 11-bit peek at bits [r - 11, r): a pair of
    // symbols starts at 11 <= pos <= 42 (22 bits or more below r), so every
    // peek has 0 <= pos <= 42. nxt is word nx, loaded one refill ahead.
    int nx = ((r0 - 11) >> 5) - 1;
    int pos = (r0 - 11) & 31;
    uint64_t win = ((uint64_t)staged(s_w, n_st, nx + 2) << 32)
                   | staged(s_w, n_st, nx + 1);
    uint32_t nxt = staged(s_w, n_st, nx);
    // 32 symbols a step; lanes g and g ^ 1 then trade halves, so that each
    // 16-byte store of a pair of lanes fills one 32-byte sector of a segment
    const int odd = g & 1;
    uint8_t* o = out + s * kStream + odd * 16;
#pragma unroll 1
    for (int c = 0; c < kSeg / 32; ++c) {
        uint32_t q[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) {
            uint32_t packed = 0;
#pragma unroll
            for (int p = 0; p < 2; ++p) {
                if (pos < 11) {  // at least 22 bits below r before each pair
                    win = (win << 32) | nxt;
                    pos += 32;
                    nxt = staged(s_w, n_st, --nx);
                }
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const uint32_t e = s_lut[(uint32_t)(win >> pos) & 2047u];
                    packed |= (e & 255u) << (16 * p + 8 * h);
                    pos -= (int)(e >> 8);
                }
            }
            q[k] = packed;
        }
        // q[0..3]: bytes [32c, 32c + 16) of the segment, q[4..7] the next 16
        uint32_t x[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
            x[i] = __shfl_xor_sync(0xffffffffu, odd ? q[i] : q[4 + i], 1);
        const uint4 mine = odd ? make_uint4(q[4], q[5], q[6], q[7])
                               : make_uint4(q[0], q[1], q[2], q[3]);
        const uint4 theirs = make_uint4(x[0], x[1], x[2], x[3]);
        *reinterpret_cast<uint4*>(o + (g & ~1) * kSeg + 32 * c) =
            odd ? theirs : mine;
        *reinterpret_cast<uint4*>(o + (g | 1) * kSeg + 32 * c) =
            odd ? mine : theirs;
    }
}

}  // namespace

#ifdef __CUDACC__
// C interface (ctypes). Pointers are device pointers (bytes 4-byte aligned,
// nbytes a multiple of 4, at most 49,152); the launch goes on `stream`; the
// return value is the first CUDA error of the call (0 when none).
extern "C" int stenos_huff_decode(const void* bytes, long long nbytes,
                                  const void* anchors, const void* tables,
                                  long long ns, void* out, void* stream) {
    const int shared = (int)(nbytes & ~3LL);
    cudaError_t err = cudaFuncSetAttribute(
        huff_decode, cudaFuncAttributeMaxDynamicSharedMemorySize, shared);
    if (err != cudaSuccess) return (int)err;
    huff_decode<<<(unsigned)ns, kSegs, shared, (cudaStream_t)stream>>>(
        (const uint8_t*)bytes, nbytes, (const int*)anchors, (const int*)tables,
        (uint8_t*)out);
    return (int)cudaGetLastError();
}
#endif
