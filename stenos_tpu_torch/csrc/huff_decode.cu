// Anchored Huffman decode (K5) for Hopper (sm_90a), bound through ctypes.
//
// Replaces the TPU kernel stenos_tpu/entropy/huff_decode_pallas.py::
// make_decode_kernel_v6 (v1-v5 are TPU variants with the same output). The
// TPU kernel gathers each segment's window with a one-hot matmul, extracts
// lookaheads with masked sums over 96 window words and maps ranks to symbols
// with a 64-way select, eight streams a grid step. Here: one CTA per 32 KiB
// stream, one thread per 128-symbol segment (256 threads). The stream's
// words and its 304-int table are staged in shared memory. Thread g starts
// at bit anchors[g] and reads the backward bitstream downward, as v6 does:
// one 22-bit lookahead (bits [r - 22, r), zeros below bit 0 and past the
// row) serves two symbols; a code's length is 11 minus the number of
// bounds E_l = (base_l + n_l) << (11 - l) the left-aligned 11-bit window
// reaches, its rank the window's top bits plus a telescoped per-length
// offset, and the rank indexes the (length descending, symbol ascending)
// symbol list (0 for a rank outside it). Four symbols pack into a word of a
// shared staging buffer with a row pitch of 33 words (conflict-free), and
// the 32 KiB leave in coalesced 32-bit stores. Bound: bytes (the bitstreams,
// anchors and tables in, 32 KiB a stream out); the per-symbol chain of
// dependent shared loads and compares is the real limit.

#include <cstdint>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

namespace {

constexpr int kStream = 32768;
constexpr int kSegs = 256;
constexpr int kSeg = kStream / kSegs;  // 128 symbols a segment
constexpr int kTable = 304;
constexpr int kPitch = kSeg / 4 + 1;   // output words a segment, + 1 pad

__global__ void __launch_bounds__(kSegs)
huff_decode(const uint8_t* __restrict__ bytes, long long nbytes,
            const int* __restrict__ anchors, const int* __restrict__ tables,
            uint8_t* __restrict__ out) {
    extern __shared__ uint32_t smem[];
    __shared__ int s_tab[kTable];
    const int nw = (int)(nbytes >> 2);
    uint32_t* s_w = smem;                   // nw words
    uint32_t* s_out = smem + ((nw + 3) & ~3);  // kSegs x kPitch words
    const int g = threadIdx.x;
    const long long s = blockIdx.x;

    const uint32_t* src = reinterpret_cast<const uint32_t*>(bytes + s * nbytes);
    for (int i = g; i < nw; i += kSegs) s_w[i] = src[i];
    for (int i = g; i < kTable; i += kSegs) s_tab[i] = tables[s * kTable + i];
    __syncthreads();

    int E[11], dD[11];
#pragma unroll
    for (int l = 0; l < 11; ++l) {
        E[l] = (s_tab[l + 1] + s_tab[13 + l]) << (10 - l);
        dD[l] = s_tab[25 + l] - s_tab[l + 1];  // D_l, differenced below
    }
    const int d_top = dD[10];
#pragma unroll
    for (int l = 10; l >= 1; --l) dD[l] -= dD[l - 1];

    auto word = [&](int i) -> uint32_t { return i < nw ? s_w[i] : 0u; };
    auto classify = [&](int W, int& ln) -> int {
        int cnt = 0, dd = d_top;
#pragma unroll
        for (int l = 0; l < 11; ++l) {
            const int m = W >= E[l];
            cnt += m;
            if (l >= 1) dd -= m * dD[l];
        }
        ln = 11 - cnt;
        return (W >> (11 - ln)) + dd;
    };
    auto symbol = [&](int rank) -> uint32_t {
        return (rank >= 0 && rank < 256) ? (uint32_t)s_tab[40 + rank] & 255u : 0u;
    };

    int r = anchors[s * kSegs + g];
    uint32_t* o = s_out + g * kPitch;
    for (int k = 0; k < kSeg / 4; ++k) {
        uint32_t packed = 0;
#pragma unroll
        for (int p = 0; p < 2; ++p) {
            uint32_t W22;
            if (r >= 22) {
                const int lob = r - 22;
                const uint64_t v = ((uint64_t)word((lob >> 5) + 1) << 32) | word(lob >> 5);
                W22 = (uint32_t)(v >> (lob & 31)) & 0x3FFFFFu;
            } else {
                const int rc = r > 0 ? r : 0;
                W22 = (word(0) & ((1u << rc) - 1u)) << (22 - rc);
            }
            int ln0, ln1;
            const int i0 = classify((int)(W22 >> 11), ln0);
            const int i1 = classify((int)((W22 >> (11 - ln0)) & 0x7FFu), ln1);
            packed |= (symbol(i0) | (symbol(i1) << 8)) << (16 * p);
            r -= ln0 + ln1;
        }
        o[k] = packed;
    }
    __syncthreads();
    uint32_t* dst = reinterpret_cast<uint32_t*>(out + s * kStream);
    for (int i = g; i < kStream / 4; i += kSegs) {
        dst[i] = s_out[(i / (kSeg / 4)) * kPitch + i % (kSeg / 4)];
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
    const int nw = (int)(nbytes >> 2);
    const int shared = (((nw + 3) & ~3) + kSegs * kPitch) * 4;
    cudaError_t err = cudaFuncSetAttribute(
        huff_decode, cudaFuncAttributeMaxDynamicSharedMemorySize, shared);
    if (err != cudaSuccess) return (int)err;
    huff_decode<<<(unsigned)ns, kSegs, shared, (cudaStream_t)stream>>>(
        (const uint8_t*)bytes, nbytes, (const int*)anchors, (const int*)tables,
        (uint8_t*)out);
    return (int)cudaGetLastError();
}
#endif
