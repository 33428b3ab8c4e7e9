// Huffman byte histogram (K3) and huff0 stream encode with decode anchors
// (K4) for Hopper (sm_90a), bound through ctypes.
//
// K3 replaces the TPU kernel in stenos_tpu/entropy/huff_pallas.py::_hist_call
// (a 256-pass compare-and-sum over each block). Here: one CTA per 128 KiB
// block, 16-byte loads, one shared-memory sub-histogram per warp filled with
// shared atomics, then one thread per bin sums the warps' counts. Bound:
// bytes (each block read once, 1 KiB of counts written); skewed data makes
// lanes of a warp collide on one bin, which serialises those atomics.
//
// K4 replaces huff_pallas.py::make_stream_kernel. The TPU kernel reverses
// the symbols with anti-identity matmuls, looks codes up with a 256-pass
// select, and builds words with a segmented OR and a log-shift compaction.
// Here: one CTA per 32 KiB stream, 512 threads of 64 symbols each, in
// emission order (natural index i at position 32767 - i): thread t loads
// natural bytes [32704 - 64t, 32768 - 64t) straight into registers (four
// 16-byte loads) and walks them backward. A block-wide exclusive scan of the
// threads' length sums gives each thread its first bit offset. Each code ORs
// code << (off & 31) into word off >> 5 and (code >> 1) >> (31 - (off & 31))
// (no shift by 32) into the next; a thread keeps the word it is filling and
// the next one in registers and ORs them into a zeroed 48 KiB shared-memory
// word buffer when it moves on (a code of at most 11 bits moves at most one
// word), so only the words at its ends are shared with a neighbour. The end
// mark goes at bit `total`, then all 12,288 words go out (zeros past the
// stream). Anchors: the inclusive bit sum at emission index
// (255 - g)*128 + 127 is the end of every second thread's range. Bound:
// bytes (streams and LUTs in, sum of sizes + anchors + sizes out).
//
// LUT entries are code | len << 11 with len <= 11; longer lengths are not
// encoded, and every shared-memory write stays inside the word buffer.

#include <cstdint>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

namespace {

constexpr int kBlock = 131072;
constexpr int kStream = 32768;
constexpr int kWords = 96 * 128;  // output words per stream
constexpr int kSegs = 256;

constexpr int kHistThreads = 512;
constexpr int kHistWarps = kHistThreads / 32;

__global__ void __launch_bounds__(kHistThreads)
huff_histogram(const uint8_t* __restrict__ blocks, int* __restrict__ hist) {
    __shared__ unsigned s_h[kHistWarps][256];
    const int t = threadIdx.x;
    for (int i = t; i < kHistWarps * 256; i += kHistThreads) (&s_h[0][0])[i] = 0;
    __syncthreads();
    const uint4* src = reinterpret_cast<const uint4*>(
        blocks + (long long)blockIdx.x * kBlock);
    unsigned* h = s_h[t >> 5];
    for (int i = t; i < kBlock / 16; i += kHistThreads) {
        const uint4 v = src[i];
        const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int k = 0; k < 16; ++k) atomicAdd(&h[(w[k >> 2] >> (8 * (k & 3))) & 255], 1u);
    }
    __syncthreads();
    if (t < 256) {
        unsigned c = 0;
#pragma unroll
        for (int w = 0; w < kHistWarps; ++w) c += s_h[w][t];
        hist[(long long)blockIdx.x * 256 + t] = (int)c;
    }
}

constexpr int kEncThreads = 512;
constexpr int kEncWarps = kEncThreads / 32;
constexpr int kPer = kStream / kEncThreads;  // 64 symbols a thread
constexpr int kPerVec = kPer / 16;           // 16-byte loads a thread
constexpr int kEncShared = kWords * 4;       // the word buffer, dynamic

__device__ __forceinline__ int sym_at(const uint32_t (&w)[kPer / 4], int j) {
    return (w[j >> 2] >> (8 * (j & 3))) & 255;
}

__device__ __forceinline__ void or_word(uint32_t* s_words, int i, uint32_t v) {
    if (v && i >= 0 && i < kWords) atomicOr(&s_words[i], v);
}

__global__ void __launch_bounds__(kEncThreads)
huff_encode(const uint8_t* __restrict__ streams, const int* __restrict__ luts,
            int* __restrict__ words, int* __restrict__ sizes,
            int* __restrict__ anchors) {
    extern __shared__ uint32_t s_words[];
    __shared__ int s_lut[256];
    __shared__ int s_warp[kEncWarps];
    const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
    const long long s = blockIdx.x;

    uint4* sw4 = reinterpret_cast<uint4*>(s_words);
    for (int i = t; i < kWords / 4; i += kEncThreads) sw4[i] = make_uint4(0, 0, 0, 0);
    if (t < 256) s_lut[t] = luts[s * 256 + t];
    // natural bytes [kStream - kPer*(t+1), kStream - kPer*t): byte j of the
    // range is emitted at position kPer*t + kPer - 1 - j
    const uint4* src = reinterpret_cast<const uint4*>(
        streams + s * kStream + kStream - kPer * (t + 1));
    uint32_t w[kPer / 4];
#pragma unroll
    for (int v = 0; v < kPerVec; ++v) {
        const uint4 q = src[v];
        w[4 * v] = q.x; w[4 * v + 1] = q.y; w[4 * v + 2] = q.z; w[4 * v + 3] = q.w;
    }
    __syncthreads();

    int sum = 0;
#pragma unroll
    for (int j = kPer - 1; j >= 0; --j) sum += s_lut[sym_at(w, j)] >> 11;

    // block-wide scan of the threads' sums, in emission order (= t order)
    int x = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, x, o);
        if (lane >= o) x += y;
    }
    if (lane == 31) s_warp[warp] = x;
    __syncthreads();
    if (warp == 0) {
        int y = lane < kEncWarps ? s_warp[lane] : 0;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const int z = __shfl_up_sync(0xffffffffu, y, o);
            if (lane >= o) y += z;
        }
        if (lane < kEncWarps) s_warp[lane] = y;
    }
    __syncthreads();
    const int excl = x - sum + (warp ? s_warp[warp - 1] : 0);
    const int total = s_warp[kEncWarps - 1];

    int off = excl;
    int cw = off >> 5;
    uint32_t cur = 0, nxt = 0;
#pragma unroll
    for (int j = kPer - 1; j >= 0; --j) {
        const int a = s_lut[sym_at(w, j)];
        const uint32_t code = (uint32_t)a & 2047u;
        const int w0 = off >> 5;
        if (w0 != cw) {  // moved on: the word before is complete here
            or_word(s_words, cw, cur);
            if (w0 == cw + 1) {
                cur = nxt;
            } else {
                or_word(s_words, cw + 1, nxt);
                cur = 0;
            }
            nxt = 0;
            cw = w0;
        }
        const int sh = off & 31;
        cur |= code << sh;
        nxt |= (code >> 1) >> (31 - sh);
        off += a >> 11;
    }
    or_word(s_words, cw, cur);
    or_word(s_words, cw + 1, nxt);
    // every second thread ends a 128-symbol segment: g = 255 - t/2
    if (t & 1) anchors[s * kSegs + kSegs - 1 - (t >> 1)] = off;
    __syncthreads();
    if (t == 0) {
        or_word(s_words, total >> 5, 1u << (total & 31));
        sizes[s] = (total + 8) >> 3;
    }
    __syncthreads();
    uint4* dst = reinterpret_cast<uint4*>(words + s * kWords);
    for (int i = t; i < kWords / 4; i += kEncThreads) dst[i] = sw4[i];
}

}  // namespace

#ifdef __CUDACC__
// C interface (ctypes). Pointers are device pointers (blocks and streams
// 16-byte aligned); the launch goes on `stream`; the return value is the
// first CUDA error of the call (0 when none).
extern "C" int stenos_huff_histogram(const void* blocks, long long nblk,
                                     void* hist, void* stream) {
    huff_histogram<<<(unsigned)nblk, kHistThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)blocks, (int*)hist);
    return (int)cudaGetLastError();
}

extern "C" int stenos_huff_encode(const void* streams, const void* luts,
                                  long long ns, void* words, void* sizes,
                                  void* anchors, void* stream) {
    cudaError_t err = cudaFuncSetAttribute(
        huff_encode, cudaFuncAttributeMaxDynamicSharedMemorySize, kEncShared);
    if (err != cudaSuccess) return (int)err;
    huff_encode<<<(unsigned)ns, kEncThreads, kEncShared, (cudaStream_t)stream>>>(
        (const uint8_t*)streams, (const int*)luts, (int*)words, (int*)sizes,
        (int*)anchors);
    return (int)cudaGetLastError();
}
#endif
