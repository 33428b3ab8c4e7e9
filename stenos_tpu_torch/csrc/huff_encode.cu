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
// emission order (natural index i at position 32767 - i): thread t walks
// natural bytes [32704 - 64t, 32768 - 64t) backward, twice, reading them
// from memory 16 bytes at a time both times (kept in registers across the
// barriers between the walks, they would cost occupancy). The first walk
// sums the code lengths (a byte table in shared memory); a block-wide
// exclusive scan of the sums gives each thread its first bit offset and
// `total`. The second walk emits, with codes from the 256-entry LUT in
// shared memory: codes gather in a 64-bit register (two codes of at most
// 11 bits between checks) and each completed 32-bit word goes to a
// shared-memory word buffer by a plain store, except the thread's first and
// last words, which it may share with its neighbours: those go by atomicOr,
// and only they, and the end mark's, are zeroed first. The end mark goes at
// bit `total`. The words through the end mark leave in 16-byte stores, and
// the rest of the 12,288-word row as zeros from registers. Anchors: the
// inclusive bit sum at emission index (255 - g)*128 + 127 is the end of
// every second thread's range. Bound: bytes (streams and LUTs in; the 48
// KiB row, anchors and sizes out).
//
// LUT entries are code | len << 11 with len <= 11: a longer length is taken
// as 11 (the encode is then not the plain version's), which keeps every
// write inside the word buffer.

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

// a LUT entry's length, at most 11: the row then holds any stream
__device__ __forceinline__ uint32_t clamp_len(int entry) {
    return min((uint32_t)entry >> 11, 11u);
}

// 16 bytes from device memory, read anew each call: the compiler may not
// keep the first walk's loads in registers for the second
__device__ __forceinline__ uint4 load16(const uint4* p) {
    uint4 v;
    asm volatile("ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
    return v;
}

__global__ void __launch_bounds__(kEncThreads, 3)
huff_encode(const uint8_t* __restrict__ streams, const int* __restrict__ luts,
            int* __restrict__ words, int* __restrict__ sizes,
            int* __restrict__ anchors) {
    extern __shared__ __align__(16) uint32_t s_words[];  // kWords
    __shared__ uint32_t s_lut[256];
    __shared__ uint8_t s_len[256];
    __shared__ int s_warp[kEncWarps];
    const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
    const long long s = blockIdx.x;

    // natural bytes [kStream - kPer*(t+1), kStream - kPer*t): byte j of the
    // range is emitted at position kPer*t + kPer - 1 - j; both walks read
    // them from memory 16 bytes at a time, the last 16 first
    const uint4* src = reinterpret_cast<const uint4*>(
        streams + s * kStream + kStream - kPer * (t + 1));
    // the first walk's loads go out before the LUT is staged and the barrier
    uint4 q[kPerVec];
#pragma unroll
    for (int v = 0; v < kPerVec; ++v) q[v] = load16(src + v);
    if (t < 256) {
        const int e = luts[s * 256 + t];
        s_lut[t] = ((uint32_t)e & 2047u) | clamp_len(e) << 11;
        s_len[t] = (uint8_t)clamp_len(e);
    }
    __syncthreads();

    int sum = 0;
#pragma unroll
    for (int v = 0; v < kPerVec; ++v) {
        const uint32_t w[4] = {q[v].x, q[v].y, q[v].z, q[v].w};
#pragma unroll
        for (int j = 0; j < 16; ++j) {
            const uint32_t c = (w[j >> 2] >> (8 * (j & 3))) & 255u;
            sum += s_len[c];
        }
    }

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
    // the words this thread may share: its first and last, and the end
    // mark's; every other word it writes is its own
    const int first = excl >> 5, last = (excl + sum - 1) >> 5;
    if (sum) {
        s_words[first] = 0;
        s_words[last] = 0;
    }
    if (t == kEncThreads - 1) s_words[total >> 5] = 0;
    __syncthreads();

    // codes gather in acc from bit fill on; acc's bit 0 is bit 32 cw. The
    // next 16 bytes load while these are emitted. The first word, which the
    // thread before may share, is kept in fw and goes out by atomicOr below
    int cw = first, fill = excl & 31;
    uint64_t acc = 0;
    uint32_t fw = 0;
    uint4 nq = load16(src + kPerVec - 1);
#pragma unroll 1
    for (int v = kPerVec - 1; v >= 0; --v) {
        const uint32_t w[4] = {nq.x, nq.y, nq.z, nq.w};
        if (v) nq = load16(src + v - 1);
#pragma unroll
        for (int j = 15; j >= 0; j -= 2) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const uint32_t a =
                    s_lut[(w[(j - h) >> 2] >> (8 * ((j - h) & 3))) & 255u];
                acc |= (uint64_t)(a & 2047u) << fill;
                fill += a >> 11;
            }
            if (fill >= 32) {  // at most 53 bits: one word completes
                // past the first, a complete word is all this thread's
                const uint32_t lo = (uint32_t)acc;
                if (cw == first) fw = lo;
                else s_words[cw] = lo;
                acc >>= 32;
                fill -= 32;
                ++cw;
            }
        }
    }
    if (fw) atomicOr(&s_words[first], fw);
    if (sum && fill) atomicOr(&s_words[cw], (uint32_t)acc);  // the last word
    // every second thread ends a 128-symbol segment: g = 255 - t/2
    if (t & 1) anchors[s * kSegs + kSegs - 1 - (t >> 1)] = excl + sum;
    if (t == kEncThreads - 1) {
        atomicOr(&s_words[total >> 5], 1u << (total & 31));
        sizes[s] = (total + 8) >> 3;
    }
    __syncthreads();
    // the words through the end mark's, then zeros
    const int nlast = total >> 5;
    uint4* dst = reinterpret_cast<uint4*>(words + s * kWords);
    const uint4* sw4 = reinterpret_cast<const uint4*>(s_words);
    for (int i = t; i < kWords / 4; i += kEncThreads) {
        uint4 v = make_uint4(0, 0, 0, 0);
        if (4 * i + 3 <= nlast) {
            v = sw4[i];
        } else if (4 * i <= nlast) {
            v.x = s_words[4 * i];
            if (4 * i + 1 <= nlast) v.y = s_words[4 * i + 1];
            if (4 * i + 2 <= nlast) v.z = s_words[4 * i + 2];
        }
        dst[i] = v;
    }
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
