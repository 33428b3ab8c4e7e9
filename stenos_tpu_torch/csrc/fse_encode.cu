// zstd sequence-section FSE encode (K6) for Hopper (sm_90a), bound through
// ctypes.
//
// Replaces the TPU kernel stenos_tpu/entropy/fse_pallas.py::make_fse_kernel.
// The TPU kernel runs 128 blocks side by side, one per vector lane: it walks
// the three FSE state machines with one-of-64 and one-of-512 masked-sum
// table selects, writes every (value, nbits) chunk into a row of scratch,
// and assembles the bits with a cumsum, a log-doubling segmented OR and a
// log-shift compaction over the rows. Its bucket of at most 2560 sequences
// a block was a VMEM limit. Here: one thread per block, any number of
// sequences. The thread walks its sequences from the last to the first and
// appends each chunk to a 64-bit accumulator that leaves in little-endian
// 32-bit words, in BitWriter order (stenos_tpu/entropy/fse.py): the last
// sequence's LL, ML, OF extra bits; per earlier sequence the OF, ML and LL
// state chunks (the state's low nb bits, nb = (state + dnb[sym]) >> 16,
// next state stt[(state >> nb) + dfs[sym]]) and its LL, ML, OF extra bits;
// the ML, OF and LL states in table_log bits each; one terminator bit.
//
// Bound: bytes (the sequences' codes and extra bits and the tables in, the
// bitstream out). The real limit is the serial state chain of one thread a
// block, its table loads from the L1 cache.

#include <cstdint>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

namespace {

constexpr int kSym = 64;      // dnb, dfs entries a channel
constexpr int kStates = 512;  // state-table entries a channel
constexpr int kChan = 2 * kSym + kStates;
constexpr int kCols = 8;      // ll_sym, ml_sym, of_sym, ll_x, ml_x, of_x, ll_nb, ml_nb
constexpr int kMeta = 8;      // seq_off, nseq, word_off, word_cap, tl_ll, tl_ml, tl_of, 0

struct BitSink {
    uint32_t* out;
    long long cap, n;  // words
    uint64_t acc;
    int nacc;
    long long bits;

    __device__ void put(uint32_t v, int nb) {
        if (nb <= 0) return;
        acc |= (uint64_t)(v & (uint32_t)((1ull << nb) - 1)) << nacc;
        nacc += nb;
        bits += nb;
        if (nacc >= 32) {
            if (n < cap) out[n] = (uint32_t)acc;
            ++n;
            acc >>= 32;
            nacc -= 32;
        }
    }
};

__device__ __forceinline__ int clamp_state(int i) {
    return i < 0 ? 0 : (i >= kStates ? kStates - 1 : i);
}

__device__ __forceinline__ int clamp_sym(int s) {
    return s < 0 ? 0 : (s >= kSym ? kSym - 1 : s);
}

__global__ void __launch_bounds__(32)
fse_encode(const int* __restrict__ seqs, const int* __restrict__ tabs,
           const long long* __restrict__ meta, long long nblk,
           int* __restrict__ words, long long* __restrict__ bits_out) {
    const long long b = (long long)blockIdx.x * 32 + threadIdx.x;
    if (b >= nblk) return;
    const long long* m = meta + b * kMeta;
    const int* sq = seqs + m[0] * kCols;
    const long long n = m[1];
    const int* tab = tabs + b * 3 * kChan;  // channels LL, ML, OF
    BitSink bw{reinterpret_cast<uint32_t*>(words) + m[2], m[3], 0, 0, 0, 0};
    if (n <= 0) {
        bits_out[b] = 0;
        return;
    }

    auto init = [&](int ch, int sym) {
        const int* t = tab + ch * kChan;
        const int dnb = t[clamp_sym(sym)], dfs = t[kSym + clamp_sym(sym)];
        const int nb0 = (dnb + (1 << 15)) >> 16;
        const int v = (nb0 << 16) - dnb;
        return t[2 * kSym + clamp_state((int)((uint32_t)v >> nb0) + dfs)];
    };
    auto enc = [&](int ch, int state, int sym) {
        const int* t = tab + ch * kChan;
        const int dnb = t[clamp_sym(sym)], dfs = t[kSym + clamp_sym(sym)];
        const int nb = (state + dnb) >> 16;
        bw.put((uint32_t)state, nb);
        return t[2 * kSym + clamp_state((int)((uint32_t)state >> nb) + dfs)];
    };

    const int* last = sq + (n - 1) * kCols;
    int s_ll = init(0, last[0]);
    int s_ml = init(1, last[1]);
    int s_of = init(2, last[2]);
    bw.put((uint32_t)last[3], last[6]);
    bw.put((uint32_t)last[4], last[7]);
    bw.put((uint32_t)last[5], last[2]);
    for (long long i = n - 2; i >= 0; --i) {
        const int* s = sq + i * kCols;
        s_of = enc(2, s_of, s[2]);
        s_ml = enc(1, s_ml, s[1]);
        s_ll = enc(0, s_ll, s[0]);
        bw.put((uint32_t)s[3], s[6]);
        bw.put((uint32_t)s[4], s[7]);
        bw.put((uint32_t)s[5], s[2]);
    }
    bw.put((uint32_t)s_ml, (int)m[5]);
    bw.put((uint32_t)s_of, (int)m[6]);
    bw.put((uint32_t)s_ll, (int)m[4]);
    bw.put(1u, 1);
    if (bw.nacc > 0) {
        if (bw.n < bw.cap) bw.out[bw.n] = (uint32_t)bw.acc;
        ++bw.n;
    }
    // more words than the caller's capacity: report -1
    bits_out[b] = bw.n > bw.cap ? -1 : bw.bits;
}

}  // namespace

#ifdef __CUDACC__
// C interface (ctypes). Pointers are device pointers: seqs (N, 8) int32,
// tabs (nblk, 3, 640) int32, meta (nblk, 8) int64, the int32 words at each
// block's word_off and bits (nblk,) int64. The launch goes on `stream`; the
// return value is the first CUDA error of the call (0 when none).
extern "C" int stenos_fse_encode(const void* seqs, const void* tabs,
                                 const void* meta, long long nblk, void* words,
                                 void* bits, void* stream) {
    fse_encode<<<(unsigned)((nblk + 31) / 32), 32, 0, (cudaStream_t)stream>>>(
        (const int*)seqs, (const int*)tabs, (const long long*)meta, nblk,
        (int*)words, (long long*)bits);
    return (int)cudaGetLastError();
}
#endif
