// zstd sequence-section FSE encode (K6) for Hopper (sm_90a), bound through
// ctypes.
//
// Replaces the TPU kernel stenos_tpu/entropy/fse_pallas.py::make_fse_kernel.
// The TPU kernel runs 128 blocks side by side, one per vector lane: it walks
// the three FSE state machines with one-of-64 and one-of-512 masked-sum
// table selects, writes every (value, nbits) chunk into a row of scratch,
// and assembles the bits with a cumsum, a log-doubling segmented OR and a
// log-shift compaction over the rows. Its bucket of at most 2560 sequences
// a block was a VMEM limit. Only its output is kept here.
//
// The bitstream, in BitWriter order (stenos_tpu/entropy/fse.py), walks the
// sequences from the last to the first (step t codes sequence n - 1 - t):
// step 0 sets the three states from the last sequence's codes and writes
// its LL, ML, OF extra bits; each later step writes the OF, ML and LL state
// chunks (the state's low nb bits, nb = (state + dnb[sym]) >> 16, next state
// stt[(state >> nb) + dfs[sym]]) and its LL, ML, OF extra bits; then the
// ML, OF and LL states in table_log bits each and one terminator bit.
//
// One CTA of 512 threads a block, the walk cut into segments of at least
// kMinSeg steps, one a thread. The state chains are serial, so they are
// broken at sync points: a symbol whose table index (state >> nb) + dfs is
// the same from every state of the channel's range [2^tl, 2^(tl+1)) -- nb
// and state >> nb equal at both ends of the range, which holds for the
// symbols of normalized count 1 or -1 (and every symbol of an RLE channel,
// whose state stays 0). After one the state is known without the steps
// before. Four passes:
//   A1  stage the segment's codes (checked, packed in 32 bits) in shared
//       memory and walk each channel from the segment's first sync point to
//       its end: its exit state.
//   A2  each run of segments with no sync point in a channel is walked by
//       one thread from the exit state before it (a channel with no sync
//       point at all: one serial walk of the block, the worst case).
//   B1  walk each segment from its entry state, the exit state A1 or A2
//       gave the segment before, count its bits and check that the walk
//       ends at the exit state they gave this one (so every entry state is
//       exact, never a wrong bit), that every state lies in its range and
//       every table index in the table (the walks' index mask is then the
//       plain version's clamp); else the call reports -2. A CTA scan gives
//       each segment's bit offset.
//   B2  walk again and emit through a 64-bit accumulator: plain stores for
//       the words the thread owns, atomicOr for its first and last, which it
//       shares with its neighbours (the caller zeroes the words).
// Tables, the sync table, exit states, bit counts and the packed codes live
// in shared memory. A block holds at most kStage sequences (else -2): a zstd
// block of 128 KiB holds at most 43,690 (three bytes a sequence at least),
// the most encode_sequences_device_batch is given for one.
//
// Bound: on text blocks the longest sync-free run, walked serially in A2
// (one dependent shared-memory load and four integer operations a step);
// the bytes (the rows and tables in, the bitstream out) take far less
// (PERF.md).

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
constexpr int kMaxLog = 9;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMinSeg = 8;     // steps a segment at least
constexpr int kChunk = 8;      // steps of A2's walk a table load ahead
constexpr int kStage = 49152;  // sequences a block at most (else -2)
constexpr long long kOverCap = -1;   // bits_out: more words than word_cap
constexpr long long kBadInput = -2;  // bits_out: an input out of range

struct Smem {
    int2 nbfs[3][kSym];  // (dnb, dfs) by channel LL, ML, OF
    int stt[3][kStates];
    int2 a2[3][kSym];     // A2's (dnb, shared address of stt_a2 + 4 dfs)
    int stt_a2[3][kStates];  // and its state table, both made safe to read
    int sync[3][kSym];   // the next state after a sync symbol, else -1
    int exit_state[3][kThreads];  // by segment, -1 while unknown
    int run[3 * kThreads];        // A2's runs: channel * kThreads + segment
    long long seg_bits[kWarps];   // the warps' sums for the scan
    int nrun, bad;
    uint32_t code[kStage];  // by step: packed codes (pack())
};

// a row's codes and extra-bit counts in 32 bits: ll_sym, ml_sym, of_sym (6
// bits each), ll_nb, ml_nb (6 bits each); bad when one is out of range
__device__ __forceinline__ uint32_t pack(const int* row, bool& bad) {
    const int4 a = __ldg(reinterpret_cast<const int4*>(row));
    const int4 b = __ldg(reinterpret_cast<const int4*>(row) + 1);
    bad |= (uint32_t)a.x >= kSym || (uint32_t)a.y >= kSym ||
           (uint32_t)a.z >= 32u || (uint32_t)b.z > 32u || (uint32_t)b.w > 32u;
    return ((uint32_t)a.x & 63) | ((uint32_t)a.y & 63) << 6 |
           ((uint32_t)a.z & 63) << 12 | ((uint32_t)b.z & 63) << 18 |
           ((uint32_t)b.w & 63) << 24;
}

__device__ __forceinline__ int sym_of(uint32_t c, int ch) {
    return (c >> (6 * ch)) & 63;
}

__device__ __forceinline__ int extra_bits(uint32_t c) {
    return ((c >> 12) & 63) + ((c >> 18) & 63) + ((c >> 24) & 63);
}

__device__ __forceinline__ int clamp_state(int i) {
    return min(max(i, 0), kStates - 1);
}

__device__ __forceinline__ int init_state(const Smem& sm, int ch, int sym) {
    const int2 d = sm.nbfs[ch][sym];
    const int nb0 = (d.x + (1 << 15)) >> 16;
    const int v = (nb0 << 16) - d.x;
    return sm.stt[ch][clamp_state((int)((uint32_t)v >> nb0) + d.y)];
}

// the three initial states from step 0's codes
__device__ __forceinline__ void init_states(const Smem& sm, uint32_t c,
                                            int* s) {
    for (int ch = 0; ch < 3; ++ch) s[ch] = init_state(sm, ch, sym_of(c, ch));
}

// one state step: nb, and the table index (B1 checks it lies in the table,
// so the mask is the plain version's clamp)
__device__ __forceinline__ int step(const int2* nbfs, const int* stt, int s,
                                    int sym, int& nb, int& idx) {
    const int2 d = nbfs[sym];
    nb = (s + d.x) >> 16;
    idx = (int)((uint32_t)s >> nb) + d.y;
    return stt[idx & (kStates - 1)];
}

__device__ __forceinline__ int step(const int2* nbfs, const int* stt, int s,
                                    int sym) {
    int nb, idx;
    return step(nbfs, stt, s, sym, nb, idx);
}

// one step of A2's walk: nb = (s + dnb) >> 16, then one shared load at
// (s >> nb) * 4 + the address of stt_a2 + 4 dfs: four integer operations
__device__ __forceinline__ int a2_step(int s, int2 d) {
    const int nb = (s + d.x) >> 16;
    int v;
    asm("ld.shared.u32 %0, [%1];"
        : "=r"(v) : "r"(((uint32_t)s >> nb) * 4u + (uint32_t)d.y));
    return v;
}

// A2's walk of a sync-free run of channel ch from segment j on, kChunk
// steps at a time with the next chunk's table entries loaded meanwhile;
// each segment's exit stored after the chunk it ends in, whether the run
// goes on read a segment ahead. Only the last segment is shorter than
// kChunk, so a chunk ends at most one segment and the block. The channel
// is a value, not a template argument: a warp's runs of all three channels
// walk in step.
__device__ __forceinline__ void walk_run(Smem& sm, int n, int L, int S,
                                         int ch, int j) {
    const int2* a2 = sm.a2[ch];
    int s = sm.exit_state[ch][j - 1] & 1023;
    int end = min(n, (j + 1) * L);
    bool more = j + 1 < S && sm.exit_state[ch][j + 1] < 0;
    int2 d[kChunk], next[kChunk];
#pragma unroll
    for (int k = 0; k < kChunk; ++k)
        d[k] = a2[sym_of(sm.code[min(j * L + k, n - 1)], ch)];
    for (int t = j * L;; t += kChunk) {
#pragma unroll
        for (int k = 0; k < kChunk; ++k)
            next[k] = a2[sym_of(sm.code[min(t + kChunk + k, n - 1)], ch)];
        int at_end = 0, at_n = 0;
#pragma unroll
        for (int k = 0; k < kChunk; ++k) {
            s = a2_step(s, d[k]);
            if (t + k + 1 == end) at_end = s;
            if (t + k + 1 == n) at_n = s;
        }
        while (end <= t + kChunk) {
            sm.exit_state[ch][j] = end == n ? at_n : at_end;
            if (!more) return;
            ++j;
            more = j + 1 < S && sm.exit_state[ch][j + 1] < 0;
            end = min(n, end + L);
        }
#pragma unroll
        for (int k = 0; k < kChunk; ++k) d[k] = next[k];
    }
}

// a thread's bits from bit `off` of the block's words
struct Emit {
    uint32_t* out;
    long long cap, w;  // words
    uint64_t acc;
    int nacc;
    bool shared;  // the next word is shared with the thread before

    __device__ __forceinline__ void store(uint32_t v, bool atomic) {
        if (w < cap) {
            if (atomic) atomicOr(out + w, v);
            else out[w] = v;
        }
        ++w;
    }
    __device__ __forceinline__ void put(uint32_t v, int nb) {
        if (nb <= 0) return;
        acc |= (uint64_t)(v & (uint32_t)((1ull << nb) - 1)) << nacc;
        nacc += nb;
        if (nacc >= 32) {
            store((uint32_t)acc, shared);
            shared = false;
            acc >>= 32;
            nacc -= 32;
        }
    }
    __device__ __forceinline__ void finish() {
        if (nacc > 0) store((uint32_t)acc, true);
    }
};

// a step's extra bits (LL, ML, OF) from its row, after its state chunks
__device__ __forceinline__ void put_extras(Emit& out, const int* row,
                                           uint32_t c) {
    out.put((uint32_t)__ldg(row + 3), (c >> 18) & 63);
    out.put((uint32_t)__ldg(row + 4), (c >> 24) & 63);
    out.put((uint32_t)__ldg(row + 5), (c >> 12) & 63);
}

// one block (one CTA)
__device__ __forceinline__ void encode_block(
        Smem& sm, const int* sq, const long long* m, int n, int* words,
        long long* bits_out) {
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    bool bad = false;
    int tl[3], lo[3], hi[3];
    for (int ch = 0; ch < 3; ++ch) {
        const long long t = m[4 + ch];
        bad |= t < 0 || t > kMaxLog;
        tl[ch] = (int)min(max(t, 0LL), (long long)kMaxLog);
        lo[ch] = tl[ch] ? 1 << tl[ch] : 0;  // an RLE channel's state is 0
        hi[ch] = tl[ch] ? (2 << tl[ch]) - 1 : 0;
    }
    // the sync rule: nb and state >> nb the same at both ends of the range
    // (nb is monotone in the state, and state >> nb on each nb)
    if (tid < 3 * kSym) {
        const int ch = tid / kSym, sym = tid % kSym;
        const int t = (int)min(max(m[4 + ch], 0LL), (long long)kMaxLog);
        const int l = t ? 1 << t : 0, h = t ? (2 << t) - 1 : 0;
        const int2 d = sm.nbfs[ch][sym];
        const int nl = (l + d.x) >> 16, nh = (h + d.x) >> 16;
        int c = -1;
        if (nl == nh && nl >= 0 && nl < 16 && (l >> nl) == (h >> nl))
            c = sm.stt[ch][clamp_state((l >> nl) + d.y)];
        sm.sync[ch][sym] = c;
    }
    const int L = max((n + kThreads - 1) / kThreads, kMinSeg);
    const int S = (n + L - 1) / L;
    const int a = tid * L, e = min(n, a + L);
    // A1: stage the codes (and check every row); exit states from each
    // channel's first sync point
    if (tid < S) {
#pragma unroll 4
        for (int t = a; t < e; ++t) {
            sm.code[t] = pack(sq + (long long)(n - 1 - t) * kCols, bad);
        }
    }
    __syncthreads();
    if (tid < S) {
        int s[3] = {0, 0, 0};
        bool known[3] = {false, false, false};
        for (int t = a; t < e; ++t) {
            const uint32_t c = sm.code[t];
            for (int ch = 0; ch < 3; ++ch) {
                const int sym = sym_of(c, ch);
                if (t == 0) {
                    s[ch] = init_state(sm, ch, sym);
                    known[ch] = true;
                } else if (known[ch]) {
                    s[ch] = step(sm.nbfs[ch], sm.stt[ch], s[ch], sym);
                } else if (sm.sync[ch][sym] >= 0) {
                    s[ch] = sm.sync[ch][sym];
                    known[ch] = true;
                }
            }
        }
        for (int ch = 0; ch < 3; ++ch)
            sm.exit_state[ch][tid] = known[ch] ? s[ch] : -1;
    }
    __syncthreads();
    // A2: each sync-free run of segments in a channel, one thread a run,
    // walked from the exit state before it
    if (tid >= 1 && tid < S) {
        for (int ch = 0; ch < 3; ++ch)
            if (sm.exit_state[ch][tid] < 0 && sm.exit_state[ch][tid - 1] >= 0)
                sm.run[atomicAdd(&sm.nrun, 1)] = ch * kThreads + tid;
    }
    __syncthreads();
    for (int r = tid; r < sm.nrun; r += kThreads) {
        walk_run(sm, n, L, S, sm.run[r] / kThreads, sm.run[r] % kThreads);
    }
    __syncthreads();
    // B1: count the segment's bits from its entry states, checking them
    long long seg = 0;
    int s[3];
    if (tid < S) {
        int t = a;
        if (t == 0) {  // step 0: the initial states, the last extra bits
            const uint32_t c = sm.code[0];
            init_states(sm, c, s);
            seg += extra_bits(c);
            ++t;
        } else {
            for (int ch = 0; ch < 3; ++ch) s[ch] = sm.exit_state[ch][tid - 1];
        }
#pragma unroll 2
        for (; t < e; ++t) {
            const uint32_t c = sm.code[t];
            for (int ch = 0; ch < 3; ++ch) {
                int nb, idx;
                bad |= s[ch] < lo[ch] || s[ch] > hi[ch];
                s[ch] = step(sm.nbfs[ch], sm.stt[ch], s[ch], sym_of(c, ch), nb,
                             idx);
                bad |= (uint32_t)nb > 16u || (uint32_t)idx >= kStates;
                seg += nb;
            }
            seg += extra_bits(c);
        }
        // the walk ends where A1 or A2 said: every entry state is exact
        for (int ch = 0; ch < 3; ++ch) bad |= s[ch] != sm.exit_state[ch][tid];
        if (tid == S - 1) seg += tl[0] + tl[1] + tl[2] + 1;
    }
    // exclusive scan of the segments' bits: each segment's bit offset
    long long incl = seg;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const long long v = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += v;
    }
    if (lane == 31) sm.seg_bits[warp] = incl;
    if (bad) sm.bad = 1;
    __syncthreads();
    if (warp == 0) {
        long long w = lane < kWarps ? sm.seg_bits[lane] : 0;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
            const long long v = __shfl_up_sync(0xffffffffu, w, o);
            if (lane >= o) w += v;
        }
        if (lane < kWarps) sm.seg_bits[lane] = w;
    }
    __syncthreads();
    const long long off = incl - seg + (warp ? sm.seg_bits[warp - 1] : 0);
    const long long total = sm.seg_bits[kWarps - 1], cap = m[3];
    if (sm.bad) {
        if (tid == 0) *bits_out = kBadInput;
        return;
    }
    if (tid == 0) *bits_out = (total + 31) / 32 > cap ? kOverCap : total;
    // B2: emit the segment's bits
    if (tid >= S) return;
    Emit out{reinterpret_cast<uint32_t*>(words) + m[2], cap, off >> 5, 0,
             (int)(off & 31), (off & 31) != 0};
    int t = a;
    if (t == 0) {
        const uint32_t c = sm.code[0];
        init_states(sm, c, s);
        put_extras(out, sq + (long long)(n - 1) * kCols, c);
        ++t;
    } else {
        for (int ch = 0; ch < 3; ++ch) s[ch] = sm.exit_state[ch][tid - 1];
    }
#pragma unroll 2
    for (; t < e; ++t) {
        const uint32_t c = sm.code[t];
        for (int ch = 2; ch >= 0; --ch) {  // OF, ML, LL
            int nb, idx;
            const int st = s[ch];
            s[ch] = step(sm.nbfs[ch], sm.stt[ch], st, sym_of(c, ch), nb, idx);
            out.put((uint32_t)st, nb);
        }
        put_extras(out, sq + (long long)(n - 1 - t) * kCols, c);
    }
    if (tid == S - 1) {
        out.put((uint32_t)s[1], tl[1]);
        out.put((uint32_t)s[2], tl[2]);
        out.put((uint32_t)s[0], tl[0]);
        out.put(1u, 1);
    }
    out.finish();
}

__global__ void __launch_bounds__(kThreads, 1)
fse_encode(const int* __restrict__ seqs, const int* __restrict__ tabs,
           const long long* __restrict__ meta, int* __restrict__ words,
           long long* __restrict__ bits_out) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
    const long long blk = blockIdx.x;
    const long long* m = meta + blk * kMeta;
    const long long n = m[1];
    if (n <= 0 || n > kStage) {
        if (threadIdx.x == 0) bits_out[blk] = n <= 0 ? 0 : kBadInput;
        return;
    }
    const int* tab = tabs + blk * 3 * kChan;
    for (int i = threadIdx.x; i < 3 * kChan; i += kThreads) {
        const int ch = i / kChan, j = i - ch * kChan, v = tab[i];
        if (j < kSym) {
            sm.nbfs[ch][j].x = sm.a2[ch][j].x = v;
        } else if (j < 2 * kSym) {
            sm.nbfs[ch][j - kSym].y = v;
            // states below 1024 and dfs within +-1024: every A2 read lies
            // in this CTA's shared memory (B1 checks what A2 gives)
            sm.a2[ch][j - kSym].y =
                (int)__cvta_generic_to_shared(sm.stt_a2[ch]) +
                4 * min(max(v, -1024), 1024);
        } else {
            sm.stt[ch][j - 2 * kSym] = v;
            sm.stt_a2[ch][j - 2 * kSym] = v & 1023;
        }
    }
    if (threadIdx.x == 0) sm.bad = sm.nrun = 0;
    __syncthreads();
    const int* sq = seqs + m[0] * kCols;
    encode_block(sm, sq, m, (int)n, words, bits_out + blk);
}

}  // namespace

#ifdef __CUDACC__
// C interface (ctypes). Pointers are device pointers: seqs (N, 8) int32 (16-
// byte aligned), tabs (nblk, 3, 640) int32, meta (nblk, 8) int64, the int32
// words at each block's word_off (zeroed) and bits (nblk,) int64: a block's
// bit count, -1 when it needs more than word_cap words (the first word_cap
// are written), -2 when a code, a bit count, a table_log or a state lies out
// of range or the block holds more than 49,152 sequences. The launch goes on
// `stream`; the return value is the first CUDA error of the call (0 when
// none).
extern "C" int stenos_fse_encode(const void* seqs, const void* tabs,
                                 const void* meta, long long nblk, void* words,
                                 void* bits, void* stream) {
    const int smem = (int)sizeof(Smem);
    cudaError_t err = cudaFuncSetAttribute(
        fse_encode, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    fse_encode<<<(unsigned)nblk, kThreads, smem, (cudaStream_t)stream>>>(
        (const int*)seqs, (const int*)tabs, (const long long*)meta,
        (int*)words, (long long*)bits);
    return (int)cudaGetLastError();
}
#endif
