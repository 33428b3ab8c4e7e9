// zstd sequence execution (X1) for Hopper (sm_90a), bound through ctypes.
//
// A kernel of the port alone: in stenos_tpu this work is XLA glue, not
// Pallas (stenos_tpu/entropy/seq_exec.py::run_programs executes a host-built
// program of W-byte copy ops in rounds of one gather and one scatter). In
// torch such a round loop costs two launches a round, ~30-45k rounds a
// 128 KiB block, so the sequences execute here directly.
//
// One launch covers every block of a 64 MiB chunk of payloads. A CTA of 8
// warps is a lane; a lane runs its blocks in order. Per block, two passes:
//   (a) literals: the CTA scans ll and ll + ml over tiles of 1,024
//       sequences (4 a thread; warp shuffles, then the 8 warp totals),
//       which gives each sequence's first literal and its output position.
//       Then it reads the tile's literals, one contiguous span, in aligned
//       16-byte words, a word a thread (coalesced), and writes each byte to
//       its place: its sequence is found by a binary search of the tile's
//       first-literal indices in shared memory, once a word. The trailing
//       literals follow the same way. Literals come from the host literal
//       buffer or in place from the anchored Huffman decode's rows (K5: a
//       block's literals are its 4 stream rows, ceil(n/4) symbols each, the
//       last one the rest; a row is its own span). Literals do not depend
//       on matches, so this pass is parallel.
//   (b) matches: warp 0, out[p + i] = out[p - off + (i % off)] for i < ml
//       (every source byte lies before p and is final by then, so an
//       overlapping match is one parallel copy too). In a tile of 32
//       sequences, the matches of at most 32 bytes whose source ends before
//       the tile's first match start read only final bytes: they copy at
//       once, one lane each; the others follow in order, the warp copying
//       each, with a warp barrier after it. The next tile's sequences are
//       loaded into registers while the current tile runs (a register
//       double buffer), so no device-memory load sits in the chain.
// A staged lane is one block whose matches stay inside it (the caller
// checked): it is built in up to 128 KiB of dynamic shared memory and
// written out in 16-byte stores. Other lanes (a frame whose matches reach
// into earlier blocks) work in device memory, with the same two passes.
//
// Bound: bytes (literals and sequences in, the output written once). The
// real limit is the match pass's serial chain: a dependent shared-memory
// copy and a warp barrier for each match that reads the tile's own output.
// On an H100 80GB HBM3 at 700 W, the literal pass is ~0.40 ms of the
// ~3.0 ms a 64 MiB text chunk takes (chip_smoke.py, literal_pass_ms); the
// rest is the match pass. One CTA with 128 KiB staged fits an SM, so a
// chunk of 512 blocks runs in about 4 waves.

#include <cstdint>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

namespace {

constexpr int kCols = 7;  // out_off, out_len, lit_off, lit_len, seq_off, nseq, row
constexpr int kMaxStaged = 131072;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr long long kRowBytes = 32768;  // a K5 output row
constexpr int kSeqs = 4;                  // sequences a thread scans
constexpr int kTile = kSeqs * kThreads;   // sequences a literal tile

// Byte k (0-15) of a 16-byte word.
__device__ __forceinline__ uint32_t word_byte(const uint4& v, int k) {
    const uint32_t w = k < 8 ? (k < 4 ? v.x : v.y) : (k < 12 ? v.z : v.w);
    return (w >> ((k & 3) * 8)) & 0xFFu;
}

// For the literals [x0, x1) of a span whose literal x lies at src[x]:
// the CTA loads the aligned 16-byte words that hold them, a word a thread
// (coalesced), and calls put(xb, k0, k1, v) with each word v, the index xb
// of its byte 0 and its bytes [k0, k1) that are in the range. The words
// stay inside the buffer (it starts 16-byte aligned and the word holds one
// of its bytes).
template <class Put>
__device__ void span_words(const uint8_t* src, int x0, int x1, Put put) {
    if (x0 >= x1) return;
    const uintptr_t a0 = (uintptr_t)(src + x0) & ~(uintptr_t)15;
    const int nw = (int)(((uintptr_t)(src + x1) - a0 + 15) >> 4);
    const int xa = (int)((const uint8_t*)a0 - src);
    for (int w = threadIdx.x; w < nw; w += kThreads) {
        const uint4 v = __ldg((const uint4*)a0 + w);
        const int xb = xa + 16 * w;
        put(xb, max(0, x0 - xb), min(16, x1 - xb), v);
    }
}

// span_words over the block's literals [x0, x1): the host literal buffer
// lit, or (row >= 0) K5's rows row .. row + 3, s1 literals a row and the
// rest in the last.
template <class Put>
__device__ void lit_words(const uint8_t* lit, const uint8_t* rows,
                          long long row, int s1, int x0, int x1, Put put) {
    if (row < 0) {
        span_words(lit, x0, x1, put);
        return;
    }
    for (int r = 0; r < 4; ++r) {
        const int lo = max(x0, r * s1), hi = min(x1, (r + 1) * s1);
        if (lo < hi)
            span_words(rows + (row + r) * kRowBytes - (long long)r * s1, lo,
                       hi, put);
    }
}

// Exclusive block-wide scan of a and b (each thread's value replaced by the
// sum of the lower threads'); ta, tb get the totals.
__device__ void scan2(int& a, int& b, int& ta, int& tb, int* s_a, int* s_b) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    int ia = a, ib = b;
    for (int d = 1; d < 32; d <<= 1) {
        const int xa = __shfl_up_sync(0xffffffffu, ia, d);
        const int xb = __shfl_up_sync(0xffffffffu, ib, d);
        if (lane >= d) {
            ia += xa;
            ib += xb;
        }
    }
    if (lane == 31) {
        s_a[warp] = ia;
        s_b[warp] = ib;
    }
    __syncthreads();
    if (warp == 0) {
        const int va = lane < kWarps ? s_a[lane] : 0;
        const int vb = lane < kWarps ? s_b[lane] : 0;
        int ca = va, cb = vb;
        for (int d = 1; d < kWarps; d <<= 1) {
            const int xa = __shfl_up_sync(0xffffffffu, ca, d);
            const int xb = __shfl_up_sync(0xffffffffu, cb, d);
            if (lane >= d) {
                ca += xa;
                cb += xb;
            }
        }
        if (lane < kWarps) {
            s_a[lane] = ca - va;
            s_b[lane] = cb - vb;
        }
        if (lane == kWarps - 1) {
            s_a[kWarps] = ca;
            s_b[kWarps] = cb;
        }
    }
    __syncthreads();
    a = s_a[warp] + ia - a;
    b = s_b[warp] + ib - b;
    ta = s_a[kWarps];
    tb = s_b[kWarps];
    __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
seq_exec(uint8_t* out, const uint8_t* __restrict__ lits,
         const uint8_t* __restrict__ rows, const int* __restrict__ ll,
         const int* __restrict__ ml, const int* __restrict__ off,
         const long long* __restrict__ blocks,
         const long long* __restrict__ lanes) {
    extern __shared__ uint4 s_dyn[];
    __shared__ int s_a[kWarps + 1], s_b[kWarps + 1];
    __shared__ int s_lp[kTile + 1], s_dp[kTile];
    uint8_t* s_out = (uint8_t*)s_dyn;
    const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
    const long long* ln = lanes + 3 * blockIdx.x;
    const bool staged = ln[2] != 0;
    for (long long b = ln[0]; b < ln[1]; ++b) {
        const long long* blk = blocks + b * kCols;
        const int out_len = (int)blk[1], lit_len = (int)blk[3];
        const long long seq0 = blk[4];
        const int nseq = (int)blk[5];
        const long long row = blk[6];
        const int s1 = (lit_len + 3) / 4;
        const uint8_t* lit = lits + blk[2];
        uint8_t* o = staged ? s_out : out + blk[0];

        // (a) literals to their final places, a tile of kTile sequences
        // at a time: the scan gives each sequence's first literal (s_lp,
        // from the tile's first) and its output position (s_dp); the CTA
        // reads the tile's literals in 16-byte words and each byte finds
        // its sequence by a binary search of s_lp (then steps on)
        int c_ll = 0, c_pos = 0;  // sums over the tiles before
        for (int g = 0; g < nseq; g += kTile) {
            int l[kSeqs], p[kSeqs], a = 0, q = 0;
#pragma unroll
            for (int j = 0; j < kSeqs; ++j) {
                const int i = g + kSeqs * t + j;
                l[j] = i < nseq ? ll[seq0 + i] : 0;
                p[j] = l[j] + (i < nseq ? ml[seq0 + i] : 0);
                a += l[j];
                q += p[j];
            }
            int tl, tp;
            scan2(a, q, tl, tp, s_a, s_b);
#pragma unroll
            for (int j = 0; j < kSeqs; ++j) {
                s_lp[kSeqs * t + j] = a;
                s_dp[kSeqs * t + j] = c_pos + q;
                a += l[j];
                q += p[j];
            }
            if (t == 0) s_lp[kTile] = tl;
            __syncthreads();
            lit_words(lit, rows, row, s1, c_ll, c_ll + tl,
                      [&](int xb, int k0, int k1, const uint4& v) {
                int y = xb + k0 - c_ll, lo = 0, hi = kTile;
                while (hi - lo > 1) {  // the last i with s_lp[i] <= y
                    const int mid = (lo + hi) >> 1;
                    if (s_lp[mid] <= y) lo = mid; else hi = mid;
                }
                for (int k = k0; k < k1; ++k, ++y) {
                    while (s_lp[lo + 1] <= y) ++lo;
                    o[s_dp[lo] + y - s_lp[lo]] = (uint8_t)word_byte(v, k);
                }
            });
            c_ll += tl;
            c_pos += tp;
            __syncthreads();
        }
        lit_words(lit, rows, row, s1, c_ll, lit_len,  // the trailing ones
                  [&](int xb, int k0, int k1, const uint4& v) {
            for (int k = k0; k < k1; ++k)
                o[c_pos + xb + k - c_ll] = (uint8_t)word_byte(v, k);
        });
        __syncthreads();

        // (b) matches, by warp 0, a tile of 32 sequences at a time: the
        // short matches whose source lies before the tile's first match
        // (final bytes) copy at once, a lane each; the others follow in
        // order, the warp copying each
        if (warp == 0 && nseq > 0) {
            int base = 0;  // the output position where the tile starts
            int nl = 0, nm = 0, no = 1;
            if (lane < nseq) {
                nl = ll[seq0 + lane];
                nm = ml[seq0 + lane];
                no = off[seq0 + lane];
            }
            for (int g = 0; g < nseq; g += 32) {
                const bool valid = g + lane < nseq;
                const int cm = valid ? nm : 0, co = no;
                int end = valid ? nl + nm : 0;  // inclusive scan: ends
                const int gi = g + 32 + lane;
                if (gi < nseq) {
                    nl = ll[seq0 + gi];
                    nm = ml[seq0 + gi];
                    no = off[seq0 + gi];
                }
                for (int d = 1; d < 32; d <<= 1) {
                    const int x = __shfl_up_sync(0xffffffffu, end, d);
                    if (lane >= d) end += x;
                }
                const int p = base + end - cm;  // this lane's match start
                const int p0 = __shfl_sync(0xffffffffu, p, 0);
                const bool quick = valid && cm <= 32
                                   && p - co + min(co, cm) <= p0;
                if (quick) {
                    uint8_t* dst = o + p;
                    const uint8_t* src = dst - co;
                    if (co >= cm) {
                        for (int j = 0; j < cm; ++j) dst[j] = src[j];
                    } else {
                        for (int j = 0; j < cm; ++j) dst[j] = src[j % co];
                    }
                }
                __syncwarp();
                unsigned rest = __ballot_sync(0xffffffffu,
                                              valid && cm > 0 && !quick);
                while (rest) {
                    const int k = __ffs(rest) - 1;
                    rest &= rest - 1;
                    const int pk = __shfl_sync(0xffffffffu, p, k);
                    const int m = __shfl_sync(0xffffffffu, cm, k);
                    const int d = __shfl_sync(0xffffffffu, co, k);
                    uint8_t* dst = o + pk;
                    const uint8_t* src = dst - d;
                    if (d >= m) {
                        for (int j = lane; j < m; j += 32) dst[j] = src[j];
                    } else {
                        for (int j = lane; j < m; j += 32) dst[j] = src[j % d];
                    }
                    __syncwarp();
                }
                base += __shfl_sync(0xffffffffu, end, 31);
            }
        }
        __syncthreads();

        if (staged) {  // the staged block out, 16 bytes a store where aligned
            uint8_t* dst = out + blk[0];
            int done = 0;
            if (((uintptr_t)dst & 15) == 0) {
                const int n16 = out_len >> 4;
                for (int j = t; j < n16; j += kThreads)
                    ((uint4*)dst)[j] = s_dyn[j];
                done = n16 << 4;
            }
            for (int j = done + t; j < out_len; j += kThreads)
                dst[j] = s_out[j];
            __syncthreads();
        }
    }
}

}  // namespace

#ifdef __CUDACC__
// C interface (ctypes). Pointers are device pointers: out (the chunk's
// output), lits (host-decoded literals), rows (K5's (nrows, 32768) output,
// may be empty), the (total,) int32 ll, ml and resolved offsets, blocks
// (nblk, 7) int64, lanes (nlanes, 3) int64 (block range, staged flag).
// staged_bytes (> 0 when a lane is staged) is the dynamic shared memory,
// at most 128 KiB. The launch goes on `stream`; the return value is the
// first CUDA error of the call (0 when none).
extern "C" int stenos_seq_exec(void* out, const void* lits, const void* rows,
                               const void* ll, const void* ml, const void* off,
                               const void* blocks, const void* lanes,
                               long long nlanes, long long staged_bytes,
                               void* stream) {
    if (staged_bytes > kMaxStaged) return (int)cudaErrorInvalidValue;
    const int shared = (int)((staged_bytes + 15) & ~15LL);
    cudaError_t err = cudaFuncSetAttribute(
        seq_exec, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxStaged);
    if (err != cudaSuccess) return (int)err;
    seq_exec<<<(unsigned)nlanes, kThreads, shared, (cudaStream_t)stream>>>(
        (uint8_t*)out, (const uint8_t*)lits, (const uint8_t*)rows,
        (const int*)ll, (const int*)ml, (const int*)off,
        (const long long*)blocks, (const long long*)lanes);
    return (int)cudaGetLastError();
}
#endif
