// zstd sequence-section FSE decode (K7) for Hopper (sm_90a), bound through
// ctypes.
//
// Replaces the TPU kernel stenos_tpu/entropy/seqdec_pallas.py::
// make_seqdec_kernel. The TPU kernel decodes 128 sections side by side, one
// per vector lane, in chunks of 512 sequences over buckets of stream words,
// selecting table entries and stream words with one-of-512 and one-of-16
// masked sums; the repeat offsets were resolved on the host afterwards.
//
// Here one CTA of one warp is a lane: the sections of one zstd frame (a
// payload), walked in order, so that the repeat-offset registers [1, 4, 8]
// chain across its blocks on the card (stn_resolve_reps, bit for bit, its
// error included). One launch covers every payload of a 64 MiB chunk of
// superblocks: 18 KiB of shared memory a CTA puts 12 lanes on an SM, 1,584
// on the card, more than a chunk holds. For each section the warp stages the
// three decode tables (LL, OF, ML; 3 x 512 entries of sym | nb << 8 |
// base << 16) in shared memory, with each LL and ML state's value base and
// extra bits beside them (no code-table load in the walk's chain), then
// walks the backward bitstream
// (RFC 8878 §3.1.1.3.2) with a 64-bit container of two aligned 32-bit
// stream words and 32-bit cursors (a section of a 128 KiB block has fewer
// than 2^21 bits). The word below the container comes from a window of
// 2,048 stream words in shared memory, filled by the whole warp in coalesced
// loads each time the cursor leaves it, so the walk reads no device memory
// between fills (reading aligned words from global memory one shift ahead
// instead took 4% longer on the text cell's chunks). The whole warp walks in
// step (one instruction stream, so it costs what one thread does) and lane 0
// stores.
//
// Semantics are the TPU kernel's: the initial states read tl_ll, tl_of,
// tl_ml bits; each sequence decodes the OF, ML, LL values (an OF code over
// 30 sets error bit 1 and is read as 30), then, except after the last
// sequence, updates the LL, ML and OF states. A read of k bits at cursor bp
// yields bits [bp - k, bp) with zeros below bit 0 and past the stream, and
// moves the cursor to bp - k; error bit 2 is set when the cursor does not end
// at exactly 0. A repeat offset that resolves to 0 or less sets error bit 4;
// the registers take it and the walk goes on.
//
// Outputs: the raw (ll, ml, offset_value) and the resolved offset of every
// sequence, and per section [sum ll, sum ml, lowest match source relative to
// the block start (0 without sequences), error bits].
//
// Bound: bytes (each section's bitstream, tables and metadata in, 16 bytes
// a sequence and 32 a section out). The real limit is the serial chain of one walk: dependent
// shared-memory table loads and bit extractions, a few tens of cycles a
// read. The chunk-wide launch runs the walks of all its payloads side by
// side, so a call takes about as long as its longest section.

#include <cstdint>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

namespace {

constexpr int kStates = 512;
constexpr int kMeta = 8;  // stream_off, stream_len, bp0, nseq, seq_off, tl_ll, tl_of, tl_ml
constexpr int kSumm = 4;  // sum ll, sum ml, lowest match source, error bits
constexpr int kWin = 2048;  // stream words in shared memory

__constant__ int kLLBase[36] = {
    0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15,
    16, 18, 20, 22, 24, 28, 32, 40, 48, 64, 128, 256, 512, 1024,
    2048, 4096, 8192, 16384, 32768, 65536};
__constant__ int kLLBits[36] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    1, 1, 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12,
    13, 14, 15, 16};
__constant__ int kMLBase[53] = {
    3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18,
    19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34,
    35, 37, 39, 41, 43, 47, 51, 59, 67, 83, 99, 131, 259, 515, 1027,
    2051, 4099, 8195, 16387, 32771, 65539};
__constant__ int kMLBits[53] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11,
    12, 13, 14, 15, 16};

// The aligned 32-bit words of one section's stream: word j holds stream
// bytes [4j - a0, 4j - a0 + 4), a0 = the stream's offset from 4-byte
// alignment; bytes outside the stream read as 0, words outside it too.
struct Words {
    const uint32_t* w;
    int n;
    uint32_t m0, mlast;

    __device__ Words(const uint8_t* s, int len) {
        const uintptr_t p = (uintptr_t)s;
        const int a0 = (int)(p & 3);
        w = (const uint32_t*)(p - a0);
        n = (a0 + len + 3) >> 2;
        m0 = 0xffffffffu << (8 * a0);
        const int e = a0 + len - 4 * (n - 1);  // bytes used of the last word
        mlast = e >= 4 ? 0xffffffffu : (1u << (8 * e)) - 1;
    }
    __device__ uint32_t operator()(int j) const {
        if (j < 0 || j >= n) return 0;
        uint32_t v = __ldg(w + j);
        if (j == 0) v &= m0;
        if (j == n - 1) v &= mlast;
        return v;
    }
};

// The stream's words below the container: a window of kWin words [base,
// base + kWin) in shared memory, filled by the whole warp (every lane calls
// next() in step) in coalesced loads; next() hands out words jn, jn - 1, ...
struct SharedSrc {
    Words words;
    uint32_t* win;
    int base, jn;

    __device__ SharedSrc(const Words& ws, uint32_t* s) : words(ws), win(s) {}
    __device__ void fill(int top) {
        base = top - kWin + 1;
        __syncwarp();
        for (int i = threadIdx.x; i < kWin; i += 32) win[i] = words(base + i);
        __syncwarp();
    }
    __device__ uint64_t start(int jl) {
        fill(jl + 1);
        jn = jl - 1;
        return ((uint64_t)win[jl + 1 - base] << 32) | win[jl - base];
    }
    __device__ uint32_t next() {
        if (jn < base) fill(jn);
        return win[jn-- - base];
    }
};

// Backward bit reader: cont holds stream bits [32 jl, 32 jl + 64) (in the
// aligned words' coordinates) and 32 jl <= bp <= 32 jl + 64 holds between
// reads; a read of k <= 32 bits shifts in at most one word.
struct Reader {
    SharedSrc src;
    uint64_t cont;
    int jl, bp;

    __device__ Reader(const Words& ws, uint32_t* s, int bp0) : src(ws, s) {
        bp = bp0;
        jl = ((bp0 - 1) >> 5) - 1;
        cont = src.start(jl);
    }
    __device__ uint32_t read(int k) {
        if (k <= 0) return 0;
        const int w = bp - k;
        if (w < jl * 32) {
            cont = (cont << 32) | src.next();
            --jl;
        }
        bp = w;
        return (uint32_t)(cont >> (w - jl * 32)) & (0xffffffffu >> (32 - k));
    }
};

__device__ void walk_lane(const uint8_t* __restrict__ bytes,
                          const long long* __restrict__ meta,
                          const int* __restrict__ tabs, long long s0,
                          long long s1, int* __restrict__ ll_out,
                          int* __restrict__ ml_out, int* __restrict__ of_out,
                          int* __restrict__ off_out,
                          long long* __restrict__ summ, int* s_tab,
                          int* s_val, uint32_t* s_win) {
    const int lane = threadIdx.x;
    int r0 = 1, r1 = 4, r2 = 8;  // repeat-offset registers, chained
    for (long long sec = s0; sec < s1; ++sec) {
        const long long* m = meta + sec * kMeta;
        __syncwarp();
        for (int i = lane; i < 3 * kStates; i += 32)
            s_tab[i] = tabs[sec * 3 * kStates + i];
        // the LL and ML values of each state's code, base | extra bits <<
        // 24, so that no code-table load follows the state's in the walk
        for (int i = lane; i < 2 * kStates; i += 32) {
            const bool is_ml = i >= kStates;  // ML's table is the third
            const int code =
                tabs[sec * 3 * kStates + i + (is_ml ? kStates : 0)] & 255;
            if (is_ml)
                s_val[i] = code < 53 ? kMLBase[code] | kMLBits[code] << 24 : 0;
            else
                s_val[i] = code < 36 ? kLLBase[code] | kLLBits[code] << 24 : 0;
        }
        __syncwarp();
        const int* t_ll = s_tab;
        const int* t_of = s_tab + kStates;
        const int* t_ml = s_tab + 2 * kStates;
        const int* v_ll = s_val;
        const int* v_ml = s_val + kStates;
        auto entry = [](const int* t, int s, int dflt) {
            return s >= 0 && s < kStates ? t[s] : dflt;
        };

        const uint8_t* s = bytes + m[0];
        const Words ws(s, (int)m[1]);
        const int a0 = (int)((uintptr_t)s & 3);
        Reader br(ws, s_win, (int)m[2] + 8 * a0);
        const int nseq = (int)m[3];
        int* ll = ll_out + m[4];
        int* ml = ml_out + m[4];
        int* of = of_out + m[4];
        int* off_o = off_out + m[4];
        int s_ll = (int)br.read((int)m[5]);
        int s_of = (int)br.read((int)m[6]);
        int s_ml = (int)br.read((int)m[7]);
        int err = 0;
        long long sum_ll = 0, sum_ml = 0, lo_src = 0;
        for (int i = 0; i < nseq; ++i) {
            // an out-of-range state reads entry 0 (code 0: ML value 3)
            const int e_of = entry(t_of, s_of, 0);
            const int e_ml = entry(t_ml, s_ml, 0);
            const int e_ll = entry(t_ll, s_ll, 0);
            const int x_ml = entry(v_ml, s_ml, 3);
            const int x_ll = entry(v_ll, s_ll, 0);
            int ofc = e_of & 255;
            if (ofc > 30) {
                err |= 1;
                ofc = 30;
            }
            const int ofv = (int)((1u << ofc) + br.read(ofc));
            const int mv = (x_ml & 0xffffff) + (int)br.read(x_ml >> 24);
            const int lv = (x_ll & 0xffffff) + (int)br.read(x_ll >> 24);
            if (i + 1 < nseq) {
                s_ll = (e_ll >> 16) + (int)br.read((e_ll >> 8) & 255);
                s_ml = (e_ml >> 16) + (int)br.read((e_ml >> 8) & 255);
                s_of = (e_of >> 16) + (int)br.read((e_of >> 8) & 255);
            }
            // repeat offsets (RFC 8878 §3.1.1.5, stn_resolve_reps)
            int o;
            if (ofv > 3) {
                o = ofv - 3;
                r2 = r1;
                r1 = r0;
                r0 = o;
            } else {
                const int idx = ofv - 1 + (lv == 0 ? 1 : 0);
                if (idx == 0) {
                    o = r0;
                } else if (idx == 1) {
                    o = r1;
                    r1 = r0;
                    r0 = o;
                } else {
                    o = idx == 2 ? r2 : r0 - 1;
                    r2 = r1;
                    r1 = r0;
                    r0 = o;
                }
            }
            if (o <= 0) err |= 4;
            sum_ll += lv;
            const long long src = sum_ll + sum_ml - o;
            lo_src = i == 0 || src < lo_src ? src : lo_src;
            sum_ml += mv;
            if (lane == 0) {
                ll[i] = lv;
                ml[i] = mv;
                of[i] = ofv;
                off_o[i] = o;
            }
        }
        if (br.bp != 8 * a0 && nseq > 0) err |= 2;
        if (lane == 0) {
            long long* out = summ + sec * kSumm;
            out[0] = sum_ll;
            out[1] = sum_ml;
            out[2] = lo_src;
            out[3] = err;
        }
    }
}

__global__ void __launch_bounds__(32)
seq_decode(const uint8_t* __restrict__ bytes, const long long* __restrict__ meta,
           const int* __restrict__ tabs, const long long* __restrict__ lanes,
           int* __restrict__ ll_out, int* __restrict__ ml_out,
           int* __restrict__ of_out, int* __restrict__ off_out,
           long long* __restrict__ summ) {
    __shared__ int s_tab[3 * kStates];
    __shared__ int s_val[2 * kStates];
    __shared__ uint32_t s_win[kWin];
    walk_lane(bytes, meta, tabs, lanes[2 * blockIdx.x],
              lanes[2 * blockIdx.x + 1], ll_out, ml_out, of_out, off_out,
              summ, s_tab, s_val, s_win);
}

}  // namespace

#ifdef __CUDACC__
// C interface (ctypes). Pointers are device pointers: the concatenated
// section bitstreams (4-byte aligned, a multiple of 4 bytes long), meta
// (nsec, 8) int64, tables (nsec, 1536) int32, lanes (nlanes, 2) int64
// section ranges, the (total,) int32 outputs ll, ml, offset values and
// resolved offsets at each section's seq_off, and summ (nsec, 4) int64.
// The launch goes on `stream`; the return value is the first CUDA error of
// the call (0 when none).
extern "C" int stenos_seq_decode(const void* bytes, const void* meta,
                                 const void* tabs, const void* lanes,
                                 long long nlanes, void* ll, void* ml,
                                 void* of, void* off, void* summ,
                                 void* stream) {
    seq_decode<<<(unsigned)nlanes, 32, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)bytes, (const long long*)meta, (const int*)tabs,
        (const long long*)lanes, (int*)ll, (int*)ml, (int*)of, (int*)off,
        (long long*)summ);
    return (int)cudaGetLastError();
}
#endif
