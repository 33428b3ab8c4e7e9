// zstd sequence-section FSE decode (K7) for Hopper (sm_90a), bound through
// ctypes.
//
// Replaces the TPU kernel stenos_tpu/entropy/seqdec_pallas.py::
// make_seqdec_kernel. The TPU kernel decodes 128 sections side by side, one
// per vector lane, in chunks of 512 sequences over buckets of stream words,
// selecting table entries and stream words with one-of-512 and one-of-16
// masked sums. Here: one CTA of 32 threads per section. The threads stage
// the section's three decode tables (LL, OF, ML; 3 x 512 entries of
// sym | nb << 8 | base << 16) in shared memory; thread 0 then walks the
// backward bitstream (RFC 8878 §3.1.1.3.2) with a 64-bit container loaded
// from the 8 bytes that straddle the cursor, as libzstd's BIT_DStream does.
// There are no buckets: any section of a 128 KiB block decodes.
//
// Semantics are the TPU kernel's: the initial states read tl_ll, tl_of,
// tl_ml bits; each sequence decodes the OF, ML, LL values (an OF code over
// 30 sets error bit 1 and is read as 30), then, except after the last
// sequence, updates the LL, ML and OF states. A read of k bits at cursor bp
// yields bits [bp - k, bp) with zeros below bit 0 and past the stream, and
// moves the cursor to bp - k; error bit 2 is set when the cursor does not end
// at exactly 0. Outputs are the raw (ll, ml, offset_value) per sequence;
// repeat offsets are resolved on the host (stn_resolve_reps).
//
// Bound: bytes (stream, tables and metadata in, 12 bytes a sequence out).
// The real limit is the serial chain of dependent table loads and bit reads
// of one thread per section.

#include <cstdint>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

namespace {

constexpr int kStates = 512;
constexpr int kMeta = 8;  // stream_off, stream_len, bp0, nseq, seq_off, tl_ll, tl_of, tl_ml

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

struct BackwardBits {
    const uint8_t* s;
    long long len;
    long long bp;   // bits below the cursor are unread
    long long cb;   // container's first byte, -1 when empty
    uint64_t cont;  // bytes [cb, cb + 8) of the stream, zeros past len

    __device__ void load(long long b) {
        uint64_t v = 0;
        for (int i = 0; i < 8; ++i)
            if (b + i < len) v |= (uint64_t)s[b + i] << (8 * i);
        cb = b;
        cont = v;
    }

    // k <= 32 bits [bp - k, bp), zeros below bit 0
    __device__ uint32_t read(int k) {
        if (k <= 0) return 0;
        const long long w = bp - k;
        const uint64_t mask = (1ull << k) - 1;
        uint32_t v = 0;
        if (bp > 0) {
            if (w >= 0) {
                if (cb < 0 || w < cb * 8 || bp > cb * 8 + 64) {
                    const long long b = ((bp + 7) >> 3) - 8;
                    load(b > 0 ? b : 0);
                }
                v = (uint32_t)((cont >> (w - cb * 8)) & mask);
            } else {
                if (cb != 0) load(0);
                v = (uint32_t)(((cont & ((1ull << bp) - 1)) << (-w)) & mask);
            }
        }
        bp = w;
        return v;
    }
};

__global__ void __launch_bounds__(32)
seq_decode(const uint8_t* __restrict__ bytes, const long long* __restrict__ meta,
           const int* __restrict__ tabs, int* __restrict__ ll_out,
           int* __restrict__ ml_out, int* __restrict__ of_out,
           int* __restrict__ err_out) {
    __shared__ int s_tab[3 * kStates];
    const long long sec = blockIdx.x;
    const long long* m = meta + sec * kMeta;
    for (int i = threadIdx.x; i < 3 * kStates; i += 32)
        s_tab[i] = tabs[sec * 3 * kStates + i];
    __syncthreads();
    if (threadIdx.x != 0) return;

    const int* t_ll = s_tab;
    const int* t_of = s_tab + kStates;
    const int* t_ml = s_tab + 2 * kStates;
    auto entry = [](const int* t, int s) { return s >= 0 && s < kStates ? t[s] : 0; };

    BackwardBits br{bytes + m[0], m[1], m[2], -1, 0};
    const long long nseq = m[3];
    int* ll = ll_out + m[4];
    int* ml = ml_out + m[4];
    int* of = of_out + m[4];
    int s_ll = (int)br.read((int)m[5]);
    int s_of = (int)br.read((int)m[6]);
    int s_ml = (int)br.read((int)m[7]);
    int err = 0;
    for (long long i = 0; i < nseq; ++i) {
        const int e_of = entry(t_of, s_of);
        int ofc = e_of & 255;
        if (ofc > 30) {
            err |= 1;
            ofc = 30;
        }
        of[i] = (int)((1u << ofc) + br.read(ofc));
        const int e_ml = entry(t_ml, s_ml);
        const int mlc = e_ml & 255;
        const int mlb = mlc < 53 ? kMLBase[mlc] : 0;
        ml[i] = mlb + (int)br.read(mlc < 53 ? kMLBits[mlc] : 0);
        const int e_ll = entry(t_ll, s_ll);
        const int llc = e_ll & 255;
        const int llb = llc < 36 ? kLLBase[llc] : 0;
        ll[i] = llb + (int)br.read(llc < 36 ? kLLBits[llc] : 0);
        if (i + 1 < nseq) {
            s_ll = (e_ll >> 16) + (int)br.read((e_ll >> 8) & 255);
            s_ml = (e_ml >> 16) + (int)br.read((e_ml >> 8) & 255);
            s_of = (e_of >> 16) + (int)br.read((e_of >> 8) & 255);
        }
    }
    if (br.bp != 0 && nseq > 0) err |= 2;
    err_out[sec] = err;
}

}  // namespace

#ifdef __CUDACC__
// C interface (ctypes). Pointers are device pointers: the concatenated
// section bitstreams, meta (nsec, 8) int64, tables (nsec, 1536) int32, the
// (total,) int32 outputs at each section's seq_off and err (nsec,) int32.
// The launch goes on `stream`; the return value is the first CUDA error of
// the call (0 when none).
extern "C" int stenos_seq_decode(const void* bytes, const void* meta,
                                 const void* tabs, long long nsec, void* ll,
                                 void* ml, void* of, void* err, void* stream) {
    seq_decode<<<(unsigned)nsec, 32, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)bytes, (const long long*)meta, (const int*)tabs,
        (int*)ll, (int*)ml, (int*)of, (int*)err);
    return (int)cudaGetLastError();
}
#endif
