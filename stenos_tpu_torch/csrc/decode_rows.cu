// Block-codec row decode for Hopper (sm_90a), bound through ctypes.
//
// Replaces the TPU kernel stenos_tpu/ops/decode_pallas.py::make_decode_kernel
// in both its modes:
//   K2  derive=False (entry decode_slabs_body): the batched row index of the
//       native parser (stn_parse_rows_batch), per plane a start offset into
//       the virtual stream, per row a record rel | hdr<<10 | min<<14. Same
//       function as stenos_tpu/engine_jax.py::_decode_rows_body.
//   K2b derive=True (entry decode_slabs_derive_body): plane offsets with the
//       plane code in bits 24-25 only, in 'jb' (p = plane*nb + block, the
//       encoder's index) or 'bj' order (p = block*bpp + plane, the parser's);
//       the row records are derived from the stream's own header bytes
//       (derive_records, decode_pallas.py:133-199).
// One kernel template covers both; only the row record's source differs.
//
// One CTA per (block, group of 16 planes), one thread per row. In derive
// mode the 16 threads of a plane (a half-warp) first rebuild the records:
// each reads its header nibble from window bytes 0-7 and its min from the
// mins section (plain: the k-th eligible row's byte from 8; RLE: 2-byte mask
// at 8, literals from 10, filled left), with a half-warp ballot and popc for
// the ranks; then one lane walks the 16-step row-offset chain (RLE rows read
// their 2-byte mask at the running offset) into shared memory.
//
// A row thread then reads its <= 18 payload bytes with plain loads and
// decodes the six row encodings (bit-unpack 1-6, RLE fill-left, delta-RLE,
// delta prefix sums, raw) into a + bflag * prev_last form; the 16-step
// cross-row carry reads the other rows' last values from shared memory. The
// decoded plane bytes are regrouped in shared memory and stored in natural
// element order, contiguous runs per element. Every read is bounded by the
// row width: a corrupt index reads zeros, never out of bounds.
//
// Bound: bytes (the virtual stream and index in, the decoded bytes out). The
// TPU kernel's one-hot MXU gather, lane rotates, log-shift row expansion,
// dense masked-sum reads in the offset chain, LE32 word regroup and odd-nb
// padding are gone: any nb, any bpp.

#include <cstdint>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

namespace {

constexpr int kThreads = 256;  // 16 planes x 16 rows
constexpr int kGroup = 16;

// where the row records come from
enum Source { kRowtab = 0, kDeriveBJ = 1, kDeriveJB = 2 };

template <int kSource>
__global__ void __launch_bounds__(kThreads)
decode_rows(const uint8_t* __restrict__ vbufs, long long row_bytes,
            const int* __restrict__ plane_off, const int* __restrict__ rowtab,
            int nb, int bpp, uint8_t* __restrict__ out) {
    __shared__ int s_a15[kGroup][16];
    __shared__ int s_b15[kGroup][16];
    __shared__ uint8_t s_out[256 * kGroup];
    __shared__ int s_nib[kGroup][16];  // derive: header nibbles
    __shared__ int s_rel[kGroup][16];  // derive: row offsets

    const int t = threadIdx.x;
    const int q = t >> 4;
    const int r = t & 15;
    const long long blk = blockIdx.x;
    const long long sb = blk / nb;
    const int b = (int)(blk - sb * nb);
    const int j0 = blockIdx.y * kGroup;
    const int np = min(kGroup, bpp - j0);
    const long long P = (long long)nb * bpp;
    const bool active = q < np;

    const long long p = (long long)b * bpp + j0 + q;  // stream order
    const long long pi = kSource == kDeriveJB ? (long long)(j0 + q) * nb + b : p;
    const int po = active ? plane_off[sb * P + pi] : 0;
    const long long base = po & 0xFFFFFF;
    const uint8_t* vb = vbufs + sb * row_bytes;
    auto B = [&](long long k) -> int {  // plane window byte k, 0 past the row
        const long long i = base + k;
        return i < row_bytes ? vb[i] : 0;
    };

    int h, mn, rel;
    if constexpr (kSource == kRowtab) {
        const int rec = active ? rowtab[(sb * 16 + r) * P + p] : 0;
        rel = rec & 1023;
        h = (rec >> 10) & 15;
        mn = (rec >> 14) & 255;
    } else {
        // every lane of the warp takes part in the ballot and the barrier;
        // lanes of an inactive plane derive from base 0 and store nothing
        const int code = (po >> 24) & 3;
        const int hb = B(r >> 1);
        const int nib = (r & 1) ? hb >> 4 : hb & 15;
        const bool el = nib != 6 && nib != 7 && nib != 15;  // has a min byte
        const unsigned elm =
            (__ballot_sync(0xFFFFFFFFu, el) >> (threadIdx.x & 16)) & 0xFFFF;
        const unsigned lits = ~(unsigned)(B(8) | (B(9) << 8)) & 0xFFFF;
        int mins;
        if (code == 3) {  // RLE mins: latest literal at or before r, seed 0
            const unsigned upto = lits & ((2u << r) - 1);
            const int k = 31 - __clz(upto);
            mins = upto ? B(10 + __popc(lits & ((1u << k) - 1))) : 0;
        } else {
            mins = el ? B(8 + __popc(elm & ((1u << r) - 1))) : 0;
        }
        h = code == 0 ? 0 : code == 1 ? 15 : nib;
        mn = code == 0 ? B(0) : code == 1 ? 0 : mins;
        s_nib[q][r] = nib;
        __syncwarp();
        if (r == 0) {  // the sequential row-offset chain, one lane a plane
            int o = code == 3 ? 10 + __popc(lits) : 8 + __popc(elm);
            for (int rr = 0; rr < 16; ++rr) {
                s_rel[q][rr] = o;
                const int hh = s_nib[q][rr];
                if (hh == 6 || hh == 7)
                    o += 18 - __popc((unsigned)(B(o) | (B(o + 1) << 8)));
                else
                    o += hh == 15 ? 16 : hh >= 8 ? 2 * (hh - 8) : 2 * hh;
            }
        }
        __syncwarp();
        rel = code == 0 ? 1 : code == 1 ? 16 * r : s_rel[q][r];
    }

    int a[16];
    unsigned bfm = 0;  // bit c: byte c adds the previous row's last byte
    if (active) {
        auto W = [&](int k) -> int { return B(rel + k); };
        if (h == 15) {
#pragma unroll
            for (int c = 0; c < 16; ++c) a[c] = W(c);
        } else if (h == 6 || h == 7) {
            // mask bit c set: repeat; else the next literal. Leading repeats
            // are 0 and, for RLE rows, take the previous row's last byte.
            const unsigned m = (unsigned)(W(0) | (W(1) << 8));
            int n = 0, v = 0;
            bool have = false;
#pragma unroll
            for (int c = 0; c < 16; ++c) {
                if (!((m >> c) & 1)) {
                    v = W(2 + n++);
                    have = true;
                }
                a[c] = v;
                if (h == 7 && !have) bfm |= 1u << c;
            }
            if (h == 6) {
                int s = 0;
#pragma unroll
                for (int c = 0; c < 16; ++c) a[c] = s = (s + a[c]) & 255;
                bfm = 0xFFFF;
            }
        } else {
            const int bw = h & 7;  // 0 for headers 0 and 8
            int vals[16];
#pragma unroll
            for (int g = 0; g < 2; ++g) {
                unsigned long long acc = 0;
                for (int i = 0; i < bw; ++i)
                    acc |= (unsigned long long)W(g * bw + i) << (8 * i);
#pragma unroll
                for (int k = 0; k < 8; ++k)
                    vals[g * 8 + k] = (int)((acc >> (k * bw)) & ((1u << bw) - 1));
            }
            if (h < 8) {
#pragma unroll
                for (int c = 0; c < 16; ++c) a[c] = (vals[c] + mn) & 255;
            } else {
                int s = 0;
#pragma unroll
                for (int c = 0; c < 16; ++c) a[c] = s = (s + vals[c] + mn) & 255;
                bfm = 0xFFFF;
            }
        }
        s_a15[q][r] = a[15];
        s_b15[q][r] = (bfm >> 15) & 1;
    }
    __syncthreads();
    if (active) {
        int pl = 0;  // last byte of the previous row
        for (int rr = 0; rr < r; ++rr) pl = (s_a15[q][rr] + s_b15[q][rr] * pl) & 255;
#pragma unroll
        for (int c = 0; c < 16; ++c)
            s_out[(r * 16 + c) * np + q] = (uint8_t)((a[c] + ((bfm >> c) & 1) * pl) & 255);
    }
    __syncthreads();
    uint8_t* dst = out + blk * 256LL * bpp + j0;
    for (int i = t; i < 256 * np; i += kThreads) {
        const int e = i / np;
        dst[(long long)e * bpp + (i - e * np)] = s_out[i];
    }
}

}  // namespace

#ifdef __CUDACC__
// C interface (ctypes). Pointers are device pointers; the launch goes on
// `stream`; the return value is cudaGetLastError() after the launch.
extern "C" int stenos_decode_rows(const void* vbufs, long long row_bytes,
                                  const void* plane_off, const void* rowtab,
                                  long long n_sb, int nb, int bpp, void* out,
                                  void* stream) {
    const dim3 grid((unsigned)(n_sb * nb), (unsigned)((bpp + kGroup - 1) / kGroup));
    decode_rows<kRowtab><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)vbufs, row_bytes, (const int*)plane_off,
        (const int*)rowtab, nb, bpp, (uint8_t*)out);
    return (int)cudaGetLastError();
}

// K2b: plane_off carries off | code << 24; order_jb selects 'jb' (1) or
// 'bj' (0) plane order.
extern "C" int stenos_decode_rows_derive(const void* vbufs, long long row_bytes,
                                         const void* plane_off, long long n_sb,
                                         int nb, int bpp, int order_jb,
                                         void* out, void* stream) {
    const dim3 grid((unsigned)(n_sb * nb), (unsigned)((bpp + kGroup - 1) / kGroup));
    if (order_jb)
        decode_rows<kDeriveJB><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
            (const uint8_t*)vbufs, row_bytes, (const int*)plane_off, nullptr,
            nb, bpp, (uint8_t*)out);
    else
        decode_rows<kDeriveBJ><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
            (const uint8_t*)vbufs, row_bytes, (const int*)plane_off, nullptr,
            nb, bpp, (uint8_t*)out);
    return (int)cudaGetLastError();
}
#endif
