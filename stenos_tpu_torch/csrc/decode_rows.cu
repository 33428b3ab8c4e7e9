// Block-codec row decode for Hopper (sm_90a), bound through ctypes.
//
// Replaces the TPU kernel stenos_tpu/ops/decode_pallas.py::make_decode_kernel
// (derive=False; entry decode_slabs_body). Same function as
// stenos_tpu/engine_jax.py::_decode_rows_body on the batched row index of the
// native parser (stn_parse_rows_batch): per plane a start offset into the
// virtual stream, per row a record rel | hdr<<10 | min<<14.
//
// One CTA per (block, group of 16 planes), one thread per row. A row thread
// reads its record and its <= 18 payload bytes with plain loads and decodes
// the six row encodings (bit-unpack 1-6, RLE fill-left, delta-RLE, delta
// prefix sums, raw) into a + bflag * prev_last form; the 16-step cross-row
// carry reads the other rows' last values from shared memory. The decoded
// plane bytes are regrouped in shared memory and stored in natural element
// order (plane order 'bj': p = block*bpp + plane), contiguous runs per
// element.
//
// Bound: bytes (the virtual stream and index in, the decoded bytes out). The
// TPU kernel's one-hot MXU gather, lane rotates, log-shift row expansion,
// LE32 word regroup and odd-nb padding are gone: any nb, any bpp.

#include <cstdint>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

namespace {

constexpr int kThreads = 256;  // 16 planes x 16 rows
constexpr int kGroup = 16;

__global__ void __launch_bounds__(kThreads)
decode_rows(const uint8_t* __restrict__ vbufs, long long row_bytes,
            const int* __restrict__ plane_off, const int* __restrict__ rowtab,
            int nb, int bpp, uint8_t* __restrict__ out) {
    __shared__ int s_a15[kGroup][16];
    __shared__ int s_b15[kGroup][16];
    __shared__ uint8_t s_out[256 * kGroup];

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

    int a[16];
    unsigned bfm = 0;  // bit c: byte c adds the previous row's last byte
    if (active) {
        const long long p = (long long)b * bpp + j0 + q;
        const int rec = rowtab[(sb * 16 + r) * P + p];
        const int h = (rec >> 10) & 15;
        const int mn = (rec >> 14) & 255;
        const long long start = (long long)(plane_off[sb * P + p] & 0xFFFFFF)
                                + (rec & 1023);
        const uint8_t* vb = vbufs + sb * row_bytes;
        auto W = [&](int k) -> int {
            const long long i = start + k;
            return i < row_bytes ? vb[i] : 0;
        };
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
    decode_rows<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)vbufs, row_bytes, (const int*)plane_off,
        (const int*)rowtab, nb, bpp, (uint8_t*)out);
    return (int)cudaGetLastError();
}
#endif
