// Block-codec encode for Hopper (sm_90a), bound through ctypes.
//
// Replaces the TPU kernel stenos_tpu/ops/encode_pallas.py::make_encode_kernel
// in both its modes: with_index=False (K1, entry encode_slabs_body) and
// with_index=True (K1b, entry encode_slabs_index_body), which also writes the
// 4-byte record header and the decode index. Same function as
// stenos_tpu/engine_jax.py::encode_superblocks_body: for every 256-element
// block of a batch of superblocks, analyze each byte plane (16 rows of 16
// bytes), pick row headers, plane codes (ALL_SAME, ALL_RAW, NORMAL,
// NORMAL_RLE) and emit the ragged block stream.
//
// Two launches:
//   encode_planes    one CTA per (block, group of 16 planes), one thread per
//                    row. The plane's bytes are staged in shared memory; each
//                    row thread analyzes and emits its own row; the plane's
//                    payload (<= 256 bytes: a NORMAL plane larger than the
//                    ALL_RAW target is demoted to 256 raw bytes) goes to a
//                    fixed 256-byte slot, with its size and code.
//   assemble_blocks  one CTA per block: the block header nibbles, an
//                    exclusive scan of the plane sizes in shared memory, and
//                    the copy of each plane slot to its place in the
//                    superblock's stream. Block offsets come from a scan of
//                    the block sizes on the host side of the wrapper. With
//                    record bases given, the first block of each superblock
//                    also writes the 4-byte record header there: records go
//                    to rows of a fixed width (index mode) or back to back
//                    behind a frame header (device frame compress). In index
//                    mode the same scan gives each plane's offset in the
//                    record: the decode index costs one store a plane.
//
// Bound: bytes. The work per input byte is a few dozen integer operations;
// the function must read the input once and write the compressed streams
// once. The TPU kernel's log-shift compaction, one-hot gathers, LE32 word
// views and slab-size gates are gone: shared memory and plain byte stores do
// those jobs here, for any number of blocks and any bytes-per-element.

#include <cstdint>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

namespace {

constexpr int kThreads = 256;   // 16 planes x 16 rows
constexpr int kGroup = 16;      // planes per CTA in encode_planes
constexpr int kSlot = 256;      // bytes per plane slot

// bit length of v (0..255) with 7 bumped to 8 (block_compress.h:334-352)
__device__ __forceinline__ int width_of(int v) {
    int w = 0;
    while (v >> w) ++w;
    return w == 7 ? 8 : w;
}

__device__ __forceinline__ int as_int8(int v) { return ((v + 128) & 255) - 128; }

__device__ __forceinline__ bool eligible(int h) {
    return h != 6 && h != 7 && h != 15;
}

__global__ void __launch_bounds__(kThreads)
encode_planes(const uint8_t* __restrict__ data, int bpp, int level,
              uint8_t* __restrict__ slots, int* __restrict__ psizes,
              int* __restrict__ codes) {
    __shared__ uint8_t sx[kGroup][256];
    __shared__ int s_h[kGroup][16];
    __shared__ int s_min[kGroup][16];
    __shared__ int s_size[kGroup][16];
    __shared__ int s_len[kGroup][16];
    __shared__ int s_flag[kGroup][16];  // 1: RLE row, 2: 8-bit row, 4: same

    const int t = threadIdx.x;
    const int q = t >> 4;
    const int r = t & 15;
    const long long blk = blockIdx.x;
    const int j0 = blockIdx.y * kGroup;
    const int np = min(kGroup, bpp - j0);
    const uint8_t* src = data + blk * 256LL * bpp;

    for (int i = t; i < 256 * np; i += kThreads) {
        const int e = i / np;
        const int qq = i - e * np;
        sx[qq][e] = src[(long long)e * bpp + j0 + qq];
    }
    __syncthreads();

    const bool active = q < np;
    int x[16], d[16];
    int h = 0, minb = 0;
    unsigned eqm = 0, deqm = 0;
    if (active) {
        const uint8_t* px = sx[q];
        const int first = px[0];
        int prev = r ? px[r * 16 - 1] : 0;
        int dprev = 0;
        int mx = -128, mnx = 127, mxd = -128, mnd = 127;
        bool same = true;
#pragma unroll
        for (int c = 0; c < 16; ++c) {
            x[c] = px[r * 16 + c];
            d[c] = (x[c] - prev) & 255;
            if (x[c] == prev) eqm |= 1u << c;
            if (d[c] == dprev) deqm |= 1u << c;
            same = same && x[c] == first;
            const int xs = as_int8(x[c]);
            const int ds = as_int8(d[c]);
            mx = max(mx, xs);
            mnx = min(mnx, xs);
            mxd = max(mxd, ds);
            mnd = min(mnd, ds);
            dprev = d[c];
            prev = x[c];
        }
        int bits0 = width_of(mx - mnx);
        if (bits0 == 6) bits0 = 8;  // header 6 is reserved for delta-RLE
        const int bits1 = width_of(mxd - mnd);
        const int bits = min(bits0, bits1);
        const bool t0 = bits0 == bits;  // direct wins ties
        minb = (t0 ? mnx : mnd) & 255;
        int size = 2 * bits + (bits != 8);
        bool use_rle = false, use_drle = false;
        if (level >= 1) {
            const int rle_size = 16 - __popc(eqm) + 2;
            use_rle = rle_size < size;
            size = min(size, rle_size);
            const int drle_size = 16 - __popc(deqm) + 2;
            use_drle = drle_size < size;
            size = min(size, drle_size);
        }
        h = t0 ? (bits0 == 8 ? 15 : bits0) : ((bits1 == 8 ? 7 : bits1) + 8);
        if (use_rle && !use_drle) h = 7;
        if (use_drle) h = 6;
        int len;
        if (h == 15) len = 16;
        else if (h == 7) len = 18 - __popc(eqm);
        else if (h == 6) len = 18 - __popc(deqm);
        else len = 2 * (h & 7);
        const bool all_rle = use_rle || use_drle;
        s_h[q][r] = h;
        s_min[q][r] = minb;
        s_size[q][r] = size;
        s_len[q][r] = len;
        s_flag[q][r] = (all_rle ? 1 : 0) | (!all_rle && bits == 8 ? 2 : 0)
                       | (same ? 4 : 0);
    }
    __syncthreads();
    if (!active) return;  // no barrier below

    // plane-level decisions, computed by every row thread of the plane
    bool all_same = true;
    int count8 = 0, sum_size = 0, n_elig = 0, row_off = 0;
    unsigned mmask = 0;
    for (int rr = 0; rr < 16; ++rr) {
        const int f = s_flag[q][rr];
        all_same = all_same && (f & 4);
        count8 += (f & 1) + ((f >> 1) & 1);
        sum_size += s_size[q][rr];
        n_elig += eligible(s_h[q][rr]);
        if (s_min[q][rr] == (rr ? s_min[q][rr - 1] : 0)) mmask |= 1u << rr;
        if (rr < r) row_off += s_len[q][rr];
    }
    bool normal_rle = false;
    int plane_size = 8 + sum_size;
    if (level >= 1) {
        const int mins_rle_size = 16 - __popc(mmask) + 2;
        normal_rle = mins_rle_size < 16 - count8;
        if (normal_rle) plane_size -= (16 - count8) - mins_rle_size;
    }
    const int target = 256 - (level == 0 ? 25 : level == 1 ? 16 : 0);
    const int code = all_same ? 0 : plane_size > target ? 1 : normal_rle ? 3 : 2;

    const long long plane = blk * bpp + j0 + q;
    uint8_t* out = slots + plane * kSlot;
    if (r == 0) {
        psizes[plane] = code == 0 ? 1 : code == 1 ? 256 : plane_size;
        codes[plane] = code;
    }
    if (code == 0) {
        if (r == 0) out[0] = sx[q][0];
        return;
    }
    if (code == 1) {
#pragma unroll
        for (int c = 0; c < 16; ++c) out[r * 16 + c] = (uint8_t)x[c];
        return;
    }
    // NORMAL / NORMAL_RLE: [header nibbles (8)] [mins section] [16 rows]
    const int lenB = code == 3 ? 18 - __popc(mmask) : n_elig;
    if (r == 0) {
        for (int k = 0; k < 8; ++k)
            out[k] = (uint8_t)(s_h[q][2 * k] | (s_h[q][2 * k + 1] << 4));
        int o = 8;
        if (code == 3) {
            out[o++] = (uint8_t)(mmask & 255);
            out[o++] = (uint8_t)(mmask >> 8);
            for (int rr = 0; rr < 16; ++rr)
                if (!((mmask >> rr) & 1)) out[o++] = (uint8_t)s_min[q][rr];
        } else {
            for (int rr = 0; rr < 16; ++rr)
                if (eligible(s_h[q][rr])) out[o++] = (uint8_t)s_min[q][rr];
        }
    }
    uint8_t* row = out + 8 + lenB + row_off;
    if (h == 15) {
#pragma unroll
        for (int c = 0; c < 16; ++c) row[c] = (uint8_t)x[c];
    } else if (h == 6 || h == 7) {
        const unsigned m = h == 7 ? eqm : deqm;
        row[0] = (uint8_t)(m & 255);
        row[1] = (uint8_t)(m >> 8);
        int o = 2;
#pragma unroll
        for (int c = 0; c < 16; ++c)
            if (!((m >> c) & 1)) row[o++] = (uint8_t)(h == 7 ? x[c] : d[c]);
    } else {
        const int b = h & 7;  // 0 for headers 0 and 8: no row bytes
        for (int g = 0; g < 2 && b; ++g) {
            unsigned long long acc = 0;
#pragma unroll
            for (int k = 0; k < 8; ++k) {
                const int c = g * 8 + k;
                const int v = ((h < 8 ? x[c] : d[c]) - minb) & 255;
                acc |= (unsigned long long)v << (k * b);
            }
            for (int i = 0; i < b; ++i) row[g * b + i] = (uint8_t)(acc >> (8 * i));
        }
    }
}

// Records (rec_base != nullptr): superblock s's record [1, csize u24,
// stream] starts at out + rec_base[s], block_base already counts its 4 header
// bytes, and totals holds each csize. Index mode (K1b, plane_off also set):
// each plane's record-relative offset (block start + plane start) | code << 24
// goes to plane_off in 'jb' order (p = plane * nb + block).
__global__ void __launch_bounds__(kThreads)
assemble_blocks(const uint8_t* __restrict__ slots,
                const int* __restrict__ psizes, const int* __restrict__ codes,
                const long long* __restrict__ block_base, int bpp,
                uint8_t* __restrict__ out, int nb,
                const int* __restrict__ totals,
                const long long* __restrict__ rec_base,
                int* __restrict__ plane_off) {
    __shared__ int s_scan[kThreads];
    __shared__ int s_start[kThreads];

    const int t = threadIdx.x;
    const long long blk = blockIdx.x;
    const int hdr_w = (bpp + 1) / 2;
    const int* ps = psizes + blk * bpp;
    const int* cs = codes + blk * bpp;
    uint8_t* dst = out + block_base[blk];
    const long long sb = blk / nb;
    const int b = (int)(blk - sb * nb);
    long long rel = 0;  // block start, record-relative
    if (rec_base) {
        rel = block_base[blk] - rec_base[sb];
        if (b == 0 && t < 4) {
            const int csize = totals[sb];
            out[rec_base[sb] + t] =
                (uint8_t)(t == 0 ? 1 : csize >> (8 * (t - 1)));
        }
    }
    for (int k = t; k < hdr_w; k += kThreads) {
        const int hi = 2 * k + 1 < bpp ? cs[2 * k + 1] : 0;
        dst[k] = (uint8_t)(cs[2 * k] | (hi << 4));
    }
    int base = hdr_w;
    for (int g0 = 0; g0 < bpp; g0 += kThreads) {
        const int n = min(kThreads, bpp - g0);
        const int sz = t < n ? ps[g0 + t] : 0;
        s_scan[t] = sz;
        __syncthreads();
        for (int o = 1; o < kThreads; o <<= 1) {
            const int v = t >= o ? s_scan[t - o] : 0;
            __syncthreads();
            s_scan[t] += v;
            __syncthreads();
        }
        s_start[t] = base + s_scan[t] - sz;
        __syncthreads();
        if (plane_off && t < n)
            plane_off[sb * nb * bpp + (long long)(g0 + t) * nb + b] =
                (int)(rel + s_start[t]) | (cs[g0 + t] << 24);
        const int warp = t >> 5, lane = t & 31;
        for (int p = warp; p < n; p += kThreads / 32) {
            const int len = ps[g0 + p];
            const uint8_t* s = slots + (blk * bpp + g0 + p) * kSlot;
            uint8_t* o = dst + s_start[p];
            for (int i = lane; i < len; i += 32) o[i] = s[i];
        }
        base += s_scan[kThreads - 1];
        __syncthreads();
    }
}

}  // namespace

#ifdef __CUDACC__
// C interface (ctypes). Pointers are device pointers; the launch goes on
// `stream`; the return value is cudaGetLastError() after the launch.
extern "C" int stenos_encode_planes(const void* data, long long n_blocks,
                                    int bpp, int level, void* slots,
                                    void* psizes, void* codes, void* stream) {
    const dim3 grid((unsigned)n_blocks, (unsigned)((bpp + kGroup - 1) / kGroup));
    encode_planes<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)data, bpp, level, (uint8_t*)slots, (int*)psizes,
        (int*)codes);
    return (int)cudaGetLastError();
}

// totals, rec_base and plane_off are null for K1's streams; totals and
// rec_base are set for records (index rows or a frame), plane_off for K1b's
// decode index; see assemble_blocks.
extern "C" int stenos_assemble_blocks(const void* slots, const void* psizes,
                                      const void* codes, const void* block_base,
                                      long long n_blocks, int bpp, void* out,
                                      int nb, const void* totals,
                                      const void* rec_base, void* plane_off,
                                      void* stream) {
    assemble_blocks<<<(unsigned)n_blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)slots, (const int*)psizes, (const int*)codes,
        (const long long*)block_base, bpp, (uint8_t*)out, nb,
        (const int*)totals, (const long long*)rec_base, (int*)plane_off);
    return (int)cudaGetLastError();
}
#endif
