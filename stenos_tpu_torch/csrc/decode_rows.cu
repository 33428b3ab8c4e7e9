// Block-codec row decode for Hopper (sm_90a), bound through ctypes.
//
// Replaces the TPU kernel stenos_tpu/ops/decode_pallas.py::make_decode_kernel
// in both its modes:
//   K2  derive=False (entry decode_slabs_body): the batched row index of the
//       native parser (stn_parse_rows_ptrs), per plane a start offset into
//       the virtual stream, per row a record rel | hdr<<10 | min<<14. Same
//       function as stenos_tpu/engine_jax.py::_decode_rows_body.
//   K2b derive=True (entry decode_slabs_derive_body): plane offsets with the
//       plane code in bits 24-25 only, in 'jb' (p = plane*nb + block, the
//       encoder's index) or 'bj' order (p = block*bpp + plane, the parser's);
//       the row records are derived from the stream's own header bytes
//       (derive_records, decode_pallas.py:133-199).
// One kernel template covers both; only the row record's source differs.
//
// decode_tiles: one CTA a tile, a tile being whole blocks of one superblock,
// every plane of them (or, for blocks wider than 16 KiB, a group of planes
// of one block). ops/decode_kernel.py launch_plan picks the tile and the CTA
// width (2-16 half-warps) from (bpp, nb, n_sb): 16 KiB tiles of 256 threads
// at the main path's shapes, one-block tiles of narrower CTAs when a call
// has too few tiles to spread over the SMs (a one-slab read). A CTA owns
// one tile; the 6 CTAs an SM (40 registers a thread) overlap one another's
// staging, decode and store.
//   - Staging: a tile's planes are contiguous in stream order (the parser's
//     and K1b's virtual streams: a block's header, then its planes, LZ/COPY
//     blocks inlined as raw planes), so the CTA copies the span from its
//     first plane to the next tile's first plane (plus 32 bytes for the
//     last rows' windows), at most `stage` bytes, into shared memory with
//     16-byte cp.async, zero-filled past the row; the tile's plane offsets
//     and K2's row records come in by coalesced loads meanwhile. A read
//     that falls outside the staged span (a corrupt index, a span over
//     `stage`) goes to global memory, bounded by the row: it gives what the
//     plain version gives.
//   - Work: a step decodes S planes in (block, plane) order, one half-warp a
//     plane and one lane a row, so every lane works at any bpp; only a
//     tile's last step can be ragged.
//   - K2b's records come from a register window of the plane's first 28
//     bytes (header nibbles, the RLE mask, the mins; a half-warp ballot and
//     popc give each row's rank) and the row offsets, a 16-lane shuffle scan
//     of the sizes the nibbles give; only the RLE rows (their size is in
//     their mask at the running offset) are walked one after another.
//   - A row's <= 18 payload bytes come as five aligned shared-memory words
//     and funnel shifts; the six row encodings (bit-unpack 1-6, RLE
//     fill-left, delta-RLE, delta prefix sums, raw) give a + bflag *
//     prev_last, and the cross-row carry is a 4-step half-warp shuffle scan
//     of the (a, bflag) pairs.
//   - Output: each row's 16 bytes go to the tile's output in shared memory,
//     in natural element order (16-byte chunks XOR-swizzled within 128-byte
//     groups against bank conflicts); the tile leaves as one contiguous
//     span in 16-byte stores (plane groups: an element's bytes of the group
//     a store each).
//
// Bound: bytes. The decode needs ~5 integer instructions an output byte
// (unpack shift and mask, the min or the running sum, the carry, the store):
// 0.16 ms at 512 MiB at 64 INT32 lanes a clock an SM on an H100 SXM,
// against 0.20 ms for its bytes at 3.35 TB/s (the stream bytes, the index
// and the decoded output, each once). The design stages every stream byte
// once with wide copies, reads the index coalesced, keeps every lane busy
// and writes every output byte once, coalesced. What holds it above that
// (variant builds, PERF.md): K2b's records, a serial chain a plane.

#include <cstdint>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

namespace {

// where the row records come from
enum Source { kRowtab = 0, kDeriveBJ = 1, kDeriveJB = 2 };

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int valid) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(gmem), "r"(valid));
}
__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}

// byte offset of output byte `off` of a tile: 16-byte chunks XOR-swizzled
// within each 128-byte group
__device__ __forceinline__ int swz(int off) {
    return off ^ (((off >> 7) & 7) << 4);
}

// byte k (0 .. 4N-1) of a window held as N little-endian words
template <int N>
__device__ __forceinline__ int wbyte(const uint32_t (&x)[N], int k) {
    uint32_t w = x[0];
#pragma unroll
    for (int i = 1; i < N; ++i) w = (k >> 2) == i ? x[i] : w;
    return (int)(w >> ((k & 3) * 8)) & 255;
}

// One superblock's row as a CTA sees it: the staged span in shared memory,
// the rest in global memory, zeros past the row.
struct Row {
    const uint8_t* stage;  // row byte o at stage[o - at] for o - at in
    int at, staged;        //   [0, staged)
    const uint8_t* row;
    int bytes;

    __device__ __forceinline__ int byte(int o) const {
        const int si = o - at;
        if (si >= 0 && si < staged) return stage[si];
        return o < bytes ? row[o] : 0;
    }
    // x = the 4N bytes from o, as little-endian words
    template <int N>
    __device__ __forceinline__ void words(uint32_t (&x)[N], int o) const {
        const int si = o - at;
        if (si >= 0 && (si & ~3) + 4 * N + 4 <= staged) {
            const uint32_t* w = (const uint32_t*)(stage + (si & ~3));
            const int sh = (si & 3) * 8;
            uint32_t y[N + 1];
#pragma unroll
            for (int i = 0; i <= N; ++i) y[i] = w[i];
#pragma unroll
            for (int i = 0; i < N; ++i) x[i] = __funnelshift_r(y[i], y[i + 1], sh);
        } else {
#pragma unroll
            for (int i = 0; i < N; ++i) {
                uint32_t v = 0;
#pragma unroll
                for (int k = 0; k < 4; ++k) v |= (uint32_t)byte(o + 4 * i + k) << (8 * k);
                x[i] = v;
            }
        }
    }
};

template <int kSource>
__global__ void __launch_bounds__(256, 6)
decode_tiles(const uint8_t* __restrict__ vbufs, long long row_bytes,
             const int* __restrict__ plane_off, const int* __restrict__ rowtab,
             int nb, int bpp, int tile_blocks, int group, int tiles,
             int stage, int out_cap, uint8_t* __restrict__ out) {
    extern __shared__ __align__(16) uint8_t smem[];
    uint8_t* s_stage = smem;
    uint8_t* s_out = smem + stage;
    int* s_po = (int*)(smem + stage + out_cap);  // the tile's plane_off
    int* s_rt = s_po + ((out_cap / 256 + 3) & ~3);

    const int t = threadIdx.x;
    const int S = blockDim.x >> 4;  // planes a step
    const int q = t >> 4;
    const int r = t & 15;
    const unsigned hw = 0xFFFFu << (t & 16);  // this half-warp's lanes
    const int sb = blockIdx.x / tiles;
    const int tile = blockIdx.x - sb * tiles;
    const int P = nb * bpp;
    const int rb = (int)row_bytes;  // a row: one superblock's stream

    // the tile: planes [p0, p0 + n) in stream order; output width W bytes
    // an element
    int b0, p0, n, W;
    if (tile_blocks) {
        b0 = tile * tile_blocks;
        n = min(tile_blocks, nb - b0) * bpp;
        p0 = b0 * bpp;
        W = bpp;
    } else {
        const int gpb = (bpp + group - 1) / group;
        b0 = tile / gpb;
        const int g0 = (tile - b0 * gpb) * group;
        p0 = b0 * bpp + g0;
        n = min(group, bpp - g0);
        W = n;
    }
    auto index = [&](int p) -> int {  // plane_off's index of plane p
        if (kSource == kDeriveJB) {
            const int b = p / bpp;
            return (p - b * bpp) * nb + b;
        }
        return p;
    };
    const uint8_t* row = vbufs + sb * row_bytes;
    const int* po_sb = plane_off + (long long)sb * P;

    // stage [s0, s1 + 32) of the row, from the 16-byte boundary at or
    // before s0, at most `stage` bytes; zeros past the row
    const int s0 = po_sb[index(p0)] & 0xFFFFFF;
    int s1 = p0 + n < P ? (po_sb[index(p0 + n)] & 0xFFFFFF) : rb;
    s1 = min(s1, rb) + 32;
    const uintptr_t a0 = (uintptr_t)(row + s0) & ~(uintptr_t)15;
    const int ofs = (int)((uintptr_t)(row + s0) - a0);
    int staged = s1 > s0 ? s1 - s0 + ofs : 0;
    staged = min((staged + 15) & ~15, stage);
    {
        const uintptr_t rend = (uintptr_t)(row + row_bytes);
        for (int i = t; i < (staged >> 4); i += blockDim.x) {
            const uintptr_t src = a0 + 16 * (uintptr_t)i;
            if (src < rend)
                cp_async16(s_stage + 16 * i, (const void*)src,
                           rend - src < 16 ? (int)(rend - src) : 16);
            else
                *(uint4*)(s_stage + 16 * i) = make_uint4(0, 0, 0, 0);
        }
    }
    // the tile's plane offsets, and K2's row records (rows at a stride of
    // ns words), while the copies run
    for (int i = t; i < n; i += blockDim.x) s_po[i] = po_sb[index(p0 + i)];
    const int ns = n | 1;
    if constexpr (kSource == kRowtab) {
        for (int i = t; i < 16 * n; i += blockDim.x) {
            const int rr = i / n;
            const int pt = i - rr * n;
            s_rt[rr * ns + pt] = rowtab[((long long)sb * 16 + rr) * P + p0 + pt];
        }
    }
    cp_async_wait_all();
    __syncthreads();

    const Row rw{s_stage, s0 - ofs, staged, row, rb};

    const int steps = (n + S - 1) / S;
    for (int s = 0; s < steps; ++s) {
        const int pt = s * S + q;
        if (pt >= n) break;  // a whole half-warp, in the last step only
        const int bt = tile_blocks ? pt / bpp : 0;  // block in the tile
        const int jt = pt - bt * bpp;                // plane in the tile
        const int po = s_po[pt];
        const int base = po & 0xFFFFFF;

        int h, mn, rel;
        if constexpr (kSource == kRowtab) {
            const int rec = s_rt[r * ns + pt];
            rel = rec & 1023;
            h = (rec >> 10) & 15;
            mn = (rec >> 14) & 255;
        } else {
            const int code = (po >> 24) & 3;
            uint32_t hd[7];  // bytes 0-27: header nibbles, RLE mask, mins
            rw.words(hd, base);
            const int hb = wbyte(hd, r >> 1);
            const int nib = (r & 1) ? hb >> 4 : hb & 15;
            const bool el = nib != 6 && nib != 7 && nib != 15;  // a min byte
            const unsigned elm = (__ballot_sync(hw, el) >> (t & 16)) & 0xFFFF;
            const unsigned lits = ~hd[2] & 0xFFFF;
            int mins;
            if (code == 3) {  // RLE mins: the latest literal at or before r
                const int k = __popc(lits & ((2u << r) - 1));
                mins = k ? wbyte(hd, 9 + k) : 0;
            } else {
                mins = el ? wbyte(hd, 8 + __popc(elm & ((1u << r) - 1))) : 0;
            }
            h = code == 0 ? 0 : code == 1 ? 15 : nib;
            mn = code == 0 ? (int)(hd[0] & 255) : code == 1 ? 0 : mins;
            if (code >= 2) {
                // row offsets: a scan of the sizes the nibbles give, then
                // the RLE rows in order, each sized by its mask
                const int o0 = code == 3 ? 10 + __popc(lits) : 8 + __popc(elm);
                const bool rle = nib == 6 || nib == 7;
                const int sz = rle ? 0
                               : nib == 15 ? 16
                               : nib >= 8  ? 2 * (nib - 8)
                                           : 2 * nib;
                int inc = sz;
#pragma unroll
                for (int d = 1; d < 16; d <<= 1) {
                    const int v = __shfl_up_sync(hw, inc, d, 16);
                    if (r >= d) inc += v;
                }
                const int ex = inc - sz;
                unsigned rm = (__ballot_sync(hw, rle) >> (t & 16)) & 0xFFFF;
                int acc = 0, extra = 0;
                while (rm) {
                    const int i = __ffs(rm) - 1;
                    rm &= rm - 1;
                    const int oi = o0 + __shfl_sync(hw, ex, i, 16) + acc;
                    const unsigned m = (unsigned)(rw.byte(base + oi)
                                                  | (rw.byte(base + oi + 1) << 8));
                    const int si = 2 + __popc(~m & 0xFFFF);
                    if (r > i) extra += si;
                    acc += si;
                }
                rel = o0 + ex + extra;
            } else {
                rel = code == 0 ? 1 : 16 * r;
            }
        }

        // the row's window: bytes 0-19 at base + rel
        uint32_t x[5];
        rw.words(x, base + rel);

        int a[16];
        unsigned bfm = 0;  // bit c: byte c adds the previous row's last byte
        if (h == 15) {
#pragma unroll
            for (int c = 0; c < 16; ++c) a[c] = (x[c >> 2] >> (8 * (c & 3))) & 255;
        } else if (h == 6 || h == 7) {
            // mask bit c set: repeat; else the next literal (byte 2 + k).
            // Leading repeats are 0 and, for RLE rows, take the previous
            // row's last byte.
            const unsigned lit = ~x[0] & 0xFFFF;
#pragma unroll
            for (int c = 0; c < 16; ++c) {
                const int k = __popc(lit & ((2u << c) - 1));
                a[c] = k ? wbyte(x, 1 + k) : 0;
                if (h == 7 && !k) bfm |= 1u << c;
            }
            if (h == 6) {
                int s = 0;
#pragma unroll
                for (int c = 0; c < 16; ++c) a[c] = s = (s + a[c]) & 255;
                bfm = 0xFFFF;
            }
        } else {
            const int bw = h & 7;  // 0 for headers 0 and 8
            const unsigned long long lo = x[0] | ((unsigned long long)x[1] << 32);
            const unsigned long long hi = x[2] | ((unsigned long long)x[3] << 32);
            unsigned long long g0 = 0, g1 = 0;
            if (bw) {
                g0 = lo;
                g1 = (lo >> (8 * bw)) | (hi << (64 - 8 * bw));
            }
            const int msk = (1 << bw) - 1;
            int s = 0;
#pragma unroll
            for (int c = 0; c < 16; ++c) {
                const unsigned long long g = c < 8 ? g0 : g1;
                const int v = (int)(g >> ((c & 7) * bw)) & msk;
                s = (h < 8 ? 0 : s) + v + mn;
                a[c] = s & 255;
            }
            if (h >= 8) bfm = 0xFFFF;
        }

        // cross-row carry: last_r = a15_r + bflag15_r * last_(r-1), a
        // shuffle scan of the affine maps (a, bflag)
        int A = a[15];
        int Bf = (bfm >> 15) & 1;
#pragma unroll
        for (int d = 1; d < 16; d <<= 1) {
            const int A2 = __shfl_up_sync(hw, A, d, 16);
            const int B2 = __shfl_up_sync(hw, Bf, d, 16);
            if (r >= d) {
                A = (A + Bf * A2) & 255;
                Bf &= B2;
            }
        }
        int pl = __shfl_up_sync(hw, A, 1, 16);
        if (r == 0) pl = 0;

        const int e0 = bt * 256 + r * 16;  // the row's first element
        if (W == 1) {
            uint32_t v[4] = {0, 0, 0, 0};
#pragma unroll
            for (int c = 0; c < 16; ++c)
                v[c >> 2] |= (uint32_t)((a[c] + ((bfm >> c) & 1) * pl) & 255)
                             << (8 * (c & 3));
            *(uint4*)(s_out + swz(e0)) = make_uint4(v[0], v[1], v[2], v[3]);
        } else {
#pragma unroll
            for (int c = 0; c < 16; ++c)
                s_out[swz((e0 + c) * W + jt)] =
                    (uint8_t)((a[c] + ((bfm >> c) & 1) * pl) & 255);
        }
    }
    __syncthreads();

    const long long sbytes = (long long)nb * 256 * bpp;
    uint8_t* dst = out + sb * sbytes + (long long)b0 * 256 * bpp;
    if (tile_blocks) {  // one contiguous, 16-byte aligned span
        const int chunks = n * 16;  // n * 256 bytes
        for (int i = t; i < chunks; i += blockDim.x)
            *(uint4*)(dst + 16LL * i) = *(const uint4*)(s_out + swz(16 * i));
    } else {  // a group of planes: each element's n bytes at a stride of bpp
        dst += p0 - (long long)b0 * bpp;
        for (int i = t; i < 256 * n; i += blockDim.x) {
            const int e = i / n;
            dst[(long long)e * bpp + (i - e * n)] = s_out[swz(i)];
        }
    }
}

template <int kSource>
int launch(const void* vbufs, long long row_bytes, const void* plane_off,
           const void* rowtab, long long n_sb, int nb, int bpp,
           int tile_blocks, int group, int tiles, int threads, int stage,
           int out_cap, int smem, void* out, void* stream) {
    if (smem > 48 * 1024) {  // above the default, only when asked for
        const cudaError_t e = cudaFuncSetAttribute(
            decode_tiles<kSource>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return (int)e;
    }
    decode_tiles<kSource><<<(unsigned)(n_sb * tiles), threads, smem,
                            (cudaStream_t)stream>>>(
        (const uint8_t*)vbufs, row_bytes, (const int*)plane_off,
        (const int*)rowtab, nb, bpp, tile_blocks, group, tiles, stage,
        out_cap, (uint8_t*)out);
    return (int)cudaGetLastError();
}

}  // namespace

#ifdef __CUDACC__
// C interface (ctypes). Pointers are device pointers; the launch goes on
// `stream`; the geometry (tile_blocks .. smem) is launch_plan's; the return
// value is cudaGetLastError() after the launch.
extern "C" int stenos_decode_rows(const void* vbufs, long long row_bytes,
                                  const void* plane_off, const void* rowtab,
                                  long long n_sb, int nb, int bpp,
                                  int tile_blocks, int group, int tiles,
                                  int threads, int stage, int out_cap,
                                  int smem, void* out, void* stream) {
    return launch<kRowtab>(vbufs, row_bytes, plane_off, rowtab, n_sb, nb, bpp,
                           tile_blocks, group, tiles, threads, stage, out_cap,
                           smem, out, stream);
}

// K2b: plane_off carries off | code << 24; order_jb selects 'jb' (1) or
// 'bj' (0) plane order.
extern "C" int stenos_decode_rows_derive(const void* vbufs, long long row_bytes,
                                         const void* plane_off, long long n_sb,
                                         int nb, int bpp, int order_jb,
                                         int tile_blocks, int group, int tiles,
                                         int threads, int stage, int out_cap,
                                         int smem, void* out, void* stream) {
    return order_jb
        ? launch<kDeriveJB>(vbufs, row_bytes, plane_off, nullptr, n_sb, nb,
                            bpp, tile_blocks, group, tiles, threads, stage,
                            out_cap, smem, out, stream)
        : launch<kDeriveBJ>(vbufs, row_bytes, plane_off, nullptr, n_sb, nb,
                            bpp, tile_blocks, group, tiles, threads, stage,
                            out_cap, smem, out, stream);
}
#endif
