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
// encode_superblocks: one 256-thread CTA per superblock, one pass over it.
//   The CTA walks its blocks in tiles and carries the running stream
//   offset, so no block offset needs a scan outside the kernel; it writes
//   the stream (or the record [1, csize u24, stream]) into its output row,
//   in index mode the zeros after it up to the row's end, totals, bsizes,
//   fsizes and, in index mode, each plane's record offset | code << 24
//   ('jb' order).
//   - Threads map to (plane, row): the 16 lanes of a half-warp are the 16
//     rows of one plane, so a step analyses 16 planes taken in order across
//     the tile's blocks (16/bpp blocks a step at bpp 4; at any bpp the last
//     step of a tile is the only one that may be ragged, and the host's
//     launch plan picks the tile that keeps it fullest).
//   - A tile of whole blocks (up to 16 KiB) is copied in with 16-byte
//     cp.async, double-buffered so the next tile loads while this one is
//     analysed, into an element-major layout where a row of 16 elements
//     spans an odd count of 16-byte words (16 bytes of padding at even
//     bpp), so a plane's 16 row starts fall on 8 banks, two a bank. A
//     block wider than 16 KiB goes by groups of 16 planes, gathered a
//     thread an element.
//   - Plane decisions are warp primitives: shuffle sums (plane size),
//     ballots (ALL_SAME, eligible rows, the mins repeat mask, 8-bit rows),
//     a 16-lane shuffle scan for each row's offset; a plane's start in the
//     tile is a 16-slot scan, and each lane writes its own header nibble,
//     min byte and row.
//   - Each tile's output is built in shared memory at the phase of its
//     place in device memory and stored as one span: 16-byte stores, bytes
//     at the ragged ends. No per-plane slot buffer goes to device memory.
//   - Frame mode: CTA s first zeroes slot s of the frame's capacity (the
//     record bound behind the header) with 16-byte stores; the other CTAs
//     of its SM analyse meanwhile. place_records then moves only the
//     records (the zeros under them are written twice). On an H100 this
//     adds ~0.055 ms to K1's ~1.04 ms at 512 MiB and takes ~0.20 ms off
//     place_records; a slice of the slot after each tile's flush cost
//     0.12 ms and spilled.
// place_records (frame mode only): one CTA per record copies it from its
//   row to its place behind the frame header (its base is the sum of the
//   records before it), and CTA 0 writes the header and the frame length.
//   Called on its own (zero_tail: no K1 zeroed the frame) it also zero-fills
//   its share of the tail past the frame's length. A record's base is known
//   only once every earlier superblock is encoded; a second launch costs
//   the records' bytes twice (~118 MB at 512 MiB of sorted int32). The step
//   left is to fold it into K1's frame mode: each CTA finds its base by a
//   decoupled look-back over the totals of the CTAs before it and copies
//   its record, still in L2, at its end.
// A column (a 1-D array of any length) ends in a short superblock: K1's
//   last CTA encodes its whole blocks (nb_last of them) into the last row,
//   encode_short (one CTA) appends the 0xFE marker and the partial segment
//   of the bytes past them, and place_records places that record as any
//   other: three launches, two when the column ends in whole blocks.
//
// Bound: integer instructions and their latency, not bytes. The row analysis
// alone is ~11 32-bit integer instructions an input byte (plane decisions and
// emission come on top): at 64 integer lanes a clock an SM that is ~0.35 ms
// for 512 MiB on an H100 SXM, against ~0.2 ms for its bytes at 3.35 TB/s (the
// input, the records and the sizes, each once; in frame mode the frame's
// capacity of zeros as well, ~538 MB more: ~0.36 ms for all its bytes, about
// its integer bound). The design gives every lane of a step work,
// holds a thread to 64 registers so that 4 CTAs (32 warps) share an SM and
// hide one another's shuffle, shared-memory and barrier latency, overlaps
// each tile's load with the previous tile's analysis, and writes every
// output byte once, coalesced.

#include <cstdint>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#endif

namespace {

constexpr int kThreads = 256;   // 16 plane slots x 16 rows
constexpr int kMaxTile = 64;    // blocks a tile, at most
constexpr unsigned kFull = 0xffffffffu;

// bit length of v (0..255) with 7 bumped to 8 (block_compress.h:334-352)
__device__ __forceinline__ int width_of(int v) {
    const int w = 32 - __clz(v);
    return w == 7 ? 8 : w;
}

// n / d for n * d < 2^32 by a multiply: m = ceil(2^32 / d), d > 1
struct Divider {
    int d;
    unsigned m;
    __device__ explicit Divider(int d_)
        : d(d_), m(d_ > 1 ? 0xFFFFFFFFu / (unsigned)d_ + 1 : 0) {}
    __device__ int operator()(int n) const {
        return d == 1 ? n : (int)__umulhi((unsigned)n, m);
    }
};

__device__ __forceinline__ bool eligible(int h) {
    return h != 6 && h != 7 && h != 15;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// One row thread's share of a plane: its 16 bytes and deltas, its row's
// header, min and emitted length, and the plane-wide decisions (the same on
// the plane's 16 lanes).
struct Plane {
    int x[16];
    int prev;  // the byte before x[0] (the previous row's last, 0 at row 0)
    int h, minb, len, row_off;
    unsigned eqm, deqm, mmask, elig;
    int code, psize, lenB;
};

// Analyse row r of a plane whose element e sits at row[e * S] (row points at
// the plane's element 16r). The 16 lanes of each half-warp hold the 16 rows
// of one plane; every lane of the warp calls this (it shuffles).
__device__ __forceinline__ void analyse(Plane& p, const uint8_t* row, int S,
                                        int level, int r, int seg) {
#pragma unroll
    for (int c = 0; c < 16; ++c) p.x[c] = row[c * S];
    int prev = __shfl_up_sync(kFull, p.x[15], 1, 16);
    if (r == 0) prev = 0;
    p.prev = prev;
    int dprev = 0;
    int mx = -128, mnx = 127, mxd = -128, mnd = 127;
    unsigned eqm = 0, deqm = 0;
#pragma unroll
    for (int c = 0; c < 16; ++c) {
        const int x = p.x[c];
        const int ds = (int8_t)(x - prev);  // the delta as int8
        const int d = ds & 255;
        eqm |= (unsigned)(x == prev) << c;
        deqm |= (unsigned)(d == dprev) << c;
        const int xs = (int8_t)x;
        mx = max(mx, xs);
        mnx = min(mnx, xs);
        mxd = max(mxd, ds);
        mnd = min(mnd, ds);
        dprev = d;
        prev = x;
    }
    const bool flat = mx == mnx;  // the row's 16 bytes are one value
    int bits0 = width_of(mx - mnx);
    if (bits0 == 6) bits0 = 8;  // header 6 is reserved for delta-RLE
    const int bits1 = width_of(mxd - mnd);
    const int bits = min(bits0, bits1);
    const bool t0 = bits0 == bits;  // direct wins ties
    const int minb = (t0 ? mnx : mnd) & 255;
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
    int h = t0 ? (bits0 == 8 ? 15 : bits0) : ((bits1 == 8 ? 7 : bits1) + 8);
    if (use_rle && !use_drle) h = 7;
    if (use_drle) h = 6;
    int len;
    if (h == 15) len = 16;
    else if (h == 7) len = 18 - __popc(eqm);
    else if (h == 6) len = 18 - __popc(deqm);
    else len = 2 * (h & 7);
    const bool all_rle = use_rle || use_drle;
    p.h = h;
    p.minb = minb;
    p.len = len;
    p.eqm = eqm;
    p.deqm = deqm;

    // plane-wide decisions over the half-warp
    const int count8 = __popc((__ballot_sync(kFull, all_rle || bits == 8)
                               >> seg) & 0xFFFF);
    p.elig = (__ballot_sync(kFull, eligible(h)) >> seg) & 0xFFFF;
    int pmin = __shfl_up_sync(kFull, minb, 1, 16);
    if (r == 0) pmin = 0;
    p.mmask = (__ballot_sync(kFull, minb == pmin) >> seg) & 0xFFFF;
    // ALL_SAME: every row flat (its min is its value: a flat row's direct
    // width 0 wins) and each row's min that of the row before
    const bool all_same =
        ((__ballot_sync(kFull, flat) >> seg) & 0xFFFF) == 0xFFFF
        && (p.mmask | 1) == 0xFFFF;
    int sum_size = size;
#pragma unroll
    for (int o = 8; o; o >>= 1)
        sum_size += __shfl_xor_sync(kFull, sum_size, o, 16);
    int incl = len;
#pragma unroll
    for (int o = 1; o < 16; o <<= 1) {
        const int v = __shfl_up_sync(kFull, incl, o, 16);
        if (r >= o) incl += v;
    }
    p.row_off = incl - len;

    bool normal_rle = false;
    int plane_size = 8 + sum_size;
    if (level >= 1) {
        const int mins_rle_size = 16 - __popc(p.mmask) + 2;
        normal_rle = mins_rle_size < 16 - count8;
        if (normal_rle) plane_size -= (16 - count8) - mins_rle_size;
    }
    const int target = 256 - (level == 0 ? 25 : level == 1 ? 16 : 0);
    p.code = all_same ? 0 : plane_size > target ? 1 : normal_rle ? 3 : 2;
    p.psize = p.code == 0 ? 1 : p.code == 1 ? 256 : plane_size;
    p.lenB = p.code == 3 ? 18 - __popc(p.mmask) : __popc(p.elig);
}

// the row's delta c, recomputed (holding 16 deltas costs 16 registers)
__device__ __forceinline__ int delta(const Plane& p, int c) {
    return (p.x[c] - (c ? p.x[c - 1] : p.prev)) & 255;
}

// the row's own bytes, at row: raw, RLE or bit-packed by its header
__device__ __forceinline__ void emit_row(const Plane& p, uint8_t* row) {
    const int h = p.h;
    if (h == 15) {
#pragma unroll
        for (int c = 0; c < 16; ++c) row[c] = (uint8_t)p.x[c];
    } else if (h == 6 || h == 7) {
        const unsigned m = h == 7 ? p.eqm : p.deqm;
        row[0] = (uint8_t)(m & 255);
        row[1] = (uint8_t)(m >> 8);
        int k = 2;
#pragma unroll
        for (int c = 0; c < 16; ++c)
            if (!((m >> c) & 1))
                row[k++] = (uint8_t)(h == 7 ? p.x[c] : delta(p, c));
    } else {
        const int b = h & 7;  // 0 for headers 0 and 8: no row bytes
        if (b) {
#pragma unroll
            for (int g = 0; g < 2; ++g) {
                unsigned long long acc = 0;
#pragma unroll
                for (int k = 0; k < 8; ++k) {
                    const int c = g * 8 + k;
                    const int v = ((h < 8 ? p.x[c] : delta(p, c)) - p.minb)
                                  & 255;
                    acc |= (unsigned long long)v << (k * b);
                }
                for (int i = 0; i < b; ++i)
                    row[g * b + i] = (uint8_t)(acc >> (8 * i));
            }
        }
    }
}

// Row r's share of the plane's bytes, written at o (the plane's start in the
// shared output window). hn is row r+1's header (for the even rows' nibble).
__device__ __forceinline__ void emit(const Plane& p, uint8_t* o, int r,
                                     int hn) {
    if (p.code == 0) {
        if (r == 0) o[0] = (uint8_t)p.x[0];
        return;
    }
    if (p.code == 1) {
#pragma unroll
        for (int c = 0; c < 16; ++c) o[r * 16 + c] = (uint8_t)p.x[c];
        return;
    }
    // NORMAL / NORMAL_RLE: [header nibbles (8)] [mins section] [16 rows]
    const unsigned below = (1u << r) - 1;
    if (!(r & 1)) o[r >> 1] = (uint8_t)(p.h | (hn << 4));
    if (p.code == 3) {
        if (r == 0) {
            o[8] = (uint8_t)(p.mmask & 255);
            o[9] = (uint8_t)(p.mmask >> 8);
        }
        if (!((p.mmask >> r) & 1))
            o[10 + __popc(~p.mmask & below)] = (uint8_t)p.minb;
    } else if ((p.elig >> r) & 1) {
        o[8 + __popc(p.elig & below)] = (uint8_t)p.minb;
    }
    emit_row(p, o + 8 + p.lenB + p.row_off);
}

// win[ph + i] -> dst[i] for i < n, where dst = 16-byte boundary + ph: the
// whole words as 16-byte stores, the ragged ends as bytes.
__device__ __forceinline__ void flush(uint8_t* dst, const uint8_t* win,
                                      int ph, int n, int t) {
    const int end = ph + n;
    const int head_end = min(end, (ph + 15) & ~15);
    const int body_end = max(head_end, end & ~15);
    for (int i = ph + t; i < head_end; i += kThreads) dst[i - ph] = win[i];
    uint4* dw = reinterpret_cast<uint4*>(dst - ph);
    const uint4* sw = reinterpret_cast<const uint4*>(win);
    for (int w = (head_end >> 4) + t; w < (body_end >> 4); w += kThreads)
        dw[w] = sw[w];
    for (int i = body_end + t; i < end; i += kThreads) dst[i - ph] = win[i];
}

// src[i] -> dst[i] for i < n, any alignments: whole 16-byte words of dst
// from two aligned 16-byte loads of src and a funnel shift, bytes at the
// ragged ends
__device__ __forceinline__ void copy_bytes(uint8_t* dst, const uint8_t* src,
                                           long long n, int t) {
    const uintptr_t d0 = (uintptr_t)dst, d1 = d0 + n;
    const uintptr_t a0 = min(d1, (d0 + 15) & ~(uintptr_t)15);
    const uintptr_t a1 = max(a0, d1 & ~(uintptr_t)15);
    for (uintptr_t q = d0 + t; q < a0; q += kThreads)
        *(uint8_t*)q = src[q - d0];
    for (uintptr_t q = a1 + t; q < d1; q += kThreads)
        *(uint8_t*)q = src[q - d0];
    const uint8_t* s0 = src + (a0 - d0);
    const int sh = (int)((uintptr_t)s0 & 15);
    const uint4* sw = reinterpret_cast<const uint4*>(s0 - sh);
    uint4* dw = reinterpret_cast<uint4*>(a0);
    const long long nw = (long long)(a1 - a0) >> 4;
    const int qw = sh >> 2, bits = 8 * (sh & 3);
    for (long long k = t; k < nw; k += kThreads) {
        const uint4 lo = sw[k];
        // the next word only when the shifted word reaches into it (its
        // start then lies inside the record)
        const uint4 hi = sh ? sw[k + 1] : lo;
        const unsigned u[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
        unsigned o[5];
#pragma unroll
        for (int i = 0; i < 5; ++i)
            o[i] = qw == 0 ? u[i] : qw == 1 ? u[i + 1]
                 : qw == 2 ? u[i + 2] : u[min(i + 3, 7)];
        dw[k] = make_uint4(__funnelshift_r(o[0], o[1], bits),
                           __funnelshift_r(o[1], o[2], bits),
                           __funnelshift_r(o[2], o[3], bits),
                           __funnelshift_r(o[3], o[4], bits));
    }
}

// zeros over [a, b) of device memory
__device__ __forceinline__ void zero_fill(uint8_t* a, uint8_t* b, int t) {
    const uintptr_t pa = (uintptr_t)a, pb = (uintptr_t)b;
    if (pa >= pb) return;
    const uintptr_t ha = min(pb, (pa + 15) & ~(uintptr_t)15);
    const uintptr_t hb = max(ha, pb & ~(uintptr_t)15);
    for (uintptr_t q = pa + t; q < ha; q += kThreads) *(uint8_t*)q = 0;
    const uint4 z = make_uint4(0, 0, 0, 0);
    for (uintptr_t q = ha + 16 * (uintptr_t)t; q < hb; q += 16 * kThreads)
        *(uint4*)q = z;
    for (uintptr_t q = hb + t; q < pb; q += kThreads) *(uint8_t*)q = 0;
}

struct Geometry {
    int tile_blocks;  // whole blocks a tile; 0: a block by groups of 16 planes
    int pad;          // stage bytes after every 16 elements
    int stage_bytes;  // one stage buffer
    int win_off, codes_off;
};

// Row s of out (row_w bytes): [record header (rec = 4 bytes) | stream |
// zeros up to row_w if zero_tail]. totals[s] is the stream length. Every
// superblock has nb blocks but, in a column (kColumn), the last, which has
// nb_last (the short superblock's whole blocks). kColumn is a template
// argument so that whole superblocks run the code they ran before columns
// (64 registers, no spills), as the one extra live count spills. Frame
// mode (frame not null): CTA s first zeroes slot s of the frame's capacity
// cap behind its hlen-byte header, [hlen + s*w, hlen + (s+1)*w) with w =
// (cap - hlen) / n_sb, for place_records to write the records over.
template <bool kColumn>
__global__ void __launch_bounds__(kThreads, 4)
encode_superblocks(const uint8_t* __restrict__ data, int nb, int nb_last,
                   int bpp, int level, uint8_t* __restrict__ out,
                   long long row_w, int rec, int zero_tail,
                   int* __restrict__ totals,
                   int* __restrict__ bsizes, int* __restrict__ fsizes,
                   int* __restrict__ plane_off, uint8_t* __restrict__ frame,
                   long long cap, int hlen, Geometry geo) {
    extern __shared__ __align__(16) uint8_t smem[];
    __shared__ int s_ps[2][16];
    __shared__ int s_bstart[kMaxTile + 1];

    const int t = threadIdx.x;
    const int lane = t & 31;
    const int q = t >> 4;          // plane slot of the step
    const int r = t & 15;          // row of the plane
    const int seg = lane & 16;     // the half-warp's ballot bits
    const long long sb = blockIdx.x;
    const int hdr_w = (bpp + 1) / 2;
    const long long bbytes = 256LL * bpp;
    const uint8_t* src = data + sb * nb * bbytes;
    // blocks of this superblock: a column's last (short) one has nb_last
    const int nbk = kColumn && sb + 1 == gridDim.x ? nb_last : nb;
    uint8_t* row = out + sb * row_w;
    uint8_t* win = smem + geo.win_off;
    uint8_t* codes = smem + geo.codes_off;
    int* po = plane_off ? plane_off + sb * nb * bpp : nullptr;
    int run = 0;  // stream bytes done
    int step = 0;

    // the 16-slot scan of plane sizes: slot q's exclusive start, step total
    auto scan_slots = [&](int psize, bool active, int& pre, int& total) {
        if (r == 0) s_ps[step & 1][q] = active ? psize : 0;
        __syncthreads();
        const int v = s_ps[step & 1][lane & 15];
        int incl = v;
#pragma unroll
        for (int o = 1; o < 16; o <<= 1) {
            const int u = __shfl_up_sync(kFull, incl, o, 16);
            if ((lane & 15) >= o) incl += u;
        }
        pre = __shfl_sync(kFull, incl - v, q);
        total = __shfl_sync(kFull, incl, 15);
        ++step;
    };

    if (frame) {  // frame mode: slot sb of the capacity behind the header
        const long long w = (cap - hlen) / gridDim.x;
        zero_fill(frame + hlen + sb * w, frame + hlen + (sb + 1) * w, t);
    }

    if (geo.tile_blocks) {
        const int kb = geo.tile_blocks;
        const int gstride = 16 * bpp + geo.pad;
        const int ntiles = (nbk + kb - 1) / kb;
        const Divider by_bpp(bpp);
        auto load = [&](int tile) {
            uint8_t* st = smem + (tile & 1) * geo.stage_bytes;
            const uint8_t* g = src + tile * kb * bbytes;
            const int nw = min(kb, nbk - tile * kb) * 16 * bpp;
            for (int i = t; i < nw; i += kThreads) {
                const int grp = by_bpp(i);
                cp_async16(st + grp * gstride + (i - grp * bpp) * 16,
                           g + 16LL * i);
            }
            cp_async_commit();
        };
        load(0);
        for (int tile = 0; tile < ntiles; ++tile) {
            if (tile + 1 < ntiles) {
                load(tile + 1);
                cp_async_wait<1>();
            } else {
                cp_async_wait<0>();
            }
            __syncthreads();
            const uint8_t* st = smem + (tile & 1) * geo.stage_bytes;
            const int b0 = tile * kb;
            const int kbt = min(kb, nbk - b0);
            const int np = kbt * bpp;
            uint8_t* dst = row + rec + run;
            const int ph = (int)((uintptr_t)dst & 15);
            int carry = 0;
            for (int s0 = 0; s0 < np; s0 += 16) {
                const int fp = s0 + q;
                const bool active = fp < np;
                const int fpc = active ? fp : np - 1;
                const int bt = by_bpp(fpc);
                const int j = fpc - bt * bpp;
                Plane p;
                analyse(p, st + (bt * 16 + r) * gstride + j, bpp, level, r,
                        seg);
                const int hn = __shfl_down_sync(kFull, p.h, 1, 16);
                int pre, total;
                scan_slots(p.psize, active, pre, total);
                const int pos = carry + pre + (bt + 1) * hdr_w;
                if (active) {
                    emit(p, win + ph + pos, r, hn);
                    if (r == 0) {
                        codes[fp] = (uint8_t)p.code;
                        if (j == 0) s_bstart[bt] = pos - hdr_w;
                        if (po)
                            po[(long long)j * nb + b0 + bt] =
                                (rec + run + pos) | (p.code << 24);
                    }
                }
                carry += total;
            }
            const int span = carry + kbt * hdr_w;
            __syncthreads();
            for (int i = t; i < kbt * hdr_w; i += kThreads) {
                const int bt = i / hdr_w;
                const int k = i - bt * hdr_w;
                const uint8_t* cb = codes + bt * bpp;
                const int hi = 2 * k + 1 < bpp ? cb[2 * k + 1] : 0;
                win[ph + s_bstart[bt] + k] = (uint8_t)(cb[2 * k] | (hi << 4));
            }
            for (int i = t; i < kbt; i += kThreads) {
                const int bs = (i + 1 < kbt ? s_bstart[i + 1] : span)
                               - s_bstart[i];
                bsizes[sb * nb + b0 + i] = bs;
                fsizes[sb * nb + b0 + i] = bs - hdr_w;
            }
            __syncthreads();
            flush(dst, win, ph, span, t);
            run += span;
            __syncthreads();  // the window and this stage are free again
        }
    } else {
        // blocks wider than a stage: 16 planes at a time, a thread an element
        const int gstride = 16 * 16 + geo.pad;
        for (int b = 0; b < nbk; ++b) {
            const uint8_t* blk = src + b * bbytes;
            int carry = 0;
            for (int j0 = 0; j0 < bpp; j0 += 16) {
                const int n = min(16, bpp - j0);
                {
                    const uint8_t* s = blk + (long long)t * bpp + j0;
                    uint8_t* d = smem + (t >> 4) * gstride + (t & 15) * 16;
                    for (int i = 0; i < n; ++i) d[i] = __ldg(s + i);
                }
                __syncthreads();
                const bool active = q < n;
                const int jq = active ? q : n - 1;
                Plane p;
                analyse(p, smem + r * gstride + jq, 16, level, r, seg);
                const int hn = __shfl_down_sync(kFull, p.h, 1, 16);
                int pre, total;
                scan_slots(p.psize, active, pre, total);
                uint8_t* dst = row + rec + run + hdr_w + carry;
                const int ph = (int)((uintptr_t)dst & 15);
                if (active) {
                    emit(p, win + ph + pre, r, hn);
                    if (r == 0) {
                        codes[j0 + q] = (uint8_t)p.code;
                        if (po)
                            po[(long long)(j0 + q) * nb + b] =
                                (rec + run + hdr_w + carry + pre)
                                | (p.code << 24);
                    }
                }
                __syncthreads();
                flush(dst, win, ph, total, t);
                carry += total;
                __syncthreads();  // the window and the stage are free again
            }
            for (int k = t; k < hdr_w; k += kThreads) {
                const int hi = 2 * k + 1 < bpp ? codes[2 * k + 1] : 0;
                row[rec + run + k] = (uint8_t)(codes[2 * k] | (hi << 4));
            }
            if (t == 0) {
                bsizes[sb * nb + b] = hdr_w + carry;
                fsizes[sb * nb + b] = carry;
            }
            run += hdr_w + carry;
            __syncthreads();  // codes are rewritten by the next block
        }
    }

    if (t == 0) totals[sb] = run;
    if (rec && t < 4) row[t] = (uint8_t)(t == 0 ? 1 : run >> (8 * (t - 1)));
    if (zero_tail) zero_fill(row + rec + run, row + row_w, t);
}

// Frame mode: record s (rows[s, :totals[s] + 4]) goes behind the header at
// hlen + the sum of the records before it; if zero_tail, the tail up to cap
// is zeroed in n_sb shares (else K1's frame mode has zeroed it); CTA 0
// writes the header (h0, h1 little-endian, hlen <= 16 bytes) and the frame
// length.
__global__ void __launch_bounds__(kThreads)
place_records(const uint8_t* __restrict__ rows, long long row_w,
              const int* __restrict__ totals, int n_sb,
              uint8_t* __restrict__ frame, long long cap,
              unsigned long long h0, unsigned long long h1, int hlen,
              int zero_tail, long long* __restrict__ length) {
    __shared__ long long s_red[2][kThreads / 32];
    const int t = threadIdx.x;
    const int s = blockIdx.x;
    long long before = 0, all = 0;
    for (int i = t; i < n_sb; i += kThreads) {
        const long long v = totals[i] + 4;
        all += v;
        if (i < s) before += v;
    }
#pragma unroll
    for (int o = 16; o; o >>= 1) {
        before += __shfl_xor_sync(kFull, before, o);
        all += __shfl_xor_sync(kFull, all, o);
    }
    if ((t & 31) == 0) {
        s_red[0][t >> 5] = before;
        s_red[1][t >> 5] = all;
    }
    __syncthreads();
    before = all = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) {
        before += s_red[0][w];
        all += s_red[1][w];
    }
    const long long len = hlen + all;
    const uint8_t* rec = rows + s * row_w;
    uint8_t* dst = frame + hlen + before;
    copy_bytes(dst, rec, totals[s] + 4, t);
    if (zero_tail) {
        const long long share = (cap - len + n_sb - 1) / n_sb;
        const long long z0 = min(cap, len + s * share);
        zero_fill(frame + z0, frame + min(cap, z0 + share), t);
    }
    if (s == 0) {
        if (t < hlen)
            frame[t] = (uint8_t)((t < 8 ? h0 >> (8 * t) : h1 >> (8 * (t - 8)))
                                 & 255);
        if (t == 0) *length = len;
    }
}

// A column's short superblock, after encode_superblocks wrote the record of
// its whole blocks into row (totals[s] = *total): one CTA appends the
// 0xFE marker and the partial segment of the rbytes < 256 * bpp bytes past
// those blocks (tail), as codec/encode_np.py's encode_partial: the block
// padded with the tail's last byte; with at least one whole line of 16
// elements, the planes' code nibbles (ALL_SAME 0, else NORMAL 2; no RLE,
// no ALL_RAW), then each plane's first byte (ALL_SAME) or the headers of its
// `lines` whole rows, their minimums and the rows themselves; then the bytes
// past the last whole line, raw. Planes go 16 at a time, a half-warp a
// plane and a lane a row, through analyse at block level 0. Rewrites the
// record's csize and *total.
__global__ void __launch_bounds__(kThreads)
encode_short(const uint8_t* __restrict__ tail, int rbytes, int bpp,
             uint8_t* __restrict__ row, int* __restrict__ total) {
    __shared__ __align__(16) uint8_t st[256 * 16];  // 16 planes' bytes
    __shared__ int s_ps[16];
    __shared__ uint8_t s_code[16];
    const int t = threadIdx.x;
    const int q = t >> 4;  // plane slot of the group
    const int r = t & 15;  // row of the plane
    const int seg = t & 16;
    const int lines = rbytes / (16 * bpp);
    const int nib = (1 + lines) >> 1;  // row-header bytes of a NORMAL plane
    const unsigned whole = (1u << lines) - 1;
    const int base = *total;
    const uint8_t pad = tail[rbytes - 1];
    uint8_t* out = row + 4 + base + 1;  // behind the stream and the marker
    __syncthreads();  // every thread has read *total before it is rewritten
    int carry = lines ? (bpp + 1) / 2 : 0;
    for (int j0 = 0; lines && j0 < bpp; j0 += 16) {
        const int n = min(16, bpp - j0);
        for (int i = 0; i < n; ++i) {
            const int k = t * bpp + j0 + i;
            st[t * 16 + i] = k < rbytes ? tail[k] : pad;
        }
        __syncthreads();
        const bool active = q < n;
        Plane p;
        analyse(p, st + r * 256 + (active ? q : n - 1), 16, 0, r, seg);
        const int hn = __shfl_down_sync(kFull, p.h, 1, 16);
        const int rows_len =
            __shfl_sync(kFull, p.row_off + p.len, lines - 1, 16);
        const unsigned elig = p.elig & whole;
        const bool same = p.code == 0;
        if (r == 0) {
            s_ps[q] = !active ? 0 : same ? 1
                                         : nib + __popc(elig) + rows_len;
            s_code[q] = same ? 0 : 2;
        }
        __syncthreads();
        int pre = 0, group = 0;
        for (int i = 0; i < 16; ++i) {
            pre += i < q ? s_ps[i] : 0;
            group += s_ps[i];
        }
        uint8_t* o = out + carry + pre;
        if (active && same && r == 0) {
            o[0] = (uint8_t)p.x[0];
        } else if (active && !same && r < lines) {
            if (!(r & 1))
                o[r >> 1] = (uint8_t)(p.h | ((r + 1 < lines ? hn : 0) << 4));
            if ((elig >> r) & 1)
                o[nib + __popc(elig & ((1u << r) - 1))] = (uint8_t)p.minb;
            emit_row(p, o + nib + __popc(elig) + p.row_off);
        }
        if (t < (n + 1) / 2)
            out[j0 / 2 + t] = (uint8_t)(
                s_code[2 * t] | (2 * t + 1 < n ? s_code[2 * t + 1] << 4 : 0));
        carry += group;
        __syncthreads();  // st, s_ps and s_code are rewritten next group
    }
    const int done = lines * 16 * bpp;
    for (int i = t; i < rbytes - done; i += kThreads)
        out[carry + i] = tail[done + i];
    if (t == 0) {
        const int run = base + 1 + carry + rbytes - done;
        out[-1] = 0xFE;
        row[1] = (uint8_t)run;
        row[2] = (uint8_t)(run >> 8);
        row[3] = (uint8_t)(run >> 16);
        *total = run;
    }
}

}  // namespace

#ifdef __CUDACC__
// C interface (ctypes). Pointers are device pointers; the launch goes on
// `stream`; the return value is cudaGetLastError() after the launch.

// plane_off is null except in index mode, frame (cap bytes, hlen of them
// the header) except in frame mode; the geometry is the host's launch plan
// (ops/encode_kernel.py launch_plan), smem its shared-memory bytes.
extern "C" int stenos_encode_superblocks(
        const void* data, long long n_sb, int nb, int nb_last, int bpp,
        int level, void* out, long long row_w, int rec, int zero_tail,
        void* totals, void* bsizes, void* fsizes, void* plane_off,
        void* frame, long long cap, int hlen, int tile_blocks, int pad,
        int stage_bytes, int win_off, int codes_off, int smem, void* stream) {
    const Geometry geo{tile_blocks, pad, stage_bytes, win_off, codes_off};
    const auto kernel = nb_last == nb ? encode_superblocks<false>
                                      : encode_superblocks<true>;
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    kernel<<<(unsigned)n_sb, kThreads, smem, (cudaStream_t)stream>>>(
        (const uint8_t*)data, nb, nb_last, bpp, level, (uint8_t*)out, row_w,
        rec, zero_tail, (int*)totals, (int*)bsizes, (int*)fsizes,
        (int*)plane_off, (uint8_t*)frame, cap, hlen, geo);
    return (int)cudaGetLastError();
}

extern "C" int stenos_place_records(const void* rows, long long row_w,
                                    const void* totals, long long n_sb,
                                    void* frame, long long cap,
                                    unsigned long long h0,
                                    unsigned long long h1, int hlen,
                                    int zero_tail, void* length,
                                    void* stream) {
    place_records<<<(unsigned)n_sb, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)rows, row_w, (const int*)totals, (int)n_sb,
        (uint8_t*)frame, cap, h0, h1, hlen, zero_tail, (long long*)length);
    return (int)cudaGetLastError();
}

// tail: the rbytes (1 <= rbytes < 256 * bpp) bytes past the short
// superblock's whole blocks; row and total: its record and stream length
extern "C" int stenos_encode_short(const void* tail, int rbytes, int bpp,
                                   void* row, void* total, void* stream) {
    encode_short<<<1, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)tail, rbytes, bpp, (uint8_t*)row, (int*)total);
    return (int)cudaGetLastError();
}
#endif
