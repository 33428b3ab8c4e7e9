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
//   - Frame mode (the device frame: every record back to back behind the
//     frame header, in one launch): CTA s first zeroes slot s of the
//     frame's capacity (the record bound behind the header) with 16-byte
//     stores, while the other CTAs of its SM analyse; it encodes its
//     superblock into its row of rows (the record's place in the frame, its
//     base, is the sum of the records before it, unknown while it is
//     emitted) and publishes the record's size. Then it places the record
//     of superblock s - lag, lag being the CTAs resident at once (132 SMs x
//     4 on an H100): it finds that record's base by a decoupled look-back
//     and copies it from its row into the frame. The last lag CTAs place
//     their own records too. A CTA that placed its own record at once
//     waited ~20-26 us of its ~115 us for the CTAs before it to finish
//     (their ends spread as much), holding its SM slot: +0.2 ms on a call
//     of 512 MiB; a lag behind, they are all done.
//     The superblock index s is a ticket (an atomic count in the status
//     array), so a CTA waits only on CTAs that started before it, in
//     whatever order blocks are dispatched. Look-back state: one 64-bit
//     word a superblock, flag in the top two bits (0 not ready, 1 the
//     record's size, 2 the inclusive prefix of the sizes), zeroed with the
//     ticket on the stream before the launch, in the same call. The placer
//     of record j reads its size, then the words before it, one warp 32 at
//     a time, back to the nearest inclusive prefix, and publishes j's. The
//     CTA of superblock 0 writes the header, the placer of the last record
//     the frame length.
//     Ordering rule: CTA s makes its zeros and its record's bytes visible
//     (each thread's fence, then a barrier) before it publishes its size;
//     record j is copied only after its placer's look-back has seen j and
//     every record before it published (each inclusive prefix was published
//     after its own look-back saw the records before that one). Record j
//     lies in [base_j, base_j + size_j) with base_j <= j * w and size_j <=
//     w (w the slot's width, a record bound), so inside slots 0..j: every
//     zero under it is in place before it is written, and no record reaches
//     a later CTA's slot, so no later zero can land on it.
//     On an H100 the zeros add ~0.055 ms to K1's ~1.04 ms at 512 MiB; a
//     slice of the slot after each tile's flush cost 0.12 ms and spilled.
//     The placement adds ~0.06 ms to K1 at 512 MiB of sorted int32 and
//     ~0.10 ms on a day's float64 column, where place_records took 0.09
//     and 0.30 ms: the record is read back from device memory, four words
//     a thread in flight (one: +1%; eight spill), and while a CTA copies
//     the other CTAs of its SM do not take up its share. Streaming stores
//     for the zeros and an L2 prefetch of the record did not pay.
// place_records: one CTA per record copies it from its row to its place
//   behind the frame header (its base is the sum of the records before it),
//   zero-fills its share of the tail past the frame's length, and CTA 0
//   writes the header and the frame length. The device frame does not run
//   it (K1's frame mode places its own records); it builds a frame from
//   rows gathered from several cards.
// A batch of frames (kBatch, one frame an image): the grid runs over the F x
//   per superblocks of F frames of per superblocks each, frame f in row f of
//   stride bytes. The ticket runs over the whole grid; superblock g belongs
//   to frame f = g / per as its superblock j = g % per: it zeroes slot j of
//   row f (the last slot up to the row's end), the first writes row f's
//   header, a look-back stops at its frame's first superblock (whose
//   inclusive prefix is its own size), and the placer of a frame's last
//   record writes that frame's length. One launch for the whole batch.
// A column (a 1-D array of any length) ends in a short superblock: K1's
//   last CTA encodes its whole blocks (nb_last of them) into the last row
//   and places that record as any other; encode_short (one CTA) then
//   appends the 0xFE marker and the partial segment of the bytes past them
//   at the frame's length and rewrites the record's csize and the length:
//   two launches, one when the column ends in whole blocks.
//
// Bound: integer instructions and their latency, not bytes. The row analysis
// alone is ~11 32-bit integer instructions an input byte (plane decisions and
// emission come on top): at 64 integer lanes a clock an SM that is ~0.35 ms
// for 512 MiB on an H100 SXM, against ~0.2 ms for its bytes at 3.35 TB/s (the
// input, the records and the sizes, each once). Frame mode moves more: the
// frame's capacity of zeros, ~538 MB, and the records read back and written
// again, ~0.43 ms for all its bytes, as much as its integer bound. The design
// gives every lane of a step work, holds a thread to 64 registers so that 4
// CTAs (32 warps) share an SM and hide one another's shuffle, shared-memory
// and barrier latency, overlaps each tile's load with the previous tile's
// analysis, and writes every output byte once (a frame's records twice: the
// row, then the frame), coalesced.

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
// ragged ends. kU words a thread in flight; with kU > 1 (K1's frame mode)
// src is read through L2 only: another CTA wrote it in the same launch,
// most of it long enough ago to be in device memory again (one word at a
// time, a copy was bound by its latency), and an SM's L1 may hold an older
// copy of a word that straddles two rows.
template <int kU>
__device__ __forceinline__ void copy_bytes(uint8_t* dst, const uint8_t* src,
                                           long long n, int t) {
    auto ld8 = [](const uint8_t* p) { return kU > 1 ? __ldcg(p) : *p; };
    auto ld16 = [](const uint4* p) { return kU > 1 ? __ldcg(p) : *p; };
    const uintptr_t d0 = (uintptr_t)dst, d1 = d0 + n;
    const uintptr_t a0 = min(d1, (d0 + 15) & ~(uintptr_t)15);
    const uintptr_t a1 = max(a0, d1 & ~(uintptr_t)15);
    for (uintptr_t q = d0 + t; q < a0; q += kThreads)
        *(uint8_t*)q = ld8(src + (q - d0));
    for (uintptr_t q = a1 + t; q < d1; q += kThreads)
        *(uint8_t*)q = ld8(src + (q - d0));
    const uint8_t* s0 = src + (a0 - d0);
    const int sh = (int)((uintptr_t)s0 & 15);
    const uint4* sw = reinterpret_cast<const uint4*>(s0 - sh);
    uint4* dw = reinterpret_cast<uint4*>(a0);
    const long long nw = (long long)(a1 - a0) >> 4;
    const int qw = sh >> 2, bits = 8 * (sh & 3);
    for (long long k0 = t; k0 < nw; k0 += kU * kThreads) {
        uint4 lo[kU], hi[kU];
#pragma unroll
        for (int u = 0; u < kU; ++u) {
            const long long k = k0 + u * kThreads;
            if (k < nw) {
                lo[u] = ld16(sw + k);
                // the next word only when the shifted word reaches into it
                // (its start then lies inside the record)
                hi[u] = sh ? ld16(sw + k + 1) : lo[u];
            }
        }
#pragma unroll
        for (int u = 0; u < kU; ++u) {
            const long long k = k0 + u * kThreads;
            if (k >= nw) break;
            const unsigned w[8] = {lo[u].x, lo[u].y, lo[u].z, lo[u].w,
                                   hi[u].x, hi[u].y, hi[u].z, hi[u].w};
            unsigned o[5];
#pragma unroll
            for (int i = 0; i < 5; ++i)
                o[i] = qw == 0 ? w[i] : qw == 1 ? w[i + 1]
                     : qw == 2 ? w[i + 2] : w[min(i + 3, 7)];
            dw[k] = make_uint4(__funnelshift_r(o[0], o[1], bits),
                               __funnelshift_r(o[1], o[2], bits),
                               __funnelshift_r(o[2], o[3], bits),
                               __funnelshift_r(o[3], o[4], bits));
        }
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

// The device frame's arguments in frame mode (frame null in the others):
// the capacity cap behind an hlen-byte header (h0, h1 little-endian, hlen
// <= 16), the length, the look-back status (n_sb words, then the ticket
// count), zeroed before the launch, and the lag (the CTAs resident at once).
// A batch of frames (kBatch) reads per, the superblocks a frame, and
// stride, the bytes from one frame's row to the next (at least cap); cap is
// then a frame's capacity and length holds a length a frame.
struct Frame {
    uint8_t* frame;
    long long cap;
    unsigned long long h0, h1;
    long long* length;
    unsigned long long* status;
    long long lag;
    int hlen;
    int per;
    long long stride;
};

constexpr unsigned long long kSize = 1ull << 62;    // a record's size
constexpr unsigned long long kPrefix = 2ull << 62;  // an inclusive prefix
constexpr unsigned long long kValue = kSize - 1;

__device__ __forceinline__ unsigned long long load_gpu(
        const unsigned long long* p) {
    unsigned long long v;
    asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p)
                 : "memory");
    return v;
}
__device__ __forceinline__ void store_gpu(unsigned long long* p,
                                          unsigned long long v) {
    asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
                 : "memory");
}

// One warp: waits for record j's size, sums the records lo..j-1 before j
// by a decoupled look-back over status (back to the nearest inclusive
// prefix; lo is the first record of j's frame), fences its reads, publishes
// j's inclusive prefix and returns (exclusive prefix, size) on every lane.
__device__ longlong2 look_back(unsigned long long* status, long long j,
                               long long lo, int lane) {
    unsigned long long v;
    while (!((v = load_gpu(status + j)) >> 62)) __nanosleep(64);
    const long long n = (long long)(v & kValue);
    long long before = 0;
    for (long long w = j - 1; w >= lo; w -= 32) {
        const long long i = w - lane;
        // before the frame's first record: an inclusive prefix of 0
        while (!__all_sync(kFull,
                           (v = i >= lo ? load_gpu(status + i) : kPrefix)
                           >> 62))
            __nanosleep(64);
        const unsigned pre = __ballot_sync(kFull, (v >> 62) == 2);
        // the nearest word with a prefix ends the look-back
        const int stop = pre ? __ffs(pre) - 1 : 31;
        long long x = lane <= stop ? (long long)(v & kValue) : 0;
#pragma unroll
        for (int o = 16; o; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
        before += x;
        if (pre) break;
    }
    __threadfence();  // every lane's reads, before the prefix is out
    if (lane == 0) store_gpu(status + j, kPrefix | (before + n));
    return make_longlong2(before, n);
}

// The whole CTA places record j (rows row j, its bytes fenced before its
// size was published) behind its frame's header; the one of a frame's last
// superblock writes that frame's length. A batch (kBatch): record j is
// record j % per of frame j / per, in the frame's row.
template <bool kBatch>
__device__ void place(const Frame& fr, const uint8_t* out, long long row_w,
                      long long j, int t, longlong2& s_rec) {
    if (t < 32) {
        const int f = kBatch ? (int)j / fr.per : 0;
        const long long lo = kBatch ? (long long)f * fr.per : 0;
        longlong2 r = look_back(fr.status, j, lo, t);
        if constexpr (kBatch) {
            // the frame's length here, and the record's place from the
            // first frame's start in s_rec: the copy holds no more
            if (t == 0 && j + 1 == lo + fr.per)
                fr.length[f] = fr.hlen + r.x + r.y;
            r.x += f * fr.stride;
        }
        if (t == 0) s_rec = r;
    }
    __syncthreads();
    const longlong2 r = s_rec;
    copy_bytes<4>(fr.frame + fr.hlen + r.x, out + j * row_w, r.y, t);
    if (!kBatch && t == 0 && j + 1 == gridDim.x)
        *fr.length = fr.hlen + r.x + r.y;
    __syncthreads();  // s_rec is rewritten by the next record
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
// nb_last (the short superblock's whole blocks). kColumn and kFrame are
// template arguments so that the streams, records and index modes run the
// code they ran before columns and frames (64 registers, no spills), as
// the column's one extra live count spills. Frame mode (kFrame, fr): CTA s
// takes superblock s by ticket, first zeroes slot s of the frame's
// capacity behind the header, [hlen + s*w, hlen + (s+1)*w) with w = (cap -
// hlen) / n_sb, and at its end places its record (place_own). A batch of
// frames (kBatch, with kFrame; not a column) is the frame mode's own
// instantiation, so that the frame mode runs the code it ran before it.
template <bool kColumn, bool kFrame, bool kBatch = false>
__global__ void __launch_bounds__(kThreads, 4)
encode_superblocks(const uint8_t* __restrict__ data, int nb, int nb_last,
                   int bpp, int level, uint8_t* __restrict__ out,
                   long long row_w, int rec, int zero_tail,
                   int* __restrict__ totals,
                   int* __restrict__ bsizes, int* __restrict__ fsizes,
                   int* __restrict__ plane_off, Frame fr, Geometry geo) {
    extern __shared__ __align__(16) uint8_t smem[];
    __shared__ int s_ps[2][16];
    __shared__ int s_bstart[kMaxTile + 1];
    __shared__ longlong2 s_rec;  // frame mode: the ticket, then a record

    const int t = threadIdx.x;
    const int lane = t & 31;
    const int q = t >> 4;          // plane slot of the step
    const int r = t & 15;          // row of the plane
    const int seg = lane & 16;     // the half-warp's ballot bits
    long long sb = blockIdx.x;
    if (kFrame) {
        if (t == 0)
            s_rec.x = (long long)atomicAdd(fr.status + gridDim.x, 1ull);
        __syncthreads();
        sb = s_rec.x;
    }
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

    if (kFrame) {  // slot j of its frame's capacity behind the header
        const long long per = kBatch ? fr.per : (long long)gridDim.x;
        const int f = kBatch ? (int)sb / fr.per : 0;
        const long long j = sb - (long long)f * per;
        uint8_t* frame = kBatch ? fr.frame + f * fr.stride : fr.frame;
        const long long w = (fr.cap - fr.hlen) / per;
        // a batch's rows: the last slot runs to the row's end
        zero_fill(frame + fr.hlen + j * w,
                  kBatch && j + 1 == per ? frame + fr.stride
                                         : frame + fr.hlen + (j + 1) * w, t);
        if (j == 0 && t < fr.hlen)
            frame[t] = (uint8_t)(
                (t < 8 ? fr.h0 >> (8 * t) : fr.h1 >> (8 * (t - 8))) & 255);
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
    if (kFrame) {
        __threadfence();  // this thread's zeros and record bytes, then
        __syncthreads();  // the record's size
        if (t == 0) store_gpu(fr.status + sb, kSize | (rec + run));
        // the record a lag behind, whose predecessors are done by now; the
        // last lag CTAs also place their own
        if (sb >= fr.lag)
            place<kBatch>(fr, out, row_w, sb - fr.lag, t, s_rec);
        if (sb + fr.lag >= gridDim.x)
            place<kBatch>(fr, out, row_w, sb, t, s_rec);
    }
}

// Record s (rows[s, :totals[s] + 4]) goes behind the header at hlen + the
// sum of the records before it; the tail up to cap is zeroed in n_sb
// shares; CTA 0 writes the header (h0, h1 little-endian, hlen <= 16 bytes)
// and the frame length.
__global__ void __launch_bounds__(kThreads)
place_records(const uint8_t* __restrict__ rows, long long row_w,
              const int* __restrict__ totals, int n_sb,
              uint8_t* __restrict__ frame, long long cap,
              unsigned long long h0, unsigned long long h1, int hlen,
              long long* __restrict__ length) {
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
    copy_bytes<1>(dst, rec, totals[s] + 4, t);
    const long long share = (cap - len + n_sb - 1) / n_sb;
    const long long z0 = min(cap, len + s * share);
    zero_fill(frame + z0, frame + min(cap, z0 + share), t);
    if (s == 0) {
        if (t < hlen)
            frame[t] = (uint8_t)((t < 8 ? h0 >> (8 * t) : h1 >> (8 * (t - 8)))
                                 & 255);
        if (t == 0) *length = len;
    }
}

// A column's short superblock, after encode_superblocks placed the record
// of its whole blocks (a stream of *total bytes) last in the frame, ending
// at *length: one CTA appends, at *length, the 0xFE marker and the partial
// segment of the rbytes < 256 * bpp bytes past those blocks (tail), as
// codec/encode_np.py's encode_partial: the block
// padded with the tail's last byte; with at least one whole line of 16
// elements, the planes' code nibbles (ALL_SAME 0, else NORMAL 2; no RLE,
// no ALL_RAW), then each plane's first byte (ALL_SAME) or the headers of its
// `lines` whole rows, their minimums and the rows themselves; then the bytes
// past the last whole line, raw. Planes go 16 at a time, a half-warp a
// plane and a lane a row, through analyse at block level 0. Rewrites the
// record's csize and *length.
__global__ void __launch_bounds__(kThreads)
encode_short(const uint8_t* __restrict__ tail, int rbytes, int bpp,
             uint8_t* __restrict__ frame, long long* __restrict__ length,
             const int* __restrict__ total) {
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
    const long long end = *length;
    uint8_t* row = frame + end - 4 - base;  // the record in the frame
    const uint8_t pad = tail[rbytes - 1];
    uint8_t* out = frame + end + 1;  // behind the stream and the marker
    __syncthreads();  // every thread has read *length before it is rewritten
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
        *length = end + 1 + carry + rbytes - done;
    }
}

}  // namespace

#ifdef __CUDACC__
namespace {

// A launch descriptor (ops/encode_kernel.py _Descriptor), built once for
// each (device, instantiation, bpp, nb): the instantiation (kind 0: the
// streams, records and index modes; 1: frame mode; 2: frame mode of a
// column; 3: frame mode of a batch of frames), the host's launch plan
// (ops/encode_kernel.py launch_plan), smem its shared-memory bytes, and lag,
// the CTAs resident at once (stenos_encode_prepare).
struct Descriptor {
    int kind;
    Geometry geo;
    int smem;
    long long lag;
};

auto kernel_of(int kind) {
    return kind == 0 ? encode_superblocks<false, false>
           : kind == 1 ? encode_superblocks<false, true>
           : kind == 2 ? encode_superblocks<true, true>
                       : encode_superblocks<false, true, true>;
}

}  // namespace

// C interface (ctypes). Pointers are device pointers; a launch goes on
// `stream`; the return value is cudaGetLastError() after the launch (a
// CUDA error code for stenos_encode_prepare).

// Once for a descriptor, on its device (the current one): lets its
// instantiation take the most dynamic shared memory the device allows (the
// same value for every descriptor, so their order does not matter) and
// fills in its lag.
extern "C" int stenos_encode_prepare(void* desc, int device) {
    Descriptor* d = (Descriptor*)desc;
    const auto kernel = kernel_of(d->kind);
    cudaFuncAttributes attr;
    int optin, sms, per_sm;
    cudaError_t e;
    if ((e = cudaFuncGetAttributes(&attr, kernel)) != cudaSuccess
        || (e = cudaDeviceGetAttribute(
                &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device))
               != cudaSuccess
        || (e = cudaFuncSetAttribute(
                kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                optin - (int)attr.sharedSizeBytes)) != cudaSuccess
        || (e = cudaDeviceGetAttribute(
                &sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess
        || (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &per_sm, kernel, kThreads, d->smem)) != cudaSuccess)
        return (int)e;
    d->lag = (long long)sms * (per_sm > 0 ? per_sm : 1);
    return 0;
}

// One launch of the descriptor's instantiation. plane_off is null except
// in index mode, which also zeroes each row past its record; frame (cap
// bytes behind an hlen-byte header h0, h1; length; status, n_sb + 1 words
// of scratch) null except in frame mode, where status is zeroed on the
// stream first; nb_last < nb only for a column; per and stride are read by
// a batch of frames only (n_sb / per frames of per superblocks, a row of
// stride bytes and a length each).
extern "C" int stenos_encode_superblocks(
        const void* desc, const void* data, long long n_sb, int nb,
        int nb_last, int bpp, int level, void* out, long long row_w, int rec,
        void* totals, void* bsizes, void* fsizes, void* plane_off,
        void* frame, long long cap, int hlen, unsigned long long h0,
        unsigned long long h1, void* length, void* status, int per,
        long long stride, void* stream) {
    const Descriptor& d = *(const Descriptor*)desc;
    const Frame fr{(uint8_t*)frame, cap, h0, h1, (long long*)length,
                   (unsigned long long*)status, d.lag, hlen, per, stride};
    if (frame) {
        const cudaError_t e = cudaMemsetAsync(status, 0, (n_sb + 1) * 8,
                                              (cudaStream_t)stream);
        if (e != cudaSuccess) return (int)e;
    }
    const auto kernel = kernel_of(d.kind);
    kernel<<<(unsigned)n_sb, kThreads, d.smem, (cudaStream_t)stream>>>(
        (const uint8_t*)data, nb, nb_last, bpp, level, (uint8_t*)out, row_w,
        rec, plane_off != nullptr, (int*)totals, (int*)bsizes, (int*)fsizes,
        (int*)plane_off, fr, d.geo);
    return (int)cudaGetLastError();
}

extern "C" int stenos_place_records(const void* rows, long long row_w,
                                    const void* totals, long long n_sb,
                                    void* frame, long long cap,
                                    unsigned long long h0,
                                    unsigned long long h1, int hlen,
                                    void* length, void* stream) {
    place_records<<<(unsigned)n_sb, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)rows, row_w, (const int*)totals, (int)n_sb,
        (uint8_t*)frame, cap, h0, h1, hlen, (long long*)length);
    return (int)cudaGetLastError();
}

// tail: the rbytes (1 <= rbytes < 256 * bpp) bytes past the short
// superblock's whole blocks; frame and length: the frame K1 wrote, its
// last record the short superblock's whole blocks; total: that record's
// stream length
extern "C" int stenos_encode_short(const void* tail, int rbytes, int bpp,
                                   void* frame, void* length,
                                   const void* total, void* stream) {
    encode_short<<<1, kThreads, 0, (cudaStream_t)stream>>>(
        (const uint8_t*)tail, rbytes, bpp, (uint8_t*)frame,
        (long long*)length, (const int*)total);
    return (int)cudaGetLastError();
}
#endif
