// stenos-tpu native host runtime.
//
// Clean-room implementations (from SPEC.md, written for this project) of the
// host-side hot paths that surround the card's compute pipeline:
//   - LZ4-dry size estimator (method selection; SPEC.md §5)
//   - block-codec stream decoder + row parse for the decode kernel (SPEC.md §3)
//   - the zstd entropy stage's host passes (tables, anchors, literals)
//
// Exposed as a plain C ABI consumed via ctypes (no pybind11 in this image).
// All calls are GIL-free (ctypes releases the GIL), so the Python runtime can
// fan superblocks out over a thread pool.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <cstddef>
#include <thread>
#include <vector>

#define EXPORT extern "C" __attribute__((visibility("default")))

namespace {

inline uint32_t read32(const uint8_t* p) {
    uint32_t v;
    std::memcpy(&v, p, 4);
    return v;  // little-endian hosts only (x86/ARM)
}

// ---------------------------------------------------------------- lz4 dry

constexpr int kHashLog = 8;
constexpr int kMinMatch = 4;
constexpr int kMFLimit = 12;
constexpr int kLastLiterals = 5;
constexpr int kMinLength = 13;
constexpr int kMaxDistance = 65535;
constexpr int kRunMask = 15;
constexpr int kMLMask = 15;
constexpr unsigned kSkipTrigger = 6;

inline uint32_t lz4_hash(uint32_t v) { return (v * 2654435761u) >> 24; }

}  // namespace

EXPORT size_t stn_lz4_guess_size(const uint8_t* d, size_t n, int accel) {
    if (accel < 1) accel = 1;
    size_t count = 0;
    ptrdiff_t anchor = 0;
    const ptrdiff_t nn = (ptrdiff_t)n;
    const ptrdiff_t mflimit = nn - kMFLimit;
    const ptrdiff_t matchlimit = nn - kLastLiterals;

    if (nn >= kMinLength) {
        uint32_t table[1 << kHashLog] = {0};
        table[lz4_hash(read32(d))] = 0;
        ptrdiff_t ip = 1;
        uint32_t forwardH = lz4_hash(read32(d + 1));
        for (;;) {
            // --- find a match
            ptrdiff_t match;
            {
                ptrdiff_t forwardIp = ip;
                ptrdiff_t step = 1;
                unsigned searchMatchNb = (unsigned)accel << kSkipTrigger;
                for (;;) {
                    uint32_t h = forwardH;
                    ip = forwardIp;
                    forwardIp += step;
                    step = (ptrdiff_t)(searchMatchNb++ >> kSkipTrigger);
                    if (forwardIp > mflimit) goto last_literals;
                    match = table[h];
                    forwardH = lz4_hash(read32(d + forwardIp));
                    table[h] = (uint32_t)ip;
                    if (!(match + kMaxDistance < ip ||
                          read32(d + match) != read32(d + ip)))
                        break;
                }
            }
            // --- catch up
            while (ip > anchor && match > 0 && d[ip - 1] == d[match - 1]) {
                --ip;
                --match;
            }
            // --- literals
            {
                ptrdiff_t lit = ip - anchor;
                ++count;
                if (lit >= kRunMask)
                    count += (size_t)(1 + (lit - kRunMask) / 256);  // /256 quirk
                count += (size_t)lit;
            }
            for (;;) {  // next_match
                count += 2;
                ptrdiff_t mc = 0;
                {
                    const ptrdiff_t p = ip + kMinMatch;
                    const ptrdiff_t q = match + kMinMatch;
                    while (p + mc < matchlimit && d[p + mc] == d[q + mc]) ++mc;
                    ip = p + mc;
                }
                if (mc >= kMLMask) {
                    ptrdiff_t mcode = mc - kMLMask;
                    while (mcode >= 4 * 255) {
                        count += 4;
                        mcode -= 4 * 255;
                    }
                    count += (size_t)(1 + mcode / 255);
                }
                anchor = ip;
                if (ip > mflimit) goto last_literals;
                table[lz4_hash(read32(d + ip - 2))] = (uint32_t)(ip - 2);
                uint32_t h = lz4_hash(read32(d + ip));
                match = table[h];
                table[h] = (uint32_t)ip;
                if (match + kMaxDistance >= ip &&
                    read32(d + match) == read32(d + ip)) {
                    ++count;
                    continue;
                }
                ++ip;
                forwardH = lz4_hash(read32(d + ip));
                break;
            }
        }
    }
last_literals: {
    ptrdiff_t lastRun = nn - anchor;
    if (lastRun >= kRunMask)
        count += (size_t)(2 + (lastRun - kRunMask) / 256);
    else
        ++count;
    count += (size_t)lastRun;
}
    return count;
}

// --------------------------------------------------- block stream decode

namespace {

constexpr int ERR_SRC = -2;
constexpr int ERR_INPUT = -4;
constexpr int ERR_DST = -6;

// decode_rle per SPEC §3.2: returns bytes consumed after the 2-byte mask, or
// -1 on overflow. out stride 1.
inline ptrdiff_t rle_row(const uint8_t* src, ptrdiff_t avail, uint8_t* out,
                         uint8_t prev) {
    if (avail < 2) return -1;
    const uint32_t mask = (uint32_t)src[0] | ((uint32_t)src[1] << 8);
    ptrdiff_t pos = 2;
    for (int i = 0; i < 16; ++i) {
        if ((mask >> i) & 1u) {
            out[i] = prev;
        } else {
            if (pos >= avail) return -1;
            out[i] = src[pos++];
        }
        prev = out[i];
    }
    return pos;
}

inline void unpack_row(const uint8_t* src, int bits, uint8_t* out) {
    // two groups of 8 values, LE bit stream of `bits` bytes per group
    for (int g = 0; g < 2; ++g) {
        uint64_t word = 0;
        for (int k = 0; k < bits; ++k)
            word |= (uint64_t)src[g * bits + k] << (8 * k);
        const uint64_t m = (1ull << bits) - 1;
        for (int j = 0; j < 8; ++j)
            out[g * 8 + j] = (uint8_t)((word >> (bits * j)) & m);
    }
}

// Decode one NORMAL/NORMAL_RLE plane (lines rows) flat into out[16*lines].
// Returns consumed bytes or -1.
ptrdiff_t decode_plane(const uint8_t* src, ptrdiff_t avail, int lines,
                       bool rle_mins, uint8_t* out) {
    const int hdr_len = lines / 2 + (lines & 1);
    if (hdr_len > avail) return -1;
    uint8_t headers[16];
    for (int i = 0; i < hdr_len; ++i) {
        headers[2 * i] = src[i] & 15;
        if (2 * i + 1 < 16) headers[2 * i + 1] = src[i] >> 4;
    }
    ptrdiff_t pos = hdr_len;
    uint8_t mins[16] = {0};
    if (rle_mins) {
        ptrdiff_t r = rle_row(src + pos, avail - pos, mins, 0);
        if (r < 0) return -1;
        pos += r;
    } else {
        for (int i = 0; i < lines; ++i) {
            const uint8_t h = headers[i];
            if (h != 6 && h != 7 && h != 15) {
                if (pos >= avail) return -1;
                mins[i] = src[pos++];
            }
        }
    }
    static const int kBits[16] = {0, 1, 2, 3, 4, 5, 6, 8,
                                  0, 1, 2, 3, 4, 5, 6, 8};
    for (int r = 0; r < lines; ++r) {
        const uint8_t h = headers[r];
        uint8_t* dst = out + 16 * r;
        const uint8_t prev_last = r ? dst[-1] : 0;
        if (h == 6) {
            uint8_t tmp[16];
            ptrdiff_t c = rle_row(src + pos, avail - pos, tmp, 0);
            if (c < 0) return -1;
            pos += c;
            uint8_t acc = prev_last;
            for (int i = 0; i < 16; ++i) dst[i] = acc = (uint8_t)(acc + tmp[i]);
        } else if (h == 7) {
            ptrdiff_t c = rle_row(src + pos, avail - pos, dst, prev_last);
            if (c < 0) return -1;
            pos += c;
        } else if (h == 15) {
            if (pos + 16 > avail) return -1;
            std::memcpy(dst, src + pos, 16);
            pos += 16;
        } else {
            const int bits = kBits[h];
            const uint8_t mn = mins[r];
            uint8_t vals[16] = {0};
            if (bits) {
                if (pos + 2 * bits > avail) return -1;
                unpack_row(src + pos, bits, vals);
                pos += 2 * bits;
            }
            if (h < 8) {
                for (int i = 0; i < 16; ++i) dst[i] = (uint8_t)(vals[i] + mn);
            } else {
                uint8_t acc = prev_last;
                for (int i = 0; i < 16; ++i)
                    dst[i] = acc = (uint8_t)(acc + vals[i] + mn);
            }
        }
    }
    return pos;
}

// intra-block LZ decode (SPEC §3.5); returns consumed or -1.
ptrdiff_t lz_block(const uint8_t* src, ptrdiff_t avail, size_t bpp,
                   uint8_t* dst) {
    size_t B;
    if (bpp % 8 == 0)
        B = 8;
    else if (bpp % 4 == 0 || bpp <= 2)
        B = 4;
    else
        return -1;
    if (bpp > 512) return -1;
    const size_t cnt = (256 * bpp) / B;
    ptrdiff_t pos = 0;
    size_t w = 0;
    for (size_t i = 0; i < cnt; i += 8) {
        if (pos + 2 > avail) return -1;
        const uint8_t anchor = src[pos++];
        if (anchor == 0) {
            if (pos + (ptrdiff_t)(8 * B) > avail) return -1;
            std::memcpy(dst + w, src + pos, 8 * B);
            pos += 8 * B;
            w += 8 * B;
            continue;
        }
        for (int j = 0; j < 8; ++j) {
            if ((anchor >> j) & 1) {
                uint32_t off = src[pos] & 127u;
                const bool big = src[pos] > 127u;
                ++pos;
                if (big) {
                    if (pos >= avail) return -1;
                    off |= (uint32_t)src[pos++] << 7;
                }
                if ((size_t)off * B > w) return -1;
                std::memcpy(dst + w, dst + w - off * B, B);
                w += B;
            } else {
                if (pos + (ptrdiff_t)B > avail) return -1;
                std::memcpy(dst + w, src + pos, B);
                pos += B;
                w += B;
            }
        }
    }
    return pos;
}

}  // namespace

// Decode a block-codec stream (method 1/5 payload). Returns consumed bytes
// or a negative error.
EXPORT ptrdiff_t stn_block_decode(const uint8_t* src, size_t size, size_t bpp,
                                  size_t nbytes, uint8_t* dst,
                                  uint8_t* scratch /* >= 256*bpp */) {
    if (nbytes == 0 || size == 0) return 0;
    const ptrdiff_t n = (ptrdiff_t)size;
    const size_t hdr_w = (bpp + 1) / 2;
    const size_t block_size = 256 * bpp;
    const size_t nb = nbytes == block_size ? 1 : nbytes / block_size;
    ptrdiff_t pos = 0;

    for (size_t b = 0; b < nb; ++b) {
        uint8_t* out = dst + b * block_size;
        if (pos >= n) return ERR_SRC;
        const uint8_t marker = src[pos];
        if (marker == 252) {  // BLOCK_COPY
            ++pos;
            if (pos + (ptrdiff_t)block_size > n) return ERR_SRC;
            std::memcpy(out, src + pos, block_size);
            pos += block_size;
            continue;
        }
        if (marker == 253) {  // BLOCK_LZ
            ++pos;
            ptrdiff_t c = lz_block(src + pos, n - pos, bpp, out);
            if (c < 0) return ERR_INPUT;
            pos += c;
            continue;
        }
        if (pos + (ptrdiff_t)hdr_w >= n) return ERR_SRC;
        const uint8_t* codes = src + pos;
        pos += hdr_w;
        for (size_t p = 0; p < bpp; ++p) {
            const int code = (codes[p >> 1] >> (4 * (p & 1))) & 15;
            uint8_t* plane = scratch + p * 256;
            if (code == 0) {  // ALL_SAME
                if (pos >= n) return ERR_SRC;
                std::memset(plane, src[pos++], 256);
            } else if (code == 1) {  // ALL_RAW
                if (pos + 256 > n) return ERR_SRC;
                std::memcpy(plane, src + pos, 256);
                pos += 256;
            } else if (code == 2 || code == 3) {
                ptrdiff_t c = decode_plane(src + pos, n - pos, 16, code == 3,
                                           plane);
                if (c < 0) return ERR_SRC;
                pos += c;
            } else {
                return ERR_INPUT;
            }
        }
        // unshuffle block: out[e*bpp + p] = plane[p][e]
        for (size_t p = 0; p < bpp; ++p) {
            const uint8_t* plane = scratch + p * 256;
            for (size_t e = 0; e < 256; ++e) out[e * bpp + p] = plane[e];
        }
    }

    const size_t rem = nbytes - nb * block_size;
    if (rem) {
        if (pos == n) return ERR_SRC;
        if (src[pos++] != 254) return ERR_INPUT;  // BLOCK_PARTIAL
        uint8_t* out = dst + nb * block_size;
        const size_t line_size = 16 * bpp;
        const size_t lines = rem / line_size;
        if (lines) {
            if (pos + (ptrdiff_t)hdr_w >= n) return ERR_SRC;
            const uint8_t* codes = src + pos;
            pos += hdr_w;
            for (size_t p = 0; p < bpp; ++p) {
                const int code = (codes[p >> 1] >> (4 * (p & 1))) & 15;
                uint8_t* plane = scratch + p * 256;
                if (code == 0) {
                    if (pos >= n) return ERR_SRC;
                    std::memset(plane, src[pos++], 16 * lines);
                } else if (code == 2) {
                    ptrdiff_t c = decode_plane(src + pos, n - pos, (int)lines,
                                               false, plane);
                    if (c < 0) return ERR_SRC;
                    pos += c;
                } else {
                    return ERR_INPUT;
                }
            }
            for (size_t p = 0; p < bpp; ++p) {
                const uint8_t* plane = scratch + p * 256;
                for (size_t e = 0; e < 16 * lines; ++e)
                    out[e * bpp + p] = plane[e];
            }
        }
        const size_t tail = rem - lines * line_size;
        if (tail) {
            if (pos + (ptrdiff_t)tail > n) return ERR_SRC;
            std::memcpy(out + lines * line_size, src + pos, tail);
            pos += tail;
        }
    }
    return pos;
}

// ------------------------------------------------------- huffman tables
//
// Batched length-limited Huffman code-length construction for the device
// entropy stage (SPEC: RFC 8878 §4.2.1, max length 11). One call builds the
// lengths for every 128 KiB block of a frame; canonical code assignment
// stays in numpy (cheap).

namespace {

struct HuffNode {
    int64_t count;
    int32_t id;  // tie-break: lower id first (matches python heapq order)
    int32_t sym;
    int32_t left, right;  // -1 for leaves
};

}  // namespace

EXPORT void stn_huff_lengths(const int64_t* counts, size_t n_blocks,
                             int32_t max_bits, uint8_t* lengths /*n*256*/) {
    for (size_t b = 0; b < n_blocks; ++b) {
        const int64_t* cnt = counts + b * 256;
        uint8_t* len = lengths + b * 256;
        std::memset(len, 0, 256);
        HuffNode nodes[512];
        int heap[512];
        int n_nodes = 0, heap_n = 0;
        auto heap_less = [&](int a, int c) {
            if (nodes[a].count != nodes[c].count)
                return nodes[a].count < nodes[c].count;
            return nodes[a].id < nodes[c].id;
        };
        auto heap_push = [&](int v) {
            int i = heap_n++;
            heap[i] = v;
            while (i && heap_less(heap[i], heap[(i - 1) / 2])) {
                int t = heap[i]; heap[i] = heap[(i - 1) / 2];
                heap[(i - 1) / 2] = t;
                i = (i - 1) / 2;
            }
        };
        auto heap_pop = [&]() {
            int top = heap[0];
            heap[0] = heap[--heap_n];
            int i = 0;
            for (;;) {
                int l = 2 * i + 1, r = 2 * i + 2, m = i;
                if (l < heap_n && heap_less(heap[l], heap[m])) m = l;
                if (r < heap_n && heap_less(heap[r], heap[m])) m = r;
                if (m == i) break;
                int t = heap[i]; heap[i] = heap[m]; heap[m] = t;
                i = m;
            }
            return top;
        };
        int n_used = 0, only = -1;
        for (int s = 0; s < 256; ++s) {
            if (cnt[s] > 0) {
                nodes[n_nodes] = {cnt[s], s, s, -1, -1};
                heap_push(n_nodes++);
                ++n_used;
                only = s;
            }
        }
        if (n_used == 0) continue;
        if (n_used == 1) { len[only] = 1; continue; }
        int next_id = 256;
        while (heap_n > 1) {
            int a = heap_pop(), c = heap_pop();
            nodes[n_nodes] = {nodes[a].count + nodes[c].count, next_id++, -1,
                              a, c};
            heap_push(n_nodes++);
        }
        // assign depths iteratively
        int stack[512], depth[512];
        int sp = 0;
        stack[sp] = heap[0]; depth[sp++] = 0;
        while (sp) {
            int nd = stack[--sp];
            int d = depth[sp];
            if (nodes[nd].left < 0) {
                len[nodes[nd].sym] = (uint8_t)(d > 0 ? d : 1);
            } else {
                stack[sp] = nodes[nd].left; depth[sp++] = d + 1;
                stack[sp] = nodes[nd].right; depth[sp++] = d + 1;
            }
        }
        // length-limit + Kraft repair (mirrors entropy/huffman.py)
        int maxl = 0;
        for (int s = 0; s < 256; ++s) if (len[s] > maxl) maxl = len[s];
        if (maxl <= max_bits) continue;
        for (int s = 0; s < 256; ++s)
            if (len[s] > max_bits) len[s] = (uint8_t)max_bits;
        const int64_t unit = 1ll << max_bits;
        int64_t k = 0;
        for (int s = 0; s < 256; ++s)
            if (len[s]) k += 1ll << (max_bits - len[s]);
        // ascending-frequency symbol order
        int order[256];
        int n_ord = 0;
        for (int s = 0; s < 256; ++s) if (cnt[s] > 0) order[n_ord++] = s;
        for (int i = 1; i < n_ord; ++i) {  // stable insertion by count
            int v = order[i]; int j = i - 1;
            while (j >= 0 && cnt[order[j]] > cnt[v]) {
                order[j + 1] = order[j]; --j;
            }
            order[j + 1] = v;
        }
        while (k > unit) {
            for (int i = 0; i < n_ord && k > unit; ++i) {
                int s = order[i];
                if (len[s] && len[s] < max_bits) {
                    k -= (1ll << (max_bits - len[s])) >> 1;
                    ++len[s];
                }
            }
        }
        bool changed = true;
        while (k < unit && changed) {
            changed = false;
            for (int i = n_ord - 1; i >= 0; --i) {
                int s = order[i];
                if (len[s] > 1) {
                    int64_t gain = 1ll << (max_bits - len[s]);
                    if (k + gain <= unit) {
                        --len[s]; k += gain; changed = true;
                        if (k == unit) break;
                    }
                }
            }
        }
    }
}

// --------------------------------------------- huffman tree descriptions
//
// FSE (tANS) compression of huffman weights per RFC 8878 §4.2.1.2 — the
// C++ twin of entropy/fse.py (outputs must be byte-identical; tests compare).

namespace {

struct BitW {
    uint64_t acc = 0;
    int nbits = 0;
    uint8_t* out;
    int n = 0;
    void add(uint64_t v, int nb) {
        acc |= (v & ((1ull << nb) - 1)) << nbits;
        nbits += nb;
        if (nbits >= 32) {  // word flush: 4 LE bytes at once (same stream
                            // bytes as the old byte loop, ~2x the encode)
            const uint32_t w = (uint32_t)acc;
            std::memcpy(out + n, &w, 4);
            n += 4;
            acc >>= 32;
            nbits -= 32;
        }
    }
    void pad() {
        while (nbits >= 8) { out[n++] = (uint8_t)acc; acc >>= 8; nbits -= 8; }
        if (nbits) { out[n++] = (uint8_t)(acc & ((1 << nbits) - 1));
                     acc = 0; nbits = 0; }
    }
    void close() { add(1, 1); pad(); }
};

inline int highbit(uint32_t v) { return 31 - __builtin_clz(v); }

// normalize counts to sum 1<<tl, every present symbol >= 1
inline void fse_normalize(const int64_t* cnt, int n_sym, int tl,
                          int64_t total, int32_t* norm) {
    const int64_t size = 1ll << tl;
    int n_present = 0;
    int only = -1;
    for (int s = 0; s < n_sym; ++s)
        if (cnt[s] > 0) { ++n_present; only = s; }
    for (int s = 0; s < n_sym; ++s) norm[s] = 0;
    if (n_present == 1) { norm[only] = (int32_t)size; return; }
    int64_t sum = 0;
    for (int s = 0; s < n_sym; ++s) {
        if (cnt[s] > 0) {
            int64_t v = cnt[s] * size / total;
            norm[s] = (int32_t)(v > 1 ? v : 1);
            sum += norm[s];
        }
    }
    int64_t diff = size - sum;
    if (diff > 0) {
        // round-robin over symbols by descending count (stable)
        int order[256];
        int n_ord = 0;
        for (int s = 0; s < n_sym; ++s) if (cnt[s] > 0) order[n_ord++] = s;
        for (int i = 1; i < n_ord; ++i) {
            int v = order[i]; int j = i - 1;
            while (j >= 0 && cnt[order[j]] < cnt[v]) {
                order[j + 1] = order[j]; --j;
            }
            order[j + 1] = v;
        }
        int i = 0;
        while (diff > 0) { norm[order[i % n_ord]] += 1; --diff; ++i; }
    }
    while (diff < 0) {
        // take from the symbol with most slack (norm - ideal share)
        double best = -1; int bs = -1;
        for (int s = 0; s < n_sym; ++s) {
            if (norm[s] > 1) {
                double slack = norm[s] - (double)cnt[s] * size / total;
                if (slack > best) { best = slack; bs = s; }
            }
        }
        int64_t take = -diff < norm[bs] - 1 ? -diff : norm[bs] - 1;
        norm[bs] -= (int32_t)take;
        diff += take;
    }
}

inline void fse_write_ncount(BitW& bw, const int32_t* norm, int tl,
                             int max_symbol) {
    bw.add(tl - 5, 4);
    const int size = 1 << tl;
    int remaining = size + 1;
    int threshold = size;
    int nb_bits = tl + 1;
    int s = 0;
    bool previous0 = false;
    while (remaining > 1 && s <= max_symbol) {
        if (previous0) {
            int start = s;
            while (s <= max_symbol && norm[s] == 0) ++s;
            int run = s - start;
            while (run >= 3) { bw.add(3, 2); run -= 3; }
            bw.add(run, 2);
            if (s > max_symbol) break;
        }
        int count = norm[s++];
        const int maxv = (2 * threshold - 1) - remaining;
        remaining -= count < 0 ? 1 : count;
        int value = count + 1;
        if (value >= threshold) value += maxv;
        bw.add(value, value < maxv ? nb_bits - 1 : nb_bits);
        previous0 = (count == 0);
        while (remaining < threshold) { --nb_bits; threshold >>= 1; }
    }
    bw.pad();
}

struct FseEnc {
    int tl;
    int32_t state_table[64];
    int64_t dnb[16], dfs[16];
    int64_t value = 0;
    void build(const int32_t* norm, int n_sym, int tlog) {
        tl = tlog;
        const int size = 1 << tl;
        int spread[64];
        int high = size - 1;
        for (int ssym = 0; ssym < n_sym; ++ssym)
            if (norm[ssym] == -1) spread[high--] = ssym;
        const int step = (size >> 1) + (size >> 3) + 3;
        const int mask = size - 1;
        int pos = 0;
        for (int ssym = 0; ssym < n_sym; ++ssym) {
            for (int i = 0; i < norm[ssym]; ++i) {
                spread[pos] = ssym;
                pos = (pos + step) & mask;
                while (pos > high) pos = (pos + step) & mask;
            }
        }
        int64_t cumul[17];
        cumul[0] = 0;
        for (int ssym = 0; ssym < n_sym; ++ssym)
            cumul[ssym + 1] = cumul[ssym] +
                (norm[ssym] == -1 ? 1 : (norm[ssym] > 0 ? norm[ssym] : 0));
        int64_t cc[17];
        for (int i = 0; i <= n_sym; ++i) cc[i] = cumul[i];
        for (int u = 0; u < size; ++u)
            state_table[cc[spread[u]]++] = size + u;
        int64_t total = 0;
        for (int ssym = 0; ssym < n_sym; ++ssym) {
            int c = norm[ssym];
            if (c == -1 || c == 1) {
                dnb[ssym] = ((int64_t)tl << 16) - (1ll << tl);
                dfs[ssym] = total - 1;
                total += 1;
            } else if (c == 0) {
                dnb[ssym] = (((int64_t)tl + 1) << 16) - (1ll << tl);
                dfs[ssym] = total - 1;
            } else {
                int mbo = tl - highbit(c - 1);
                dnb[ssym] = ((int64_t)mbo << 16) - ((int64_t)c << mbo);
                dfs[ssym] = total - c;
                total += c;
            }
        }
    }
    void init_state(int ssym) {
        int nb = (int)((dnb[ssym] + (1 << 15)) >> 16);
        int64_t v = ((int64_t)nb << 16) - dnb[ssym];
        value = state_table[(v >> nb) + dfs[ssym]];
    }
    void encode(BitW& bw, int ssym) {
        int nb = (int)((value + dnb[ssym]) >> 16);
        bw.add((uint64_t)value, nb);
        value = state_table[(value >> nb) + dfs[ssym]];
    }
    void flush(BitW& bw) { bw.add((uint64_t)value, tl); }
};

// full tree description for one block's lengths; returns size or 0 (caller
// falls back to raw literals for this block)
inline int huff_tree_desc(const uint8_t* len, uint8_t* out) {
    int maxlen = 0, last = -1;
    for (int s = 0; s < 256; ++s)
        if (len[s]) { last = s; if (len[s] > maxlen) maxlen = len[s]; }
    if (last < 0) return 0;
    int8_t w[256];
    for (int s = 0; s < 256; ++s)
        w[s] = len[s] ? (int8_t)(maxlen + 1 - len[s]) : 0;
    const int n_tx = last;  // transmitted weights (last is implicit)
    // try FSE (table log 6)
    int fse_size = 0;
    uint8_t fse_buf[256];
    if (n_tx >= 2) {
        int64_t cnt[16] = {0};
        int max_w = 0;
        for (int i = 0; i < n_tx; ++i) {
            ++cnt[w[i]];
            if (w[i] > max_w) max_w = w[i];
        }
        int distinct = 0;
        for (int v = 0; v <= max_w; ++v) if (cnt[v]) ++distinct;
        if (distinct >= 2) {
            int32_t norm[16];
            fse_normalize(cnt, max_w + 1, 6, n_tx, norm);
            BitW bw{};
            bw.out = fse_buf;
            fse_write_ncount(bw, norm, 6, max_w);
            FseEnc e1, e2;
            e1.build(norm, max_w + 1, 6);
            e2.build(norm, max_w + 1, 6);
            int ip = n_tx;
            if (n_tx & 1) {
                e1.init_state(w[ip - 1]);
                e2.init_state(w[ip - 2]);
                e1.encode(bw, w[ip - 3]);
                ip -= 3;
            } else {
                e2.init_state(w[ip - 1]);
                e1.init_state(w[ip - 2]);
                ip -= 2;
            }
            while (ip > 0) {
                e2.encode(bw, w[ip - 1]);
                e1.encode(bw, w[ip - 2]);
                ip -= 2;
            }
            e2.flush(bw);
            e1.flush(bw);
            bw.close();
            fse_size = bw.n;
        }
    }
    const int direct_size = (n_tx + 1) / 2;
    if (fse_size && fse_size < 128 && fse_size < direct_size + 1) {
        out[0] = (uint8_t)fse_size;
        std::memcpy(out + 1, fse_buf, fse_size);
        return 1 + fse_size;
    }
    if (last <= 127) {
        out[0] = (uint8_t)(127 + n_tx);
        for (int i = 0; i < n_tx; i += 2) {
            int hi = w[i];
            int lo = i + 1 < n_tx ? w[i + 1] : 0;
            out[1 + i / 2] = (uint8_t)((hi << 4) | lo);
        }
        return 1 + direct_size;
    }
    if (fse_size && fse_size < 128) {
        out[0] = (uint8_t)fse_size;
        std::memcpy(out + 1, fse_buf, fse_size);
        return 1 + fse_size;
    }
    return 0;
}

}  // namespace

EXPORT void stn_huff_tree_descs(const uint8_t* lengths, size_t n_blocks,
                                uint8_t* out /* n*132 */,
                                int32_t* out_sizes) {
    for (size_t b = 0; b < n_blocks; ++b)
        out_sizes[b] = huff_tree_desc(lengths + b * 256, out + b * 132);
}

// ------------------------------------------------- row-level parse (decode)
//
// Uniform row-record index for the v2 device decoder: EVERY construct of the
// format becomes 16 rows of (header, min, offset):
//   bitpack/RLE/raw rows  -> their own header + payload offset
//   ALL_SAME plane        -> 16 rows with header 0 (memset) and min = value
//   ALL_RAW plane         -> 16 raw rows (header 15) at po + 16*r
//   LZ / COPY blocks      -> decoded+shuffled on host, inlined into the
//                            virtual stream as raw rows
// NORMAL_RLE min vectors are resolved here (they are 16 bytes each), so the
// device kernel needs no plane-level logic at all. Offsets are monotone
// non-decreasing in stream order — the contract of ops/compact.expand.

namespace {

// Packed-row-record plane parse: rowtab[r * rt_stride] = rel|hdr<<10|min<<14.
inline ptrdiff_t parse_plane_rows_packed(const uint8_t* src, ptrdiff_t avail,
                                         bool rle_mins, int32_t* rowtab,
                                         size_t rt_stride) {
    if (avail < 8) return -1;
    uint8_t headers[16];
    for (int i = 0; i < 8; ++i) {
        headers[2 * i] = src[i] & 15;
        headers[2 * i + 1] = src[i] >> 4;
    }
    ptrdiff_t pos = 8;
    uint8_t mins[16] = {0};
    if (rle_mins) {
        ptrdiff_t r = rle_row(src + pos, avail - pos, mins, 0);
        if (r < 0) return -1;
        pos += r;
    } else {
        for (int i = 0; i < 16; ++i) {
            const uint8_t h = headers[i];
            if (h != 6 && h != 7 && h != 15) {
                if (pos >= avail) return -1;
                mins[i] = src[pos++];
            }
        }
    }
    static const int kSize[16] = {0, 2, 4, 6, 8, 10, 12, -1,
                                  0, 2, 4, 6, 8, 10, 12, 16};
    for (int r = 0; r < 16; ++r) {
        const uint8_t h = headers[r];
        rowtab[r * rt_stride] =
            (int32_t)pos | ((int32_t)h << 10) | ((int32_t)mins[r] << 14);
        if (h == 6 || h == 7) {
            if (pos + 2 > avail) return -1;
            const uint32_t mask =
                (uint32_t)src[pos] | ((uint32_t)src[pos + 1] << 8);
            pos += 2 + __builtin_popcount(~mask & 0xFFFFu);
        } else {
            pos += kSize[h];
        }
        if (pos > avail) return -1;
    }
    return pos;
}

// One full method-BLOCK superblock's row index (see stn_parse_rows_ptrs):
// its virtual payload into vb (row_bytes, zeros past it), plane offsets into
// po (P), row records into rt (16, P); its virtual length into *vlen, and
// the read position after its last block into *end (when given).
ptrdiff_t parse_superblock_rows(const uint8_t* src, ptrdiff_t n, size_t bpp,
                                size_t sb, size_t row_bytes, uint8_t* vb,
                                int32_t* po, int32_t* rt, int64_t* vlen,
                                uint8_t* scratch, ptrdiff_t* end = nullptr) {
    const size_t hdr_w = (bpp + 1) / 2;
    const size_t block_size = 256 * bpp;
    const size_t nb = sb / block_size;
    const size_t P = nb * bpp;
    ptrdiff_t pos = 0;    // read position in src
    size_t vpos = 0;      // write position in vb
    ptrdiff_t seg = 0;    // start of pending verbatim segment
    for (size_t b = 0; b < nb; ++b) {
        if (pos >= n) return ERR_SRC;
        const uint8_t marker = src[pos];
        int32_t* bpo = po + b * bpp;
        if (marker == 252 || marker == 253) {  // COPY / LZ -> inline
            const size_t keep = (size_t)(pos - seg);
            if (vpos + keep + block_size > row_bytes) return ERR_INPUT;
            // the packed plane index keeps codes in bits 24+; virtual
            // offsets must stay within 24 bits (LZ inlining can grow the
            // virtual stream past csize) — fall back to host decode if not
            if (vpos + keep + block_size > 0xFFFFFF) return ERR_INPUT;
            std::memcpy(vb + vpos, src + seg, keep);
            vpos += keep;
            ++pos;
            uint8_t* dec = scratch;
            if (marker == 252) {
                if (pos + (ptrdiff_t)block_size > n) return ERR_SRC;
                std::memcpy(dec, src + pos, block_size);
                pos += block_size;
            } else {
                ptrdiff_t c = lz_block(src + pos, n - pos, bpp, dec);
                if (c < 0) return ERR_INPUT;
                pos += c;
            }
            seg = pos;
            for (size_t p = 0; p < bpp; ++p) {
                uint8_t* dst = vb + vpos + p * 256;
                for (size_t e = 0; e < 256; ++e) dst[e] = dec[e * bpp + p];
                // inlined planes are raw 256-byte payloads: plane code 1
                // (ALL_RAW) packed in bits 24-25 for the derive-index
                // decode kernel; offsets stay in the low 24 bits
                bpo[p] = (int32_t)(vpos + p * 256) | (1 << 24);
                for (int r = 0; r < 16; ++r)
                    rt[(size_t)r * P + b * bpp + p] =
                        (int32_t)(r * 16) | (15 << 10);
            }
            vpos += block_size;
            continue;
        }
        if (pos + (ptrdiff_t)hdr_w >= n) return ERR_SRC;
        const uint8_t* codes = src + pos;
        const int64_t vdelta = (int64_t)vpos - seg;
        pos += hdr_w;
        // 24-bit bound for packed offsets (see the inline-plane case);
        // a block advances pos by at most hdr_w + bpp*257 < block_size+512
        if (pos + vdelta + (int64_t)block_size + 512 > 0xFFFFFF)
            return ERR_INPUT;
        for (size_t p = 0; p < bpp; ++p) {
            const int code = (codes[p >> 1] >> (4 * (p & 1))) & 15;
            const size_t pg = b * bpp + p;
            bpo[p] = (int32_t)(pos + vdelta) | ((int32_t)code << 24);
            int32_t* prt = rt + pg;
            if (code == 0) {  // ALL_SAME
                if (pos >= n) return ERR_SRC;
                const int32_t v = src[pos++];
                const int32_t rec = 1 | (v << 14);
                for (int r = 0; r < 16; ++r) prt[(size_t)r * P] = rec;
            } else if (code == 1) {  // ALL_RAW
                if (pos + 256 > n) return ERR_SRC;
                for (int r = 0; r < 16; ++r)
                    prt[(size_t)r * P] = (int32_t)(r * 16) | (15 << 10);
                pos += 256;
            } else if (code == 2 || code == 3) {
                int32_t tmp[16];
                ptrdiff_t c = parse_plane_rows_packed(
                    src + pos, n - pos, code == 3, tmp, 1);
                if (c < 0) return ERR_SRC;
                for (int r = 0; r < 16; ++r) prt[(size_t)r * P] = tmp[r];
                pos += c;
            } else {
                return ERR_INPUT;
            }
        }
    }
    if (end) *end = pos;
    const size_t keep = (size_t)(pos - seg);
    if (vpos + keep > row_bytes) return ERR_INPUT;
    std::memcpy(vb + vpos, src + seg, keep);
    vpos += keep;
    std::memset(vb + vpos, 0, row_bytes - vpos);
    // virtual length can EXCEED csize when LZ/COPY blocks (markers
    // 252/253) were inlined as full 256*bpp planes; consumers must use
    // this, not csize, to bound the virtual stream
    *vlen = (int64_t)vpos;
    return 0;
}

}  // namespace

// Batched full-superblock parse for the decode kernel (stn_parse_rows_ptrs):
// for each of n_sb method-BLOCK payloads (csizes[i] bytes, all decoding to
// exactly sb bytes) it writes
//   vbufs    (n_sb, row_bytes)  virtual payload (LZ/COPY blocks replaced
//                               inline by their decoded shuffled planes)
//   plane_off(n_sb, P)          virtual plane start offsets
//   rowtab   (n_sb, 16, P)      packed row records rel | hdr<<10 | min<<14
// P = sb/256.

namespace {

// f(i) for i in [0, n), contiguous ranges on up to `threads` threads
template <class F>
void parallel_ranges(size_t n, int threads, F&& f) {
    const size_t t = std::max<size_t>(1, std::min<size_t>(n, threads));
    const size_t per = (n + t - 1) / t;
    std::vector<std::thread> pool;
    for (size_t k = 1; k < t; ++k)
        pool.emplace_back([&, k] {
            for (size_t i = k * per; i < std::min(n, (k + 1) * per); ++i) f(i);
        });
    for (size_t i = 0; i < std::min(n, per); ++i) f(i);
    for (auto& th : pool) th.join();
}

}  // namespace

// The same over payloads anywhere in memory, on up to `threads` threads:
// payload i is csizes[i] bytes at address srcs[i] (a frame's METHOD_BLOCK
// payload, or the unpacked residual of a METHOD_BLOCK_ZSTD one). Returns 0,
// or -(i + 1) << 8 | -error for the first payload i that fails.
EXPORT ptrdiff_t stn_parse_rows_ptrs(
    const int64_t* srcs, const int64_t* csizes, size_t n_sb, size_t bpp,
    size_t sb, size_t row_bytes, uint8_t* vbufs, int32_t* plane_off,
    int32_t* rowtab, int64_t* vlens, int threads) {
    const size_t P = sb / 256;
    std::vector<ptrdiff_t> err(n_sb, 0);
    parallel_ranges(n_sb, threads, [&](size_t i) {
        thread_local std::vector<uint8_t> scratch;
        scratch.resize(512 * bpp + 16);
        err[i] = parse_superblock_rows(
            (const uint8_t*)(intptr_t)srcs[i], (ptrdiff_t)csizes[i], bpp, sb,
            row_bytes, vbufs + i * row_bytes, plane_off + i * P,
            rowtab + i * 16 * P, vlens + i, scratch.data());
    });
    for (size_t i = 0; i < n_sb; ++i)
        if (err[i] < 0) return -(((ptrdiff_t)i + 1) << 8) + err[i];
    return 0;
}

// One block stream (a METHOD_BLOCK payload, or the unpacked residual of a
// METHOD_BLOCK_ZSTD one) that decodes to nbytes, at least one full block:
// the row index of its nb = nbytes / (256 * bpp) full blocks, as
// stn_parse_rows_ptrs writes it for one superblock of nb blocks, and its
// partial tail (nbytes - nb * 256 * bpp bytes) decoded into tail. Returns 0
// or a negative error.
EXPORT ptrdiff_t stn_parse_rows(const uint8_t* src, size_t size, size_t bpp,
                                size_t nbytes, size_t row_bytes, uint8_t* vb,
                                int32_t* po, int32_t* rt, int64_t* vlen,
                                uint8_t* tail) {
    const size_t block_size = 256 * bpp;
    const size_t nb = nbytes / block_size;
    if (nb == 0) return ERR_INPUT;
    std::vector<uint8_t> scratch(512 * bpp + 16);
    ptrdiff_t end = 0;
    ptrdiff_t r = parse_superblock_rows(src, (ptrdiff_t)size, bpp,
                                        nb * block_size, row_bytes, vb, po,
                                        rt, vlen, scratch.data(), &end);
    if (r < 0) return r;
    const size_t rem = nbytes - nb * block_size;
    if (!rem) return 0;
    r = stn_block_decode(src + end, size - (size_t)end, bpp, rem, tail,
                         scratch.data());
    return r < 0 ? r : 0;
}

// Host libzstd over the residuals of METHOD_BLOCK_ZSTD superblocks, through
// the caller's function pointers (the port binds libzstd with ctypes; this
// file does not link it): the declared content size of each frame
// (ZSTD_getFrameContentSize, as returned), then each frame unpacked into
// dsts[i] (caps[i] bytes) on up to `threads` threads; got[i] is its size,
// or -1 when ZSTD_decompress fails.
EXPORT void stn_zstd_sizes(void* size_fn, const int64_t* srcs,
                           const int64_t* lens, size_t n, uint64_t* sizes) {
    auto size = (unsigned long long (*)(const void*, size_t))size_fn;
    for (size_t i = 0; i < n; ++i)
        sizes[i] = size((const void*)(intptr_t)srcs[i], (size_t)lens[i]);
}

EXPORT void stn_zstd_unpack(void* decompress_fn, void* is_error_fn,
                            const int64_t* srcs, const int64_t* lens,
                            const int64_t* dsts, const int64_t* caps,
                            size_t n, int threads, int64_t* got) {
    auto dec = (size_t (*)(void*, size_t, const void*, size_t))decompress_fn;
    auto is_error = (unsigned (*)(size_t))is_error_fn;
    parallel_ranges(n, threads, [&](size_t i) {
        const size_t r = dec((void*)(intptr_t)dsts[i], (size_t)caps[i],
                             (const void*)(intptr_t)srcs[i], (size_t)lens[i]);
        got[i] = is_error(r) ? -1 : (int64_t)r;
    });
}


// ===================================================================
// zstd compressed-block decode helpers (clean-room from RFC 8878)
//
// The TPU entropy-decode ladder splits a sequence-bearing zstd block into
//   (a) O(nseq) index work — FSE sequence decode + repcode resolution +
//       a W-chunked copy-op program (this section, host C++), and
//   (b) O(nbytes) bulk work — literal decode + op execution on the TPU
//       (entropy/seq_exec.py runs the op program as one fori_loop of
//       static-width slice/update copies with the ordered-overwrite
//       invariant).
// Reference behavior matched: stenos.cpp:694-753 decodes every method
// 2/3/4/5 payload through full zstd (zstd_wrapper.h:59-90).

namespace {

inline int highbit_u32(uint32_t v) {
    return 31 - __builtin_clz(v);
}

// ---- forward little-endian bit reader (NCount tables) ----
struct FwdBits {
    const uint8_t* p;
    size_t n;
    size_t pos = 0;  // absolute bit position
    uint64_t peek(int nb) const {
        uint64_t v = 0;
        size_t byte = pos >> 3;
        for (int i = 0; i < 8 && byte + i < n; ++i)
            v |= (uint64_t)p[byte + i] << (8 * i);
        return (v >> (pos & 7)) & ((1ull << nb) - 1);
    }
    uint64_t get(int nb) {
        uint64_t v = peek(nb);
        pos += nb;
        return v;
    }
};

// ---- backward bit reader (FSE / huffman bitstreams, RFC §3.1.1.3.2.1) ----
struct BwdBits {
    const uint8_t* p = nullptr;
    ptrdiff_t nbytes = 0;
    ptrdiff_t bits = 0;  // bits remaining below the cursor
    int init(const uint8_t* src, size_t n) {
        if (n == 0 || src[n - 1] == 0) return -1;
        p = src;
        nbytes = (ptrdiff_t)n;
        bits = (ptrdiff_t)(n - 1) * 8 + highbit_u32(src[n - 1]);
        return 0;
    }
    // read nb bits just below the cursor (LSB at cursor-nb); reads past the
    // stream start yield zero bits (final state updates may land there)
    uint32_t read(int nb) {
        bits -= nb;
        ptrdiff_t b = bits;
        ptrdiff_t byte = b >= 0 ? (b >> 3) : -(((-b) + 7) >> 3);
        int off = (int)(b - byte * 8);
        uint64_t v = 0;
        for (int i = 0; i < 8; ++i) {
            ptrdiff_t idx = byte + i;
            if (idx >= 0 && idx < nbytes) v |= (uint64_t)p[idx] << (8 * i);
        }
        return (uint32_t)((v >> off) & ((1ull << nb) - 1));
    }
};

// ---- FSE decode table ----
struct FseDEntry {
    uint16_t base;  // newState base
    uint8_t sym;
    uint8_t nb;
};

// norm counts (-1 allowed) -> decode table (1<<tableLog entries)
static int fse_build_dtable(const int16_t* norm, int max_sym, int table_log,
                            FseDEntry* table) {
    const int size = 1 << table_log;
    if (table_log > 12) return -1;
    uint8_t spread[1 << 12];
    int16_t sym_next[256];
    int pos_end = size - 1;
    for (int s = 0; s <= max_sym; ++s) {
        if (norm[s] == -1) {
            spread[pos_end--] = (uint8_t)s;
            sym_next[s] = 1;
        } else {
            sym_next[s] = norm[s];
        }
    }
    const int high_threshold = pos_end;
    const int step = (size >> 1) + (size >> 3) + 3;
    const int mask = size - 1;
    int position = 0;
    for (int s = 0; s <= max_sym; ++s) {
        for (int i = 0; i < (norm[s] > 0 ? norm[s] : 0); ++i) {
            spread[position] = (uint8_t)s;
            position = (position + step) & mask;
            while (position > high_threshold)
                position = (position + step) & mask;
        }
    }
    if (position != 0) return -1;
    for (int u = 0; u < size; ++u) {
        const uint8_t s = spread[u];
        const uint16_t x = (uint16_t)sym_next[s]++;
        const int nb = table_log - highbit_u32(x);
        table[u].sym = s;
        table[u].nb = (uint8_t)nb;
        table[u].base = (uint16_t)((x << nb) - size);
    }
    return 0;
}

// NCount reader (inverse of fse.write_ncount / FSE_readNCount semantics)
static int read_ncount(const uint8_t* src, size_t n, int max_log,
                       int16_t* norm /*256*/, int* table_log_out,
                       int* max_sym_out, size_t* consumed) {
    FwdBits br{src, n};
    const int table_log = (int)br.get(4) + 5;
    if (table_log > max_log) return -1;
    const int size = 1 << table_log;
    int remaining = size + 1;
    int threshold = size;
    int nb = table_log + 1;
    int s = 0;
    bool prev0 = false;
    for (int i = 0; i < 256; ++i) norm[i] = 0;
    while (remaining > 1 && s < 256) {
        if (prev0) {
            for (;;) {
                const uint32_t v = (uint32_t)br.get(2);
                s += (int)v;
                if (v != 3) break;
            }
            if (s >= 256) return -1;
            prev0 = false;
        }
        const int maxv = 2 * threshold - 1 - remaining;
        const uint32_t full = (uint32_t)br.peek(nb);
        const uint32_t low = full & (uint32_t)(threshold - 1);
        int value;
        if ((int)low < maxv) {
            value = (int)low;
            br.pos += nb - 1;
        } else {
            value = (int)(full & (uint32_t)(2 * threshold - 1));
            if (value >= threshold) value -= maxv;
            br.pos += nb;
        }
        const int count = value - 1;  // -1 encodes prob -1
        norm[s] = (int16_t)count;
        remaining -= count < 0 ? 1 : count;
        prev0 = count == 0;
        ++s;
        while (remaining > 0 && remaining < threshold) {
            --nb;
            threshold >>= 1;
        }
    }
    if (remaining != 1) return -1;
    *table_log_out = table_log;
    *max_sym_out = s - 1;
    *consumed = (br.pos + 7) / 8;
    return 0;
}

// ---- predefined sequence distributions (RFC 8878 §3.1.1.3.2.2) ----
static const int16_t kLLDefault[36] = {
    4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1,
    2, 2, 2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
static const int16_t kMLDefault[53] = {
    1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1,
    -1, -1, -1};
static const int16_t kOFDefault[29] = {
    1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

// code -> (baseline, extra bits); LL codes 16..35, ML codes 32..52
static const uint32_t kLLBase[36] = {
    0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15,
    16, 18, 20, 22, 24, 28, 32, 40, 48, 64, 128, 256, 512, 1024,
    2048, 4096, 8192, 16384, 32768, 65536};
static const uint8_t kLLBits[36] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    1, 1, 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
static const uint32_t kMLBase[53] = {
    3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18,
    19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34,
    35, 37, 39, 41, 43, 47, 51, 59, 67, 83, 99, 131, 259, 515, 1027,
    2051, 4099, 8195, 16387, 32771, 65539};
static const uint8_t kMLBits[53] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};

// one sequence channel: FSE table or RLE constant
struct SeqChannel {
    FseDEntry table[512];
    int table_log = 0;  // 0 for RLE
    uint8_t rle_sym = 0;
    bool rle = false;
    bool valid = false;
    uint32_t state = 0;
    int build(int mode, const int16_t* dflt, int dflt_max, int dflt_log,
              int max_log, const uint8_t* src, size_t n, size_t* consumed) {
        *consumed = 0;
        if (mode == 0) {
            rle = false;
            table_log = dflt_log;
            if (fse_build_dtable(dflt, dflt_max, dflt_log, table)) return -1;
        } else if (mode == 1) {
            if (n < 1) return -1;
            rle = true;
            table_log = 0;
            rle_sym = src[0];
            *consumed = 1;
        } else if (mode == 2) {
            int16_t norm[256];
            int tl, ms;
            if (read_ncount(src, n, max_log, norm, &tl, &ms, consumed))
                return -1;
            rle = false;
            table_log = tl;
            if (fse_build_dtable(norm, ms, tl, table)) return -1;
        } else {
            if (!valid) return -1;  // Repeat_Mode without a previous table
            return 0;
        }
        valid = true;
        return 0;
    }
    void init_state(BwdBits& br) { state = rle ? 0 : br.read(table_log); }
    uint8_t symbol() const { return rle ? rle_sym : table[state].sym; }
    void update(BwdBits& br) {
        if (rle) return;
        const FseDEntry& e = table[state];
        state = e.base + br.read(e.nb);
    }
};

// persistent per-frame decode context: sequence tables (Repeat_Mode) and
// the huffman literal table (Treeless_Literals_Block) survive across blocks
struct ZstdDecCtx {
    SeqChannel ll, of, ml;
    uint16_t huf[1 << 11];  // (sym << 4) | nbits
    int huf_log = 0;
    bool huf_valid = false;
};

// ---- huffman literal decode (host path for sequence-bearing blocks) ----

// weights -> canonical decode LUT (HUF_readDTableX1 fill order)
static int huf_build_lut(const uint8_t* weights, int nsyms, ZstdDecCtx* ctx) {
    uint32_t rank_count[16] = {0};
    uint32_t total = 0;
    int max_w = 0;
    for (int s = 0; s < nsyms; ++s) {
        const int w = weights[s];
        if (w > 12) return -1;
        rank_count[w]++;
        if (w) total += 1u << (w - 1);
        if (w > max_w) max_w = w;
    }
    // the implicit last weight completes total to an exact power of two
    if (total == 0) return -1;
    const int table_log = highbit_u32(total);
    if (table_log > 11 || (1u << table_log) != total) return -1;
    // rank start offsets: larger weights (shorter codes) fill later
    uint32_t rank_start[16];
    uint32_t next = 0;
    for (int w = 1; w <= max_w; ++w) {
        rank_start[w] = next;
        next += rank_count[w] << (w - 1);
    }
    if (next != (1u << table_log)) return -1;
    for (int s = 0; s < nsyms; ++s) {
        const int w = weights[s];
        if (!w) continue;
        const uint32_t len = 1u << (w - 1);
        const uint8_t nb = (uint8_t)(table_log + 1 - w);
        for (uint32_t i = 0; i < len; ++i)
            ctx->huf[rank_start[w] + i] = (uint16_t)((s << 4) | nb);
        rank_start[w] += len;
    }
    ctx->huf_log = table_log;
    ctx->huf_valid = true;
    return 0;
}

// FSE-compressed weights stream (two interleaved states, RFC §4.2.1.2)
static int huf_fse_weights(const uint8_t* src, size_t n, uint8_t* weights,
                           int* count) {
    int16_t norm[256];
    int tl, ms;
    size_t consumed;
    if (read_ncount(src, n, 6, norm, &tl, &ms, &consumed)) return -1;
    FseDEntry table[64];
    if (fse_build_dtable(norm, ms, tl, table)) return -1;
    BwdBits br;
    if (br.init(src + consumed, n - consumed)) return -1;
    uint32_t s1 = br.read(tl);
    uint32_t s2 = br.read(tl);
    int k = 0;
    for (;;) {
        if (k >= 255) return -1;
        weights[k++] = table[s1].sym;
        if (br.bits - (ptrdiff_t)table[s1].nb < 0) {
            s1 = 0;  // final reload would underflow: other state closes
            if (k >= 255) return -1;
            weights[k++] = table[s2].sym;
            break;
        }
        s1 = table[s1].base + br.read(table[s1].nb);
        if (k >= 255) return -1;
        weights[k++] = table[s2].sym;
        if (br.bits - (ptrdiff_t)table[s2].nb < 0) {
            if (k >= 255) return -1;
            weights[k++] = table[s1].sym;
            break;
        }
        s2 = table[s2].base + br.read(table[s2].nb);
    }
    *count = k;
    return 0;
}

// decode one huffman bitstream (backward; symbols come out forward)
static int huf_decode_stream(const uint8_t* src, size_t n,
                             const ZstdDecCtx* ctx, uint8_t* out,
                             size_t nsym) {
    BwdBits br;
    if (br.init(src, n)) return -1;
    const int tl = ctx->huf_log;
    for (size_t i = 0; i < nsym; ++i) {
        // peek tableLog bits below the cursor, MSB-aligned: equivalently an
        // LE extraction at cursor-tl (zero-padded past the stream start)
        BwdBits tmp = br;
        uint32_t v;
        if (br.bits >= tl) {
            v = tmp.read(tl);
        } else {
            const int have = br.bits > 0 ? (int)br.bits : 0;
            v = tmp.read(have) << (tl - have);
        }
        const uint16_t e = ctx->huf[v];
        out[i] = (uint8_t)(e >> 4);
        br.bits -= (ptrdiff_t)(e & 15);
        if (br.bits < 0) return -1;
    }
    if (br.bits != 0) return -1;  // exact consumption, like the encoder
    return 0;
}

}  // namespace

// Decode a huffman literals payload (tree desc + 1 or 4 streams).
//   src/n: bytes after the literals-section header (csize bytes)
//   four: 4-stream layout (6-byte jump table)
//   treeless: reuse the previous block's table (ctx)
// Returns 0 or negative error.
ptrdiff_t stn_huf_lits(const uint8_t* src, size_t n, int four,
                       int treeless, size_t regenerated,
                       uint8_t* ctx_blob, uint8_t* out) {
    ZstdDecCtx* ctx = (ZstdDecCtx*)ctx_blob;
    size_t p = 0;
    if (!treeless) {
        if (n < 1) return ERR_SRC;
        uint8_t weights[256];
        int count;
        const uint8_t hb = src[0];
        if (hb < 128) {  // FSE-compressed weights, hb = compressed size
            if (1 + (size_t)hb > n) return ERR_SRC;
            if (huf_fse_weights(src + 1, hb, weights, &count))
                return ERR_INPUT;
            p = 1 + hb;
        } else {  // direct 4-bit weights
            count = hb - 127;
            const size_t bytes = ((size_t)count + 1) / 2;
            if (1 + bytes > n) return ERR_SRC;
            for (int i = 0; i < count; ++i) {
                const uint8_t bb = src[1 + i / 2];
                weights[i] = (i & 1) ? (bb & 15) : (bb >> 4);
            }
            p = 1 + bytes;
        }
        // last weight is implicit (RFC §4.2.1.1)
        uint32_t total = 0;
        for (int i = 0; i < count; ++i)
            if (weights[i]) total += 1u << (weights[i] - 1);
        if (total == 0) return ERR_INPUT;
        const int tl = highbit_u32(total) + 1;
        const uint32_t rest = (1u << tl) - total;
        if (rest == 0 || (rest & (rest - 1))) return ERR_INPUT;
        weights[count] = (uint8_t)(highbit_u32(rest) + 1);
        if (huf_build_lut(weights, count + 1, ctx)) return ERR_INPUT;
    } else if (!ctx->huf_valid) {
        return ERR_INPUT;
    }
    if (!four) {
        if (huf_decode_stream(src + p, n - p, ctx, out, regenerated))
            return ERR_INPUT;
        return 0;
    }
    if (p + 6 > n) return ERR_SRC;
    const size_t j1 = src[p] | (src[p + 1] << 8);
    const size_t j2 = src[p + 2] | (src[p + 3] << 8);
    const size_t j3 = src[p + 4] | (src[p + 5] << 8);
    p += 6;
    if (p + j1 + j2 + j3 > n) return ERR_SRC;
    const size_t s1 = (regenerated + 3) / 4;
    const size_t s4 = regenerated - 3 * s1;
    const size_t offs[4] = {p, p + j1, p + j1 + j2, p + j1 + j2 + j3};
    const size_t lens[4] = {j1, j2, j3, n - (p + j1 + j2 + j3)};
    const size_t outs[4] = {0, s1, 2 * s1, 3 * s1};
    const size_t cnts[4] = {s1, s1, s1, s4};
    for (int i = 0; i < 4; ++i)
        if (huf_decode_stream(src + offs[i], lens[i], ctx, out + outs[i],
                              cnts[i]))
            return ERR_INPUT;
    return 0;
}


// Length-only anchor scan of one huffman bitstream: decodes CODE LENGTHS
// only (no symbol writes) and records the bit read position of every
// 128th symbol — br.bits before symbol i is exactly the suffix bit-sum
// the anchored device kernel expects (zstd_frame._block_anchor_entry
// semantics). Padding segments repeat the last real anchor.
static int huf_anchor_stream(const uint8_t* src, size_t n,
                             const ZstdDecCtx* ctx, size_t nsym,
                             int32_t* anch) {
    BwdBits br;
    if (br.init(src, n)) return -1;
    const int tl = ctx->huf_log;
    size_t g = 0;
    for (size_t i = 0; i < nsym; ++i) {
        if ((i & 127) == 0 && g < 256) anch[g++] = (int32_t)br.bits;
        BwdBits tmp = br;
        uint32_t v;
        if (br.bits >= tl) {
            v = tmp.read(tl);
        } else {
            const int have = br.bits > 0 ? (int)br.bits : 0;
            v = tmp.read(have) << (tl - have);
        }
        br.bits -= (ptrdiff_t)(ctx->huf[v] & 15);
        if (br.bits < 0) return -1;
    }
    if (br.bits != 0) return -1;
    const int32_t lastv = g ? anch[g - 1] : 0;
    for (; g < 256; ++g) anch[g] = lastv;
    return 0;
}

// Decode-anchor sidecar entry for a FOREIGN (e.g. libzstd-made) 4-stream
// huffman literals section (VERDICT r4: foreign-frame literals on device).
// The host walks each stream once doing length-only table lookups — no
// symbol materialization, no raw-literal buffer — and the actual bytes
// decode on the TPU via the existing anchored kernel. Builds/updates the
// shared ZstdDecCtx table exactly as stn_huf_lits would (so a following
// treeless block still host-decodes correctly).
//   src/n: bytes after the literals-section header (csize bytes)
//   out_lens: (256,) code lengths; out_anchors: (4, 256) int32 positions
// Returns 0 or a negative error.
EXPORT ptrdiff_t stn_huf_anchors(const uint8_t* src, size_t n,
                                 size_t regenerated, uint8_t* ctx_blob,
                                 uint8_t* out_lens, int32_t* out_anchors) {
    ZstdDecCtx* ctx = (ZstdDecCtx*)ctx_blob;
    if (n < 1) return ERR_SRC;
    uint8_t weights[256];
    int count;
    size_t p = 0;
    const uint8_t hb = src[0];
    if (hb < 128) {
        if (1 + (size_t)hb > n) return ERR_SRC;
        if (huf_fse_weights(src + 1, hb, weights, &count)) return ERR_INPUT;
        p = 1 + hb;
    } else {
        count = hb - 127;
        const size_t bytes = ((size_t)count + 1) / 2;
        if (1 + bytes > n) return ERR_SRC;
        for (int i = 0; i < count; ++i) {
            const uint8_t bb = src[1 + i / 2];
            weights[i] = (i & 1) ? (bb & 15) : (bb >> 4);
        }
        p = 1 + bytes;
    }
    uint32_t total = 0;
    for (int i = 0; i < count; ++i)
        if (weights[i]) total += 1u << (weights[i] - 1);
    if (total == 0) return ERR_INPUT;
    const int tl = highbit_u32(total) + 1;
    const uint32_t rest = (1u << tl) - total;
    if (rest == 0 || (rest & (rest - 1))) return ERR_INPUT;
    weights[count] = (uint8_t)(highbit_u32(rest) + 1);
    if (huf_build_lut(weights, count + 1, ctx)) return ERR_INPUT;
    std::memset(out_lens, 0, 256);
    for (int i = 0; i <= count; ++i)
        if (weights[i]) out_lens[i] = (uint8_t)(tl + 1 - weights[i]);
    if (p + 6 > n) return ERR_SRC;
    const size_t j1 = src[p] | (src[p + 1] << 8);
    const size_t j2 = src[p + 2] | (src[p + 3] << 8);
    const size_t j3 = src[p + 4] | (src[p + 5] << 8);
    p += 6;
    if (p + j1 + j2 + j3 > n) return ERR_SRC;
    const size_t s1 = (regenerated + 3) / 4;
    const size_t s4 = regenerated - 3 * s1;
    const size_t offs[4] = {p, p + j1, p + j1 + j2, p + j1 + j2 + j3};
    const size_t lens[4] = {j1, j2, j3, n - (p + j1 + j2 + j3)};
    const size_t cnts[4] = {s1, s1, s1, s4};
    for (int i = 0; i < 4; ++i)
        if (huf_anchor_stream(src + offs[i], lens[i], ctx, cnts[i],
                              out_anchors + 256 * i))
            return ERR_INPUT;
    return 0;
}

EXPORT size_t stn_zstd_ctx_size() { return sizeof(ZstdDecCtx); }

// Build the W-chunked copy-op program for one block's sequences.
// Each op is (dst, src, flag) int32; flag 1 = source is the literal
// buffer, 0 = source is earlier output. Every op copies exactly W bytes;
// only the bytes up to the next op's dst are valid (ordered overwrite).
// Self-overlapping matches bootstrap with stride=offset ops whose pads the
// following op overwrites, then grow the stride geometrically.
//   trailing = literal bytes after the last sequence
// Returns the op count or a negative error.
EXPORT ptrdiff_t stn_seq_ops(size_t nseq, const int32_t* ll,
                             const int32_t* ml, const int64_t* off,
                             int64_t dst_base, int64_t lit_base,
                             int64_t trailing, int64_t out_limit, int32_t W,
                             int32_t* ops, size_t cap) {
    size_t nops = 0;
    int64_t pos = dst_base;
    int64_t lit = lit_base;
    auto emit = [&](int64_t dst, int64_t src, int32_t flag) -> bool {
        if (nops + 1 > cap) return false;
        ops[3 * nops] = (int32_t)dst;
        ops[3 * nops + 1] = (int32_t)src;
        ops[3 * nops + 2] = flag;
        ++nops;
        return true;
    };
    auto emit_lit = [&](int64_t len) -> bool {
        for (int64_t c = 0; c < len; c += W)
            if (!emit(pos + c, lit + c, 1)) return false;
        pos += len;
        lit += len;
        return true;
    };
    for (size_t i = 0; i < nseq; ++i) {
        if (!emit_lit(ll[i])) return ERR_DST;
        const int64_t o = off[i];
        const int64_t m = ml[i];
        if (o > pos - 0 || pos + m > out_limit) return ERR_INPUT;
        if (o >= W) {
            for (int64_t c = 0; c < m; c += W)
                if (!emit(pos + c, pos + c - o, 0)) return ERR_DST;
        } else {
            int64_t c = 0;
            int64_t step = o;
            while (c < m) {
                if (!emit(pos + c, pos + c - step, 0)) return ERR_DST;
                c += step < m - c ? step : m - c;
                if (step < W) {
                    int64_t k = W / o;
                    const int64_t k2 = (c + o) / o;
                    if (k2 < k) k = k2;
                    if (k < 1) k = 1;
                    step = k * o;
                }
            }
        }
        pos += m;
    }
    if (!emit_lit(trailing)) return ERR_DST;
    if (pos > out_limit) return ERR_INPUT;
    return (ptrdiff_t)nops;
}

// ENCODE-side repeat-offset recode (twin of sequences._recode_repeat_
// offsets, libzstd's ZSTD_updateRep rule): raw offset_values (offset + 3)
// become repeat codes 1-3 where the recent-offset registers match. reps
// updated in place. The sequential register chain made this a python
// per-sequence loop in the device-FSE prep (VALIDATE_r04 §5's 872 ms);
// here it is the only non-vectorizable piece, at native speed.
EXPORT ptrdiff_t stn_recode_reps_enc(size_t nseq, const int32_t* ll,
                                     const int32_t* ofv, int64_t* reps,
                                     int32_t* ofv_out) {
    for (size_t i = 0; i < nseq; ++i) {
        const int64_t off = (int64_t)ofv[i] - 3;
        if (off <= 0) return ERR_INPUT;
        int code;
        if (ll[i] != 0) {
            code = off == reps[0] ? 1
                 : off == reps[1] ? 2
                 : off == reps[2] ? 3 : 0;
        } else {
            code = off == reps[1] ? 1
                 : off == reps[2] ? 2
                 : off == reps[0] - 1 ? 3 : 0;
        }
        if (code == 0) {
            ofv_out[i] = (int32_t)(off + 3);
            reps[2] = reps[1];
            reps[1] = reps[0];
            reps[0] = off;
        } else {
            ofv_out[i] = code;
            const int rep_idx = code - 1 + (ll[i] == 0 ? 1 : 0);
            if (rep_idx == 1) {
                const int64_t t = reps[1];
                reps[1] = reps[0];
                reps[0] = t;
            } else if (rep_idx == 2) {
                const int64_t t = reps[2];
                reps[2] = reps[1];
                reps[1] = reps[0];
                reps[0] = t;
            } else if (rep_idx == 3) {
                const int64_t t = reps[0] - 1;
                reps[2] = reps[1];
                reps[1] = reps[0];
                reps[0] = t;
            }
        }
    }
    return (ptrdiff_t)nseq;
}

// Header/table prep for the DEVICE FSE sequence decoder
// (entropy/seqdec_kernel.py): parse the nseq header + channel modes and
// build the three decode tables, Repeat_Mode ctx persistence included,
// WITHOUT touching the bitstream
// (the per-sequence state walk runs on the card; the host stays
// O(table size) per block, not O(nseq)).
//   out_tab:  (3*512,) int32 per-state entries sym | nb<<8 | base<<16,
//             channel rows ch*512 + state, channel order LL, OF, ML.
//             RLE channels: one row 0 entry (rle_sym, nb 0, base 0).
//   out_meta: (8,) int32 [nseq, bitstream byte offset in sec, bp0 (initial
//             bit cursor), tl_ll, tl_of, tl_ml, 0, 0]
// Returns nseq (>= 0) or a negative error.
EXPORT ptrdiff_t stn_zstd_dtables(const uint8_t* sec, size_t n,
                                  uint8_t* ctx_blob, int32_t* out_tab,
                                  int32_t* out_meta) {
    ZstdDecCtx* ctx = (ZstdDecCtx*)ctx_blob;
    if (n < 1) return ERR_SRC;
    size_t p = 0;
    uint32_t nseq;
    const uint8_t b0 = sec[p++];
    if (b0 < 128) {
        nseq = b0;
    } else if (b0 < 255) {
        if (p >= n) return ERR_SRC;
        nseq = ((uint32_t)(b0 - 128) << 8) + sec[p++];
    } else {
        if (p + 2 > n) return ERR_SRC;
        nseq = sec[p] + ((uint32_t)sec[p + 1] << 8) + 0x7F00;
        p += 2;
    }
    for (int i = 0; i < 8; ++i) out_meta[i] = 0;
    if (nseq == 0) return 0;
    if (p >= n) return ERR_INPUT;
    const uint8_t modes = sec[p++];
    if (modes & 3) return ERR_INPUT;
    size_t used;
    if (ctx->ll.build((modes >> 6) & 3, kLLDefault, 35, 6, 9, sec + p,
                      n - p, &used))
        return ERR_INPUT;
    p += used;
    if (ctx->of.build((modes >> 4) & 3, kOFDefault, 28, 5, 8, sec + p,
                      n - p, &used))
        return ERR_INPUT;
    p += used;
    if (ctx->ml.build((modes >> 2) & 3, kMLDefault, 52, 6, 9, sec + p,
                      n - p, &used))
        return ERR_INPUT;
    p += used;
    if (p >= n || sec[n - 1] == 0) return ERR_SRC;
    const SeqChannel* chans[3] = {&ctx->ll, &ctx->of, &ctx->ml};
    for (int ch = 0; ch < 3; ++ch) {
        int32_t* t = out_tab + ch * 512;
        for (int s = 0; s < 512; ++s) t[s] = 0;
        const SeqChannel& c = *chans[ch];
        if (c.rle) {
            t[0] = (int32_t)c.rle_sym;
        } else {
            const int size = 1 << c.table_log;
            for (int s = 0; s < size; ++s)
                t[s] = (int32_t)c.table[s].sym
                       | ((int32_t)c.table[s].nb << 8)
                       | ((int32_t)c.table[s].base << 16);
        }
    }
    out_meta[0] = (int32_t)nseq;
    out_meta[1] = (int32_t)p;
    out_meta[2] = (int32_t)((n - p - 1) * 8 + highbit_u32(sec[n - 1]));
    out_meta[3] = ctx->ll.table_log;
    out_meta[4] = ctx->of.table_log;
    out_meta[5] = ctx->ml.table_log;
    return (ptrdiff_t)nseq;
}

// Repcode resolution for the DEVICE FSE sequence decoder: consumes the
// kernel's RAW (ll, offset_value) pairs, resolves the repeat offsets
// (RFC 8878 §3.1.1.3.2.1.1; reps updated in
// place) and writes the resolved offsets. O(nseq) integer work, zero bit
// reading — the entropy half already ran on the card. Returns 0 or a
// negative error.
EXPORT ptrdiff_t stn_resolve_reps(size_t nseq, const int32_t* ll,
                                  const int32_t* ofv, int64_t* reps,
                                  int64_t* off_out) {
    for (size_t i = 0; i < nseq; ++i) {
        const int64_t off_val = (int64_t)(uint32_t)ofv[i];
        int64_t off;
        if (off_val > 3) {
            off = off_val - 3;
            reps[2] = reps[1];
            reps[1] = reps[0];
            reps[0] = off;
        } else {
            const int idx = (int)off_val - 1 + (ll[i] == 0 ? 1 : 0);
            if (idx == 0) {
                off = reps[0];
            } else if (idx == 1) {
                off = reps[1];
                reps[1] = reps[0];
                reps[0] = off;
            } else if (idx == 2) {
                off = reps[2];
                reps[2] = reps[1];
                reps[1] = reps[0];
                reps[0] = off;
            } else {
                off = reps[0] - 1;
                if (off <= 0) return ERR_INPUT;
                reps[2] = reps[1];
                reps[1] = reps[0];
                reps[0] = off;
            }
        }
        if (off <= 0) return ERR_INPUT;
        off_out[i] = off;
    }
    return 0;
}

// ===================================================================
// zstd block ENCODER fast path (clean-room, RFC 8878) — the C++ twin of
// entropy/zstd_frame.encode_block + entropy/match.py + entropy/sequences.py
// (byte-identical output; tests compare against the python reference).
// Match candidates come either from an on-the-fly exact nearest-previous-
// fp4 map (the host path) or from the device sort-based candidate array
// (entropy/match_device.py): dist | (log2 guaranteed length << 24).

namespace {

// value -> (code, extra bits), scanning the decoder's per-code tables
// (kLLBase/kLLBits/kMLBase/kMLBits above; RFC 8878 §3.1.1.3.2.1.1)
inline void ll_code_of(int32_t v, int* code, int* nb) {
    if (v < 16) { *code = v; *nb = 0; return; }
    for (int c = 16; c < 36; ++c)
        if ((uint32_t)v < kLLBase[c] + (1u << kLLBits[c])) {
            *code = c; *nb = kLLBits[c]; return;
        }
    *code = 35; *nb = 16;
}

inline void ml_code_of(int32_t v, int* code, int* nb) {
    if (v < 35) { *code = v - 3; *nb = 0; return; }
    for (int c = 32; c < 53; ++c)
        if ((uint32_t)v < kMLBase[c] + (1u << kMLBits[c])) {
            *code = c; *nb = kMLBits[c]; return;
        }
    *code = 52; *nb = 16;
}

// FseEnc sized for the sequence channels (up to 53 symbols, table log 9)
struct FseEncSeq {
    int tl;
    int32_t state_table[512];
    int64_t dnb[64], dfs[64];
    int64_t value = 0;
    void build(const int32_t* norm, int n_sym, int tlog) {
        tl = tlog;
        const int size = 1 << tl;
        int spread[512];
        int high = size - 1;
        for (int s = 0; s < n_sym; ++s)
            if (norm[s] == -1) spread[high--] = s;
        const int step = (size >> 1) + (size >> 3) + 3;
        const int mask = size - 1;
        int pos = 0;
        for (int s = 0; s < n_sym; ++s)
            for (int i = 0; i < norm[s]; ++i) {
                spread[pos] = s;
                pos = (pos + step) & mask;
                while (pos > high) pos = (pos + step) & mask;
            }
        int64_t cumul[65];
        cumul[0] = 0;
        for (int s = 0; s < n_sym; ++s)
            cumul[s + 1] = cumul[s] +
                (norm[s] == -1 ? 1 : (norm[s] > 0 ? norm[s] : 0));
        for (int u = 0; u < size; ++u)
            state_table[cumul[spread[u]]++] = size + u;
        // cumul was consumed as the write cursor; recompute deltas
        int64_t total = 0;
        for (int s = 0; s < n_sym; ++s) {
            int c = norm[s];
            if (c == -1 || c == 1) {
                dnb[s] = ((int64_t)tl << 16) - (1ll << tl);
                dfs[s] = total - 1;
                total += 1;
            } else if (c == 0) {
                dnb[s] = (((int64_t)tl + 1) << 16) - (1ll << tl);
                dfs[s] = total - 1;
            } else {
                int mbo = tl - highbit(c - 1);
                dnb[s] = ((int64_t)mbo << 16) - ((int64_t)c << mbo);
                dfs[s] = total - c;
                total += c;
            }
        }
    }
    void init_state(int s) {
        int nb = (int)((dnb[s] + (1 << 15)) >> 16);
        int64_t v = ((int64_t)nb << 16) - dnb[s];
        value = state_table[(v >> nb) + dfs[s]];
    }
    void encode(BitW& bw, int s) {
        int nb = (int)((value + dnb[s]) >> 16);
        bw.add((uint64_t)value, nb);
        value = state_table[(value >> nb) + dfs[s]];
    }
    void flush(BitW& bw) { bw.add((uint64_t)value, tl); }
};

// one channel's mode decision (twin of sequences._channel_plan): returns
// mode 0/1/2, fills header bytes (hn) and the encoder (for modes 0 and 2)
inline int channel_plan(const int32_t* codes, size_t n, const int16_t* defn,
                        int def_n, int def_log, int max_log, uint8_t* hdr,
                        int* hn, FseEncSeq* enc) {
    int64_t cnt[64] = {0};
    int max_sym = 0;
    for (size_t i = 0; i < n; ++i) {
        ++cnt[codes[i]];
        if (codes[i] > max_sym) max_sym = codes[i];
    }
    int n_present = 0, only = -1;
    for (int s = 0; s <= max_sym; ++s)
        if (cnt[s]) { ++n_present; only = s; }
    if (n_present == 1) { hdr[0] = (uint8_t)only; *hn = 1; return 1; }

    double cost_pre = -1;
    if (max_sym < def_n) {
        double c = 0;
        for (int s = 0; s <= max_sym; ++s)
            if (cnt[s]) {
                int32_t dv = defn[s] > 1 ? defn[s] : 1;
                c += (double)cnt[s] *
                     -(std::log2((double)dv / (1 << def_log)));
            }
        cost_pre = c;
    }
    int ceil_np = n_present <= 1 ? 0 : 32 - __builtin_clz(n_present - 1);
    int nb_len = 0;
    {   // (n - 1).bit_length() - 2
        uint64_t v = n - 1;
        while (v) { ++nb_len; v >>= 1; }
        nb_len -= 2;
    }
    int tl = 5;
    if (ceil_np > tl) tl = ceil_np;
    if (nb_len > tl) tl = nb_len;
    if (tl > max_log) tl = max_log;
    while ((1 << tl) < n_present) ++tl;
    int32_t norm[64];
    fse_normalize(cnt, max_sym + 1, tl, (int64_t)n, norm);
    BitW hb{};
    hb.out = hdr;
    fse_write_ncount(hb, norm, tl, max_sym);
    double cost_cust = hb.n * 8.0;
    for (int s = 0; s <= max_sym; ++s)
        if (cnt[s])
            cost_cust += (double)cnt[s] *
                         -(std::log2((double)norm[s] / (1 << tl)));
    if (cost_pre >= 0 && cost_pre <= cost_cust) {
        *hn = 0;
        int32_t dn[64];
        for (int s = 0; s < def_n; ++s) dn[s] = defn[s];
        enc->build(dn, def_n, def_log);
        return 0;
    }
    *hn = hb.n;
    enc->build(norm, max_sym + 1, tl);
    return 2;
}

// repeat-offset recode, twin of sequences._recode_repeat_offsets; seqs is
// (ll, ofv, ml) int32 triples recoded IN PLACE; reps updated in place
inline void recode_reps(int32_t* seqs, size_t n, int64_t* reps) {
    int64_t r0 = reps[0], r1 = reps[1], r2 = reps[2];
    for (size_t i = 0; i < n; ++i) {
        const int64_t ll = seqs[3 * i];
        const int64_t off = seqs[3 * i + 1] - 3;
        int code = 0;
        if (ll != 0) {
            if (off == r0) code = 1;
            else if (off == r1) code = 2;
            else if (off == r2) code = 3;
        } else {
            if (off == r1) code = 1;
            else if (off == r2) code = 2;
            else if (off == r0 - 1) code = 3;
        }
        if (code == 0) {
            r2 = r1; r1 = r0; r0 = off;
        } else {
            seqs[3 * i + 1] = code;
            const int rep_idx = code - 1 + (ll == 0 ? 1 : 0);
            if (rep_idx == 1) { int64_t t = r1; r1 = r0; r0 = t; }
            else if (rep_idx == 2) {
                int64_t t = r2; r2 = r1; r1 = r0; r0 = t;
            } else if (rep_idx == 3) {
                int64_t t = r0 - 1; r2 = r1; r1 = r0; r0 = t;
            }
        }
    }
    reps[0] = r0; reps[1] = r1; reps[2] = r2;
}

// sequences section (twin of sequences.encode_sequences mode='auto');
// consumes RAW seqs (ofv = offset + 3) + running reps, returns bytes
// written (>= 1) or ERR_DST. reps updated to the post-block registers.
inline ptrdiff_t seq_encode(const int32_t* seqs_in, size_t n, int64_t* reps,
                            uint8_t* out, size_t cap) {
    size_t w = 0;
    if (n < 128) {
        if (cap < 1) return ERR_DST;
        out[w++] = (uint8_t)n;
    } else if (n < 0x7F00) {
        if (cap < 2) return ERR_DST;
        out[w++] = (uint8_t)((n >> 8) + 128);
        out[w++] = (uint8_t)(n & 255);
    } else {
        if (cap < 3) return ERR_DST;
        out[w++] = 255;
        out[w++] = (uint8_t)((n - 0x7F00) & 255);
        out[w++] = (uint8_t)((n - 0x7F00) >> 8);
    }
    if (n == 0) return (ptrdiff_t)w;

    std::vector<int32_t> seqs(seqs_in, seqs_in + 3 * n);
    recode_reps(seqs.data(), n, reps);

    std::vector<int32_t> llc(n), lln(n), mlc(n), mln(n), ofc(n), ofn(n);
    for (size_t i = 0; i < n; ++i) {
        int c, nb;
        ll_code_of(seqs[3 * i], &c, &nb);
        llc[i] = c; lln[i] = nb;
        ml_code_of(seqs[3 * i + 2], &c, &nb);
        mlc[i] = c; mln[i] = nb;
        const uint32_t ofv = (uint32_t)seqs[3 * i + 1];
        ofc[i] = highbit(ofv);
        ofn[i] = ofc[i];
    }
    uint8_t llh[128], ofh[128], mlh[128];
    int llhn, ofhn, mlhn;
    FseEncSeq ell, eof_, eml;
    const int ll_m = channel_plan(llc.data(), n, kLLDefault, 36, 6, 9,
                                  llh, &llhn, &ell);
    const int of_m = channel_plan(ofc.data(), n, kOFDefault, 29, 5, 8,
                                  ofh, &ofhn, &eof_);
    const int ml_m = channel_plan(mlc.data(), n, kMLDefault, 53, 6, 9,
                                  mlh, &mlhn, &eml);
    if (w + 1 + llhn + ofhn + mlhn + 16 > cap) return ERR_DST;
    out[w++] = (uint8_t)((ll_m << 6) | (of_m << 4) | (ml_m << 2));
    std::memcpy(out + w, llh, llhn); w += llhn;
    std::memcpy(out + w, ofh, ofhn); w += ofhn;
    std::memcpy(out + w, mlh, mlhn); w += mlhn;

    BitW bw{};
    bw.out = out + w;
    const size_t bit_cap = cap - w;
    const size_t last = n - 1;
    if (ml_m != 1) eml.init_state(mlc[last]);
    if (of_m != 1) eof_.init_state(ofc[last]);
    if (ll_m != 1) ell.init_state(llc[last]);
    bw.add((uint64_t)seqs[3 * last], lln[last]);
    bw.add((uint64_t)(seqs[3 * last + 2] - 3), mln[last]);
    {
        const uint32_t ofv = (uint32_t)seqs[3 * last + 1];
        bw.add(ofv - (1u << ofc[last]), ofn[last]);
    }
    for (size_t ii = n - 1; ii-- > 0;) {
        if ((size_t)bw.n + 64 > bit_cap) return ERR_DST;
        if (of_m != 1) eof_.encode(bw, ofc[ii]);
        if (ml_m != 1) eml.encode(bw, mlc[ii]);
        if (ll_m != 1) ell.encode(bw, llc[ii]);
        bw.add((uint64_t)seqs[3 * ii], lln[ii]);
        bw.add((uint64_t)(seqs[3 * ii + 2] - 3), mln[ii]);
        const uint32_t ofv = (uint32_t)seqs[3 * ii + 1];
        bw.add(ofv - (1u << ofc[ii]), ofn[ii]);
    }
    if ((size_t)bw.n + 8 > bit_cap) return ERR_DST;
    if (ml_m != 1) eml.flush(bw);
    if (of_m != 1) eof_.flush(bw);
    if (ll_m != 1) ell.flush(bw);
    bw.close();
    return (ptrdiff_t)(w + bw.n);
}

// ---- literals section (twin of zstd_frame.compress_literals) ----

// canonical code assignment (twin of huffman.build_ctable)
inline void build_codes(const uint8_t* len, uint32_t* codes) {
    int maxlen = 0;
    for (int s = 0; s < 256; ++s) if (len[s] > maxlen) maxlen = len[s];
    std::memset(codes, 0, 256 * sizeof(uint32_t));
    if (!maxlen) return;
    uint32_t code = 0;
    int prev = maxlen;
    for (int ln = maxlen; ln >= 1; --ln) {
        code >>= (prev - ln);
        prev = ln;
        for (int s = 0; s < 256; ++s)
            if (len[s] == ln) codes[s] = code++;
    }
}

// Compressed_Literals_Block, 4 streams, size_format 3 (5-byte header).
// Returns section size, or 0 when the block must fall back.
// Literals-section PLAN: the exact compressed section size computed
// arithmetically from the histogram + a length-LUT pass — no bitstream is
// written. encode_block plans every candidate and materializes only the
// winner's streams (the dominant per-block cost was losing candidates'
// full Huffman encodes).
struct LitPlan {
    bool ok = false;
    size_t csize = 0;  // payload bytes (tree + jump + streams)
    size_t esz[4] = {0, 0, 0, 0};
    uint8_t len[256];
    uint32_t codes[256];
    uint8_t tree[132];
    int tsz = 0;
};

inline LitPlan plan_literals_c(const uint8_t* data, size_t n) {
    LitPlan p;
    if (n < 64) return p;
    int64_t cnt[256] = {0};
    for (size_t i = 0; i < n; ++i) ++cnt[data[i]];
    stn_huff_lengths(cnt, 1, 11, p.len);
    int n_used = 0;
    for (int s = 0; s < 256; ++s) if (p.len[s]) ++n_used;
    if (n_used < 2) return p;
    p.tsz = huff_tree_desc(p.len, p.tree);
    if (!p.tsz) return p;
    build_codes(p.len, p.codes);
    const size_t s1 = (n + 3) / 4;
    for (int j = 0; j < 4; ++j) {
        const size_t lo = j * s1;
        const size_t hi = j == 3 ? n : (j + 1) * s1;
        uint64_t bits = 1;  // BitW.close() sentinel bit
        for (size_t i = lo; i < hi; ++i) bits += p.len[data[i]];
        p.esz[j] = (size_t)((bits + 7) >> 3);
        if (j < 3 && p.esz[j] > 0xFFFF) return p;
    }
    p.csize = (size_t)p.tsz + 6 + p.esz[0] + p.esz[1] + p.esz[2] + p.esz[3];
    if (p.csize >= n) return p;
    p.ok = true;
    return p;
}

inline size_t write_literals_c(const uint8_t* data, size_t n,
                               const LitPlan& p, uint8_t* out, size_t cap) {
    if (!p.ok || 5 + p.csize > cap) return 0;
    const uint64_t hdr =
        2ull | (3ull << 2) | ((uint64_t)n << 4) | ((uint64_t)p.csize << 22);
    for (int i = 0; i < 5; ++i) out[i] = (uint8_t)(hdr >> (8 * i));
    size_t w = 5;
    std::memcpy(out + w, p.tree, p.tsz); w += (size_t)p.tsz;
    for (int j = 0; j < 3; ++j) {
        out[w++] = (uint8_t)(p.esz[j] & 255);
        out[w++] = (uint8_t)(p.esz[j] >> 8);
    }
    const size_t s1 = (n + 3) / 4;
    for (int j = 0; j < 4; ++j) {
        const size_t lo = j * s1;
        const size_t hi = j == 3 ? n : (j + 1) * s1;
        BitW bw{};
        bw.out = out + w;
        // encode the stream backward (decoder reads it backward)
        for (size_t i = hi; i-- > lo;)
            bw.add(p.codes[data[i]], p.len[data[i]]);
        bw.close();
        w += (size_t)bw.n;  // == p.esz[j] by construction
    }
    return w;
}

inline size_t compress_literals_c(const uint8_t* data, size_t n,
                                  uint8_t* out, size_t cap) {
    const LitPlan p = plan_literals_c(data, n);
    if (!p.ok) return 0;
    return write_literals_c(data, n, p, out, cap);
}

// Raw_Literals_Block, size_format 3 (3-byte header)
inline size_t raw_literals_c(const uint8_t* data, size_t n, uint8_t* out,
                             size_t cap) {
    if (3 + n > cap) return 0;
    const uint32_t hdr = 0 | (3u << 2) | ((uint32_t)n << 4);
    out[0] = (uint8_t)hdr;
    out[1] = (uint8_t)(hdr >> 8);
    out[2] = (uint8_t)(hdr >> 16);
    std::memcpy(out + 3, data, n);
    return 3 + n;
}

// ---- match finding + greedy parse ----

struct ParseOut {
    std::vector<int32_t> seqs;  // (ll, ofv, ml) triples
    std::vector<uint8_t> lits;
    bool ok = false;
};

// exact nearest-previous-equal-fp4 map (twin of match.find_matches: the
// stable fingerprint sort's predecessor IS the last earlier occurrence)
struct Fp4Map {
    // one packed u64 per slot (key<<32 | pos+1; 0 = empty): half the
    // random-access cache lines of split key/pos arrays — the map walk is
    // the encode hot path
    std::vector<uint64_t> ent;
    uint32_t mask;
    explicit Fp4Map(size_t n) {
        size_t sz = 16;
        while (sz < 2 * n) sz <<= 1;
        ent.assign(sz, 0);
        mask = (uint32_t)(sz - 1);
    }
    static inline uint32_t slot0(uint32_t fp) {
        return fp * 2654435761u;
    }
    inline void put(uint32_t fp, int32_t p) {
        uint32_t s = slot0(fp) & mask;
        while (ent[s] && (uint32_t)(ent[s] >> 32) != fp) s = (s + 1) & mask;
        ent[s] = ((uint64_t)fp << 32) | (uint32_t)(p + 1);
    }
    inline int32_t get(uint32_t fp) const {
        uint32_t s = slot0(fp) & mask;
        while (ent[s]) {
            if ((uint32_t)(ent[s] >> 32) == fp)
                return (int32_t)(uint32_t)ent[s] - 1;
            s = (s + 1) & mask;
        }
        return -1;
    }
};

inline uint32_t fp4_at(const uint8_t* d, size_t p) {
    uint32_t v;
    std::memcpy(&v, d + p, 4);
    return v;  // little-endian host; value identity only matters
}

// u64-chunked match extension: a[l] == b[l] while l < limit (the classic
// LZ extension; byte-identical result, ~8x the byte loop on long matches)
static inline int64_t ext_u64(const uint8_t* a, const uint8_t* b,
                              int64_t limit) {
    int64_t l = 0;
    while (l + 8 <= limit) {
        uint64_t x, y;
        std::memcpy(&x, a + l, 8);
        std::memcpy(&y, b + l, 8);
        const uint64_t d = x ^ y;
        if (d) return l + (int64_t)(__builtin_ctzll(d) >> 3);
        l += 8;
    }
    while (l < limit && a[l] == b[l]) ++l;
    return l;
}

// Greedy cursor walk shared by both candidate sources. Provider semantics:
// fill (dist, base_len) for position p, return true when p opens a match.
// Rep-aware (twin of match_device._parse_py): after the greedy/lazy pick,
// a match at one of the running repeat-offset registers within REP_GAIN
// bytes of the candidate length wins — its offset channel costs ~1-2 FSE
// bits instead of log2(d) extra bits (libzstd's greedy rep priority).
// The register state is tracked with the exact _recode_repeat_offsets /
// ZSTD_updateRep rule so the preference sees what the coder will have.
constexpr int64_t REP_GAIN = 2;
constexpr int64_t REP_MIN = 4;

template <class Provider>
inline ParseOut greedy_walk(const uint8_t* data, size_t n, Provider&& cand,
                            int64_t ml_cap, const int64_t* reps0) {
    ParseOut r;
    if (n < 8) return r;
    int64_t total_matched = 0;
    size_t cursor = 0;
    r.lits.reserve(n / 4);
    int64_t reps[3] = {1, 4, 8};
    if (reps0) { reps[0] = reps0[0]; reps[1] = reps0[1]; reps[2] = reps0[2]; }
    auto extend = [&](size_t p, int64_t d, int64_t base) {
        int64_t l = base;
        if ((int64_t)(n - p) < l) l = n - p;
        int64_t limit = (int64_t)(n - p);
        if (limit > ml_cap) limit = ml_cap;
        if (l < limit)
            l += ext_u64(data + p + l, data + p + l - d, limit - l);
        return l;
    };
    size_t p = 0;
    while (true) {
        if (p < cursor) p = cursor;
        int64_t d, base;
        while (p + 4 <= n && !cand(p, &d, &base)) ++p;
        if (p + 4 > n) break;
        int64_t l = extend(p, d, base);
        int64_t d1, b1;
        if (p + 5 <= n && cand(p + 1, &d1, &b1)) {
            const int64_t l1 = extend(p + 1, d1, b1);
            if (l1 > l + 3) { ++p; d = d1; l = l1; }
        }
        // rep preference (register order breaks ties, strict >)
        int64_t best_rl = 0, best_rep = 0;
        for (int k = 0; k < 3; ++k) {
            const int64_t rr = reps[k];
            if (rr <= 0 || rr > (int64_t)p) continue;
            int64_t limit = (int64_t)(n - p);
            if (limit > ml_cap) limit = ml_cap;
            const int64_t rl = ext_u64(data + p, data + p - rr, limit);
            if (rl > best_rl) { best_rl = rl; best_rep = rr; }
        }
        if (best_rl >= REP_MIN && best_rl + REP_GAIN >= l) {
            d = best_rep;
            l = best_rl;
        }
        const size_t ll = p - cursor;
        r.lits.insert(r.lits.end(), data + cursor, data + p);
        r.seqs.push_back((int32_t)ll);
        r.seqs.push_back((int32_t)(d + 3));
        r.seqs.push_back((int32_t)l);
        total_matched += l;
        // register update (exact _recode_repeat_offsets rule)
        {
            int code;
            if (ll != 0)
                code = d == reps[0] ? 1 : d == reps[1] ? 2
                       : d == reps[2] ? 3 : 0;
            else
                code = d == reps[1] ? 1 : d == reps[2] ? 2
                       : d == reps[0] - 1 ? 3 : 0;
            if (code == 0) {
                reps[2] = reps[1]; reps[1] = reps[0]; reps[0] = d;
            } else {
                const int ri = code - 1 + (ll == 0 ? 1 : 0);
                if (ri == 1) {
                    std::swap(reps[0], reps[1]);
                } else if (ri == 2) {
                    const int64_t t = reps[2];
                    reps[2] = reps[1]; reps[1] = reps[0]; reps[0] = t;
                } else if (ri == 3) {
                    reps[2] = reps[1]; reps[1] = reps[0]; --reps[0];
                }
            }
        }
        cursor = p + l;
        p = cursor;
    }
    const int64_t gain_min = n / 64 > 64 ? (int64_t)(n / 64) : 64;
    if (r.seqs.empty() || total_matched < gain_min) return r;
    r.lits.insert(r.lits.end(), data + cursor, data + n);
    r.ok = true;
    return r;
}

// host path: on-the-fly fp4 map (twin of match.greedy_parse, ml cap 32772)
inline ParseOut hash_parse(const uint8_t* data, size_t n,
                           const int64_t* reps0) {
    if (n < 8) return ParseOut{};
    Fp4Map map(n);
    size_t inserted = 0;  // positions [0, inserted) are in the map
    auto provider = [&](size_t p, int64_t* d, int64_t* base) {
        while (inserted < p) {
            map.put(fp4_at(data, inserted), (int32_t)inserted);
            ++inserted;
        }
        const int32_t prev = map.get(fp4_at(data, p));
        if (prev < 0) return false;
        *d = (int64_t)p - prev;
        *base = 4;
        return true;
    };
    return greedy_walk(data, n, provider, 32772, reps0);
}

// device-candidate path (twin of match_device._parse_py, uncapped)
inline ParseOut cand_parse(const uint8_t* data, size_t n,
                           const int32_t* cand, const int64_t* reps0) {
    auto provider = [&](size_t p, int64_t* d, int64_t* base) {
        const int32_t c = cand[p];
        if (!c) return false;
        *d = c & 0xFFFFFF;
        *base = 1ll << (c >> 24);
        return true;
    };
    return greedy_walk(data, n, provider, (int64_t)1 << 40, reps0);
}

// offset-1 runs (twin of sequences.find_run_sequences, min_run 8)
inline ParseOut run_parse(const uint8_t* data, size_t n) {
    ParseOut r;
    if (n < 16) return r;
    int64_t total = 0;
    std::vector<std::pair<size_t, size_t>> runs;  // (start, byte length)
    size_t i = 0;
    while (i + 1 < n) {
        if (data[i + 1] != data[i]) { ++i; continue; }
        size_t j = i + 1;
        while (j + 1 < n && data[j + 1] == data[j]) ++j;
        const size_t L = j - i + 1;
        if (L >= 8) { runs.push_back({i, L}); total += (int64_t)L; }
        i = j + 1;
    }
    const int64_t gain_min = n / 64 > 64 ? (int64_t)(n / 64) : 64;
    if (runs.empty() || total < gain_min) return r;
    size_t cursor = 0;
    for (auto& rn : runs) {
        const size_t s = rn.first;
        const int64_t ml = (int64_t)rn.second - 1;
        if (ml < 3) continue;
        r.lits.insert(r.lits.end(), data + cursor, data + s + 1);
        r.seqs.push_back((int32_t)(s + 1 - cursor));
        r.seqs.push_back(4);  // offset_value 4 == offset 1
        r.seqs.push_back((int32_t)ml);
        cursor = s + rn.second;
    }
    if (r.seqs.empty()) return r;
    r.lits.insert(r.lits.end(), data + cursor, data + n);
    r.ok = true;
    return r;
}

}  // namespace

// Duplicate-4-gram fraction of the first sample_n positions — the host
// twin of match_device.matchiness for ROUTING when the device round-trip
// cannot pay (bus-aware router; NOTES.md relay D2H poisoning). A 16 KiB
// prefix sample approximates the block's LZ potential at ~0.4 us/block.
EXPORT double stn_matchiness(const uint8_t* data, size_t n,
                             size_t sample_n) {
    if (n < 8) return 0.0;
    size_t m = n - 4;
    if (sample_n && sample_n < m) m = sample_n;
    Fp4Map map(m);
    size_t hits = 0;
    for (size_t p = 0; p < m; ++p) {
        const uint32_t fp = fp4_at(data, p);
        if (map.get(fp) >= 0)
            ++hits;
        else
            map.put(fp, (int32_t)p);
    }
    return m ? (double)hits / (double)m : 0.0;
}

// Greedy parse to raw sequence triples. use_cand != 0 reads the device
// candidate array; otherwise the exact fp4 map runs host-side. Returns
// nseq (0 = matching not worthwhile) or a negative error; writes
// (ll, ofv, ml) triples and the literal bytes (nlits[0] = count).
EXPORT ptrdiff_t stn_match_parse(const uint8_t* data, size_t n,
                                 const int32_t* cand, int use_cand,
                                 int32_t* seqs, size_t seq_cap,
                                 uint8_t* lits, int64_t* nlits,
                                 const int64_t* reps) {
    ParseOut r = use_cand ? cand_parse(data, n, cand, reps)
                          : hash_parse(data, n, reps);
    nlits[0] = 0;
    if (!r.ok) return 0;
    const size_t nseq = r.seqs.size() / 3;
    if (nseq > seq_cap) return ERR_DST;
    std::memcpy(seqs, r.seqs.data(), r.seqs.size() * sizeof(int32_t));
    std::memcpy(lits, r.lits.data(), r.lits.size());
    nlits[0] = (int64_t)r.lits.size();
    return (ptrdiff_t)nseq;
}

// One whole zstd block (twin of zstd_frame.encode_block): RLE check, then
// the cheapest of {literals-only, run-sequences, greedy-match} candidates,
// raw fallback. reps: running repeat-offset registers, updated in place to
// the CHOSEN candidate's post-block state. cand: device candidate array
// (use_cand != 0) or ignored. Returns block size (header included).
EXPORT ptrdiff_t stn_encode_block(const uint8_t* data, size_t n,
                                  const int32_t* cand, int use_cand,
                                  int last, int64_t* reps, uint8_t* out,
                                  size_t cap) {
    if (cap < n + 16) return ERR_DST;
    if (n == 0) {
        const uint32_t bh = (uint32_t)(last != 0);
        out[0] = (uint8_t)bh; out[1] = 0; out[2] = 0;
        return 3;
    }
    bool all_same = true;
    for (size_t i = 1; i < n && all_same; ++i)
        all_same = data[i] == data[0];
    if (all_same) {
        const uint32_t bh = (uint32_t)(last != 0) | (1u << 1)
                            | ((uint32_t)n << 3);
        out[0] = (uint8_t)bh; out[1] = (uint8_t)(bh >> 8);
        out[2] = (uint8_t)(bh >> 16); out[3] = data[0];
        return 4;
    }

    // Plan-then-materialize (byte-identical to the old all-candidates
    // encode, ~2x faster): every candidate's literal-section size comes
    // from plan_literals_c arithmetic; only the WINNER's Huffman streams
    // are written. Selection order and strict-< tie-breaking mirror the
    // python twin's stable min().
    std::vector<uint8_t> best;
    int64_t best_reps[3];
    std::vector<uint8_t> buf(2 * n + 1024);

    struct Cand {
        bool ok = false;
        size_t size = 0;       // content bytes (lit section + seq section)
        LitPlan lp;
        size_t lit_n = 0;      // literal byte count (raw fallback size)
        ParseOut r;            // parses only
        std::vector<uint8_t> seq;
        int64_t reps_out[3];
    };
    Cand cands[3];
    // candidate 0: literals-only (registers unchanged)
    {
        Cand& c = cands[0];
        c.lp = plan_literals_c(data, n);
        c.lit_n = n;
        if (c.lp.ok) {
            c.ok = true;
            c.size = 5 + c.lp.csize + 1;  // + the 0-sequences byte
            c.reps_out[0] = reps[0]; c.reps_out[1] = reps[1];
            c.reps_out[2] = reps[2];
        }
    }
    // run_parse can only accept when total run bytes >= max(64, n/64)
    // and every counted run needs >= 7 equal-neighbor flags per 8 bytes:
    // eq_neighbors < 7/8 * threshold proves rejection, so a cheap u64 scan
    // (~0.2 ns/B) skips run_parse's full pass on run-free blocks.
    // Provably output-identical (skip <=> run_parse would reject), so the
    // python twin needs no counterpart.
    bool maybe_runs = true;
    {
        const int64_t gain_min = n / 64 > 64 ? (int64_t)(n / 64) : 64;
        const int64_t need_eq = gain_min - gain_min / 8;
        int64_t eq = 0;
        size_t i = 0;
        for (; i + 9 <= n; i += 8) {
            uint64_t a, b;
            std::memcpy(&a, data + i, 8);
            std::memcpy(&b, data + i + 1, 8);
            const uint64_t d = a ^ b;
            // count zero BYTES of d (equal neighbor pairs)
            const uint64_t m =
                (((d | ((d | 0x8080808080808080ull) - 0x0101010101010101ull))
                  & 0x8080808080808080ull) >> 7);
            eq += 8 - (int64_t)__builtin_popcountll(m);
            if (eq >= need_eq) break;
        }
        if (eq < need_eq)
            for (; i + 1 < n && eq < need_eq; ++i)
                eq += data[i] == data[i + 1];
        maybe_runs = eq >= need_eq;
    }
    // candidates 1, 2: run sequences, then greedy matches
    for (int finder = 0; finder < 2; ++finder) {
        Cand& c = cands[1 + finder];
        c.r = finder == 0 ? (maybe_runs ? run_parse(data, n) : ParseOut{})
                          : (use_cand ? cand_parse(data, n, cand, reps)
                                      : hash_parse(data, n, reps));
        if (!c.r.ok) continue;
        c.lit_n = c.r.lits.size();
        c.lp = plan_literals_c(c.r.lits.data(), c.lit_n);
        const size_t ls = c.lp.ok ? 5 + c.lp.csize : 3 + c.lit_n;
        c.reps_out[0] = reps[0]; c.reps_out[1] = reps[1];
        c.reps_out[2] = reps[2];
        c.seq.resize(n + 1024);
        const ptrdiff_t ss =
            seq_encode(c.r.seqs.data(), c.r.seqs.size() / 3, c.reps_out,
                       c.seq.data(), c.seq.size());
        if (ss <= 0) continue;
        c.seq.resize((size_t)ss);
        c.ok = true;
        c.size = ls + (size_t)ss;
    }
    int win = -1;
    for (int i = 0; i < 3; ++i)
        if (cands[i].ok && (win < 0 || cands[i].size < cands[win].size))
            win = i;
    if (win >= 0) {
        const Cand& c = cands[win];
        const uint8_t* lit_src = win == 0 ? data : c.r.lits.data();
        size_t ls = c.lp.ok
                        ? write_literals_c(lit_src, c.lit_n, c.lp,
                                           buf.data(), buf.size())
                        : raw_literals_c(lit_src, c.lit_n, buf.data(),
                                         buf.size());
        if (ls) {
            best.assign(buf.data(), buf.data() + ls);
            if (win == 0)
                best.push_back(0);  // 0 sequences
            else
                best.insert(best.end(), c.seq.begin(), c.seq.end());
            best_reps[0] = c.reps_out[0]; best_reps[1] = c.reps_out[1];
            best_reps[2] = c.reps_out[2];
        }
    }
    if (best.empty() || best.size() >= n) {
        const uint32_t bh = (uint32_t)(last != 0) | ((uint32_t)n << 3);
        out[0] = (uint8_t)bh; out[1] = (uint8_t)(bh >> 8);
        out[2] = (uint8_t)(bh >> 16);
        std::memcpy(out + 3, data, n);
        return (ptrdiff_t)(3 + n);
    }
    if (3 + best.size() > cap) return ERR_DST;
    const uint32_t bh = (uint32_t)(last != 0) | (2u << 1)
                        | ((uint32_t)best.size() << 3);
    out[0] = (uint8_t)bh; out[1] = (uint8_t)(bh >> 8);
    out[2] = (uint8_t)(bh >> 16);
    std::memcpy(out + 3, best.data(), best.size());
    reps[0] = best_reps[0]; reps[1] = best_reps[1]; reps[2] = best_reps[2];
    return (ptrdiff_t)(3 + best.size());
}

// ===================================================================
// Host pass of the batched device zstd decode
// (stenos_tpu_torch/entropy/device_decode.py): per payload (a zstd frame
// and an optional decode-anchor sidecar), the sidecar, frame, block and
// section headers, and per block its literals and its sequences section,
// exactly as that module's Python host pass did one payload at a time:
// the same parse (entropy/sidecar.py split_sidecar, entropy/zstd_parse.py
// parse_frame) and the same choices. The payloads run on a few threads.
//   literals: a K5 job (4 Huffman stream spans, code lengths and anchors,
//             from the sidecar or stn_huf_anchors) when the section holds
//             4 streams of at most max_stream bytes each; else host bytes
//             (raw, RLE, stn_huf_lits)
//   sequences: the stn_zstd_dtables prep (Repeat_Mode chained in order)
// A payload's status: 0 ok, 1 a header the device route rejects (the host
// ladder), 2 corrupt literals.

namespace {

constexpr uint32_t kZstdMagic = 0xFD2FB528u;
constexpr uint32_t kSidecarMagic = 0x184D2A5Cu;
constexpr int64_t kPrepBlockMax = 131072;
enum { PREP_OK = 0, PREP_LADDER = 1, PREP_CORRUPT = 2 };

struct PrepEntry {
    bool present = false;
    uint8_t lens[256];
    int32_t anch[1024];
};

struct PrepLit {
    int kind = 0;  // 0 raw, 1 rle, 2 huf
    int64_t regen = 0, off = 0, length = 0;
    uint8_t byte = 0;
    bool four = false, treeless = false;
};

struct PrepSpec {
    int btype = 0;
    int64_t start = 0, size = 0, rsize = 0;
    PrepLit lit;
    int64_t seq_off = 0, seq_len = 0;
};

struct PrepJob {
    int64_t off[4], len[4];
    uint8_t lens[256];
    int32_t anch[1024];
};

struct PrepSec {
    int64_t stream_off, stream_len, bp0, nseq, tl[3];
    int32_t tab[3 * 512];
};

struct PrepPayload {
    int status = PREP_OK;
    // the headers (prep_headers), used and dropped by prep_body
    bool have = false;
    std::vector<PrepEntry> entries;
    std::vector<PrepSpec> specs;
    // per block: regenerated, host literal bytes before it in lits, job
    // index or -1, section index or -1 (indexes into jobs / secs)
    std::vector<int64_t> blocks;
    std::vector<PrepJob> jobs;
    std::vector<PrepSec> secs;
    std::vector<uint8_t> lits;
};

struct PrepBatch {
    std::vector<PrepPayload> p;
};

inline uint32_t rd16(const uint8_t* p) { return p[0] | (uint32_t)p[1] << 8; }
inline uint32_t rd24(const uint8_t* p) {
    return p[0] | (uint32_t)p[1] << 8 | (uint32_t)p[2] << 16;
}

// sidecar.py _parse_entries; false for None
bool prep_entries(const uint8_t* body, size_t blen,
                  std::vector<PrepEntry>* out) {
    const uint32_t nb = rd24(body);
    size_t p = 3;
    out->clear();
    for (uint32_t k = 0; k < nb; ++k) {
        if (p >= blen) return false;
        const uint8_t flag = body[p++];
        out->emplace_back();
        if (flag == 0) continue;
        if (p + 128 + 4 * (4 + 510) > blen) return false;
        PrepEntry& e = out->back();
        e.present = true;
        for (int i = 0; i < 128; ++i) {
            e.lens[2 * i] = body[p + i] & 15;
            e.lens[2 * i + 1] = body[p + i] >> 4;
        }
        p += 128;
        for (int s = 0; s < 4; ++s) {
            const int64_t total = read32(body + p);
            int64_t a = total;
            e.anch[256 * s] = (int32_t)a;
            for (int j = 1; j < 256; ++j) {
                a -= rd16(body + p + 4 + 2 * (j - 1));
                e.anch[256 * s + j] = (int32_t)a;
            }
            p += 4 + 510;
        }
    }
    return true;
}

// sidecar.py split_sidecar: the frame's end; *have when entries parsed
size_t prep_split_sidecar(const uint8_t* pl, size_t n, bool* have,
                          std::vector<PrepEntry>* entries) {
    *have = false;
    if (n < 9) return n;
    auto rfind = [&](ptrdiff_t hi) -> ptrdiff_t {  // highest i <= hi
        while (hi >= 0) {  // memrchr for the magic's first byte, 0x5C
            const void* q = memrchr(pl, kSidecarMagic & 0xFF, (size_t)hi + 1);
            if (!q) return -1;
            const ptrdiff_t i = (const uint8_t*)q - pl;
            if (read32(pl + i) == kSidecarMagic) return i;
            hi = i - 1;
        }
        return -1;
    };
    ptrdiff_t pos = rfind((ptrdiff_t)n - 4);
    while (pos != -1) {
        if ((size_t)pos + 8 <= n) {
            const uint32_t size = read32(pl + pos + 4);
            if ((size_t)pos + 8 + size == n && size >= 4 && pl[pos + 8] == 1) {
                *have = prep_entries(pl + pos + 9, n - pos - 9, entries);
                return (size_t)pos;
            }
        }
        pos = rfind(pos - 4);
    }
    return n;
}

// zstd_parse.py _parse_sections
bool prep_sections(const uint8_t* pl, PrepSpec* s) {
    int64_t p = s->start;
    const int64_t end = s->start + s->size;
    if (p >= end) return false;
    const uint8_t b0 = pl[p];
    const int ltype = b0 & 3, sf = (b0 >> 2) & 3;
    PrepLit& lit = s->lit;
    if (ltype <= 1) {
        int64_t regen, hlen;
        if (sf == 0 || sf == 2) {
            regen = b0 >> 3;
            hlen = 1;
        } else if (sf == 1) {
            if (p + 2 > end) return false;
            regen = (b0 >> 4) | ((int64_t)pl[p + 1] << 4);
            hlen = 2;
        } else {
            if (p + 3 > end) return false;
            regen = (b0 >> 4) | ((int64_t)pl[p + 1] << 4)
                    | ((int64_t)pl[p + 2] << 12);
            hlen = 3;
        }
        const int64_t body = ltype == 0 ? regen : 1;
        if (p + hlen + body > end) return false;
        lit.kind = ltype;
        lit.regen = regen;
        if (ltype == 0) {
            lit.off = p + hlen;
            lit.length = regen;
        } else {
            lit.byte = pl[p + hlen];
        }
        p += hlen + body;
    } else {
        int64_t regen, csize, hlen;
        bool four = true;
        if (sf <= 1) {
            if (p + 3 > end) return false;
            const uint32_t h = rd24(pl + p);
            regen = (h >> 4) & 0x3FF;
            csize = (h >> 14) & 0x3FF;
            hlen = 3;
            four = sf == 1;
        } else if (sf == 2) {
            if (p + 4 > end) return false;
            const uint32_t h = read32(pl + p);
            regen = (h >> 4) & 0x3FFF;
            csize = (h >> 18) & 0x3FFF;
            hlen = 4;
        } else {
            if (p + 5 > end) return false;
            const uint64_t h = read32(pl + p) | (uint64_t)pl[p + 4] << 32;
            regen = (h >> 4) & 0x3FFFF;
            csize = (h >> 22) & 0x3FFFF;
            hlen = 5;
        }
        if (p + hlen + csize > end) return false;
        lit.kind = 2;
        lit.regen = regen;
        lit.off = p + hlen;
        lit.length = csize;
        lit.four = four;
        lit.treeless = ltype == 3;
        p += hlen + csize;
    }
    s->seq_off = p;
    s->seq_len = end - p;
    return true;
}

// zstd_parse.py parse_frame over pl[0, n); false for None
bool prep_frame(const uint8_t* pl, size_t n, bool* has_content,
                uint64_t* content, std::vector<PrepSpec>* blocks) {
    if (n < 5 || read32(pl) != kZstdMagic) return false;
    const uint8_t fhd = pl[4];
    size_t p = 5;
    const int checksum = (fhd >> 2) & 1, single = (fhd >> 5) & 1;
    const int fcs_code = fhd >> 6;
    if (fhd & 3) return false;
    if (!single) p += 1;
    static const int kFcs[4] = {0, 2, 4, 8};
    const int fcs = fcs_code == 0 ? (single ? 1 : 0) : kFcs[fcs_code];
    *has_content = fcs > 0;
    if (fcs) {
        if (p + fcs > n) return false;
        uint64_t c = 0;
        for (int i = 0; i < fcs; ++i) c |= (uint64_t)pl[p + i] << (8 * i);
        *content = fcs == 2 ? c + 256 : c;
        p += fcs;
    }
    blocks->clear();
    bool last = false;
    while (!last) {
        if (p + 3 > n) return false;
        const uint32_t bh = rd24(pl + p);
        last = bh & 1;
        const int btype = (bh >> 1) & 3;
        const int64_t bsize = bh >> 3;
        p += 3;
        if (btype == 3) return false;
        const int64_t body = btype == 1 ? 1 : bsize;
        if (p + body > n) return false;
        PrepSpec s;
        s.btype = btype;
        s.start = (int64_t)p;
        s.size = body;
        s.rsize = btype != 2 ? bsize : 0;
        if (btype == 2 && !prep_sections(pl, &s)) return false;
        blocks->push_back(s);
        p += body;
    }
    if (checksum) p += 4;
    return p <= n;
}

// device_decode.py's former _spans: the 4 stream spans of a Huffman
// literals section whose tree description starts at p
bool prep_spans(const uint8_t* pl, int64_t p, int64_t lit_end, PrepJob* j) {
    if (p >= lit_end) return false;
    const int tb = pl[p];
    p += 1 + (tb < 128 ? tb : ((tb - 127) + 1) / 2);
    if (p + 6 > lit_end) return false;
    const int64_t j1 = rd16(pl + p), j2 = rd16(pl + p + 2),
                  j3 = rd16(pl + p + 4);
    p += 6;
    const int64_t s4 = lit_end - (p + j1 + j2 + j3);
    if (s4 <= 0) return false;
    const int64_t len[4] = {j1, j2, j3, s4};
    for (int i = 0; i < 4; ++i) {
        j->off[i] = p;
        j->len[i] = len[i];
        p += len[i];
    }
    return true;
}

// huff_decode_kernel.py decode_tables of one job's code lengths: per length
// l the first canonical code base_l, the count n_l and offset_l (the rank of
// the first length-l symbol when symbols sort by length descending, then
// symbol ascending), then that symbol list from column 40, zero-filled.
void prep_k5_table(const uint8_t* lens, int32_t* out) {
    constexpr int kMaxBits = 11;
    int64_t nl[kMaxBits + 1] = {0}, base[kMaxBits + 1] = {0};
    for (int s = 0; s < 256; ++s)
        if (lens[s] <= kMaxBits) ++nl[lens[s]];
    int64_t code = 0;
    for (int l = kMaxBits, prev = kMaxBits; l >= 1; prev = l--) {
        code >>= (prev - l);
        base[l] = code;
        code += nl[l];
    }
    std::memset(out, 0, 304 * sizeof(int32_t));
    int64_t longer = 0, used = 0;
    for (int l = kMaxBits; l >= 1; --l) {
        out[l] = (int32_t)base[l];
        out[12 + l] = (int32_t)nl[l];
        out[24 + l] = (int32_t)longer;
        longer += nl[l];
    }
    used = longer;
    // a stable sort on (11 - length), unused symbols (length 0) last
    int64_t k = 0;
    for (int key = kMaxBits - 15; key <= kMaxBits + 1 && k < used; ++key)
        for (int s = 0; s < 256 && k < used; ++s) {
            const int ks = lens[s] ? kMaxBits - lens[s] : kMaxBits + 1;
            if (ks == key) out[40 + k++] = s;
        }
}

inline bool prep_huf4(const PrepLit& lit) {
    return lit.kind == 2 && lit.four && !lit.treeless && lit.regen >= 64;
}

// The first step: the sidecar and the frame's headers into out. Returns
// the payload's status; adds to *scans the anchor scans (stn_huf_anchors)
// that prep_body will run, the pass's costly part.
int prep_headers(const uint8_t* pl, size_t n, int64_t dsize,
                 PrepPayload* out, size_t* scans) {
    const size_t frame_end = prep_split_sidecar(pl, n, &out->have,
                                                &out->entries);
    bool has_content = false;
    uint64_t content = 0;
    if (!prep_frame(pl, frame_end, &has_content, &content, &out->specs))
        return PREP_LADDER;
    if (has_content && content != (uint64_t)dsize) return PREP_LADDER;
    if (out->have && out->entries.size() != out->specs.size())
        out->have = false;
    for (size_t bi = 0; bi < out->specs.size(); ++bi)
        *scans += out->specs[bi].btype == 2 && prep_huf4(out->specs[bi].lit)
                  && !(out->have && out->entries[bi].present);
    return PREP_OK;
}

// The second step: per block, its literals and its sequences section.
int prep_body(const uint8_t* pl, int64_t max_stream, uint8_t* ctx,
              PrepPayload* out) {
    const bool have = out->have;
    const std::vector<PrepEntry>& entries = out->entries;
    const std::vector<PrepSpec>& blocks = out->specs;
    std::memset(ctx, 0, sizeof(ZstdDecCtx));
    for (size_t bi = 0; bi < blocks.size(); ++bi) {
        const PrepSpec& s = blocks[bi];
        const int64_t lit_at = (int64_t)out->lits.size();
        if (s.btype != 2) {
            const int64_t len = s.btype == 0 ? s.size : s.rsize;
            if (len > kPrepBlockMax) return PREP_LADDER;
            if (s.btype == 0)
                out->lits.insert(out->lits.end(), pl + s.start,
                                 pl + s.start + len);
            else
                out->lits.insert(out->lits.end(), (size_t)len, pl[s.start]);
            out->blocks.insert(out->blocks.end(), {len, lit_at, -1, -1});
            continue;
        }
        const PrepLit& lit = s.lit;
        if (lit.regen > kPrepBlockMax) return PREP_LADDER;
        const bool huf4 = prep_huf4(lit);
        PrepJob job;
        bool ent = false;
        if (huf4 && have && entries[bi].present) {
            std::memcpy(job.lens, entries[bi].lens, 256);
            std::memcpy(job.anch, entries[bi].anch, sizeof job.anch);
            ent = true;
        } else if (huf4) {
            ent = stn_huf_anchors(pl + lit.off, (size_t)lit.length,
                                  (size_t)lit.regen, ctx, job.lens,
                                  job.anch) == 0;
        }
        int64_t job_at = -1;
        if (ent && prep_spans(pl, lit.off, lit.off + lit.length, &job)) {
            bool fits = true;
            for (int i = 0; i < 4; ++i) fits &= job.len[i] <= max_stream;
            if (fits) {
                job_at = (int64_t)out->jobs.size();
                out->jobs.push_back(job);
            }
        }
        if (job_at < 0) {
            if (lit.kind == 0) {
                out->lits.insert(out->lits.end(), pl + lit.off,
                                 pl + lit.off + lit.length);
            } else if (lit.kind == 1) {
                out->lits.insert(out->lits.end(), (size_t)lit.regen, lit.byte);
            } else {
                out->lits.resize(lit_at + lit.regen + 1);
                if (stn_huf_lits(pl + lit.off, (size_t)lit.length, lit.four,
                                 lit.treeless, (size_t)lit.regen, ctx,
                                 out->lits.data() + lit_at) < 0)
                    // a treeless block's table came in a sidecar entry
                    return lit.treeless ? PREP_LADDER : PREP_CORRUPT;
                out->lits.resize(lit_at + lit.regen);
            }
        }
        int64_t sec_at = -1;
        if (!(s.seq_len == 1 && pl[s.seq_off] == 0)) {
            PrepSec sec;
            int32_t meta[8];
            const ptrdiff_t r = stn_zstd_dtables(pl + s.seq_off,
                                                 (size_t)s.seq_len, ctx,
                                                 sec.tab, meta);
            if (r < 0) return PREP_LADDER;
            if (r > 0) {
                sec.stream_off = s.seq_off + meta[1];
                sec.stream_len = s.seq_len - meta[1];
                sec.bp0 = meta[2];
                sec.nseq = r;
                sec.tl[0] = meta[3];
                sec.tl[1] = meta[4];
                sec.tl[2] = meta[5];
                sec_at = (int64_t)out->secs.size();
                out->secs.push_back(sec);
            }
        }
        out->blocks.insert(out->blocks.end(),
                           {lit.regen, job_at < 0 ? lit_at : 0, job_at,
                            sec_at});
    }
    return PREP_OK;
}

}  // namespace

// The host pass over n payloads, payload i at buf[offs[i], offs[i] +
// lens[i]) of dsizes[i] bytes: the headers on the calling thread, then the
// rest on up to `threads` threads, one for each kScansPerThread anchor
// scans (a frame with a sidecar needs none, and then the pass runs on one
// thread: more would cost more than its work). status[i] gets each
// payload's status; counts gets [blocks, jobs, sections, host literal
// bytes, longest job stream, anchor scans] over the payloads whose status
// is 0 (the scans over all). Returns a handle for stn_zstd_prep_fetch
// (then stn_zstd_prep_free).
constexpr size_t kScansPerThread = 8;

EXPORT void* stn_zstd_prep_batch(const uint8_t* buf, const int64_t* offs,
                                 const int64_t* lens, const int64_t* dsizes,
                                 size_t n, int threads, int64_t max_stream,
                                 int32_t* status, int64_t* counts) {
    PrepBatch* h = new PrepBatch;
    h->p.resize(n);
    size_t scans = 0;
    for (size_t i = 0; i < n; ++i)
        h->p[i].status = prep_headers(buf + offs[i], (size_t)lens[i],
                                      dsizes[i], &h->p[i], &scans);
    std::atomic<size_t> next(0);
    auto work = [&]() {
        std::vector<uint8_t> ctx(sizeof(ZstdDecCtx));
        for (size_t i; (i = next.fetch_add(1)) < n;) {
            PrepPayload& pp = h->p[i];
            if (pp.status == PREP_OK)
                pp.status = prep_body(buf + offs[i], max_stream, ctx.data(),
                                      &pp);
            pp.entries = {};
            pp.specs = {};
        }
    };
    const size_t t = std::max<size_t>(
        1, std::min({(scans + kScansPerThread - 1) / kScansPerThread,
                     (size_t)std::max(threads, 1), n}));
    std::vector<std::thread> pool;
    for (size_t k = 1; k < t; ++k) pool.emplace_back(work);
    work();
    for (auto& th : pool) th.join();
    for (int k = 0; k < 5; ++k) counts[k] = 0;
    counts[5] = (int64_t)scans;
    for (size_t i = 0; i < n; ++i) {
        const PrepPayload& pp = h->p[i];
        status[i] = pp.status;
        if (pp.status != PREP_OK) continue;
        counts[0] += (int64_t)pp.blocks.size() / 4;
        counts[1] += (int64_t)pp.jobs.size();
        counts[2] += (int64_t)pp.secs.size();
        counts[3] += (int64_t)pp.lits.size();
        for (const PrepJob& j : pp.jobs)
            for (int s = 0; s < 4; ++s)
                counts[4] = j.len[s] > counts[4] ? j.len[s] : counts[4];
    }
    return h;
}

// The pass's outputs over the payloads whose status is 0, in order:
//   blocks (nblk, 5) int64  payload, regenerated, host literal offset (into
//                           lits), job or -1, section or -1
//   rows (4 njobs, width) uint8  each job's 4 streams, zero-padded
//   anchors (4 njobs, 256) int32, lens (njobs, 256) uint8, tables
//   (4 njobs, 304) int32 (K5's decode tables of each job's lens, a row a
//   stream)
//   meta (nsec, 8) int64    stream offset (into buf), stream length, bp0,
//                           nseq, first sequence, tl_ll, tl_of, tl_ml
//   tabs (nsec, 1536) int32, lits (host literal bytes)
EXPORT void stn_zstd_prep_fetch(void* handle, const uint8_t* buf,
                                const int64_t* offs, int64_t* blocks,
                                uint8_t* rows, int64_t width,
                                int32_t* anchors, uint8_t* lens,
                                int32_t* k5tabs, int64_t* meta,
                                int32_t* tabs, uint8_t* lits) {
    const PrepBatch* h = (const PrepBatch*)handle;
    int64_t nb = 0, nj = 0, ns = 0, nl = 0, seq = 0;
    for (size_t i = 0; i < h->p.size(); ++i) {
        const PrepPayload& pp = h->p[i];
        if (pp.status != PREP_OK) continue;
        for (size_t b = 0; b < pp.blocks.size(); b += 4, ++nb) {
            int64_t* o = blocks + 5 * nb;
            o[0] = (int64_t)i;
            o[1] = pp.blocks[b];
            o[2] = pp.blocks[b + 2] < 0 ? nl + pp.blocks[b + 1] : 0;
            o[3] = pp.blocks[b + 2] < 0 ? -1 : nj + pp.blocks[b + 2];
            o[4] = pp.blocks[b + 3] < 0 ? -1 : ns + pp.blocks[b + 3];
        }
        for (const PrepJob& j : pp.jobs) {
            for (int s = 0; s < 4; ++s) {
                uint8_t* r = rows + (4 * nj + s) * width;
                std::memcpy(r, buf + offs[i] + j.off[s], (size_t)j.len[s]);
                std::memset(r + j.len[s], 0, (size_t)(width - j.len[s]));
            }
            std::memcpy(anchors + 1024 * nj, j.anch, sizeof j.anch);
            std::memcpy(lens + 256 * nj, j.lens, 256);
            prep_k5_table(j.lens, k5tabs + 4 * 304 * nj);
            for (int s = 1; s < 4; ++s)
                std::memcpy(k5tabs + (4 * nj + s) * 304,
                            k5tabs + 4 * 304 * nj, 304 * sizeof(int32_t));
            ++nj;
        }
        for (const PrepSec& s : pp.secs) {
            int64_t* m = meta + 8 * ns;
            m[0] = offs[i] + s.stream_off;
            m[1] = s.stream_len;
            m[2] = s.bp0;
            m[3] = s.nseq;
            m[4] = seq;
            m[5] = s.tl[0];
            m[6] = s.tl[1];
            m[7] = s.tl[2];
            std::memcpy(tabs + 1536 * ns, s.tab, sizeof s.tab);
            seq += s.nseq;
            ++ns;
        }
        std::memcpy(lits + nl, pp.lits.data(), pp.lits.size());
        nl += (int64_t)pp.lits.size();
    }
}

EXPORT void stn_zstd_prep_free(void* handle) { delete (PrepBatch*)handle; }
