// A Zstandard decompressor (RFC 8878) for the host CPU: the frames Orbax's
// checkpoints hold (TensorStore's OCDBT nodes and zarr chunks).
//
// Plain C interface, called through ctypes by ``ops/host_zstd.py``; built
// with the host C++ compiler (``_build.build_host``), not with nvcc.
//
// - ``host_zstd_decompress``: every frame of the input back to back (zstd
//   frames and skippable frames), into one heap buffer that
//   ``host_zstd_free`` releases. Frames with or without a content size, a
//   window descriptor, a content checksum (XXH64's low 32 bits, checked when
//   present); raw, RLE and compressed blocks; Huffman literals (one or four
//   streams, a tree given by FSE-compressed or direct weights, or the
//   previous block's tree: treeless); the sequence section's FSE tables
//   (predefined, RLE, compressed, repeat) and its three repeat offsets.
// - A frame that names a dictionary is refused: no dictionary is known here.
// - The output may not exceed ``max_out`` bytes: a frame that declares more,
//   or that grows past it, is an error before or as the bytes are made.
//
// Every malformed input (a truncated frame, a bad table, an offset before
// the frame's start, a wrong checksum) returns a negative error code, never
// a partial result; ``ops/host_zstd.py`` names each code.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

enum {
    OK = 0,
    ERR_TRUNCATED = -1,     // the input ends inside a frame
    ERR_MAGIC = -2,         // neither a zstd nor a skippable frame's magic
    ERR_RESERVED = -3,      // a reserved bit or block type is set
    ERR_DICTIONARY = -4,    // the frame names a dictionary
    ERR_TOO_LARGE = -5,     // more output than max_out
    ERR_CORRUPT = -6,       // a malformed block, table or bitstream
    ERR_CHECKSUM = -7,      // the content checksum does not match
    ERR_OFFSET = -8,        // a match before the start of the frame
    ERR_SIZE = -9,          // the frame's content size is not what it declared
    ERR_NO_MEMORY = -10,
};

struct Error {
    int code;
};

[[noreturn]] void fail(int code) { throw Error{code}; }

// -- XXH64 ------------------------------------------------------------------

const uint64_t P1 = 0x9E3779B185EBCA87ULL, P2 = 0xC2B2AE3D27D4EB4FULL,
               P3 = 0x165667B19E3779F9ULL, P4 = 0x85EBCA77C2B2AE63ULL,
               P5 = 0x27D4EB2F165667C5ULL;

uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
uint64_t rd64(const uint8_t *p) {
    uint64_t v;
    std::memcpy(&v, p, 8);
    return v;  // little-endian hosts
}
uint32_t rd32(const uint8_t *p) {
    uint32_t v;
    std::memcpy(&v, p, 4);
    return v;
}
uint64_t xround(uint64_t acc, uint64_t in) { return rotl(acc + in * P2, 31) * P1; }
uint64_t xmerge(uint64_t acc, uint64_t v) { return (acc ^ xround(0, v)) * P1 + P4; }

uint64_t xxh64(const uint8_t *p, size_t len, uint64_t seed) {
    const uint8_t *end = p + len;
    uint64_t h;
    if (len >= 32) {
        uint64_t v1 = seed + P1 + P2, v2 = seed + P2, v3 = seed, v4 = seed - P1;
        for (; p + 32 <= end; p += 32) {
            v1 = xround(v1, rd64(p));
            v2 = xround(v2, rd64(p + 8));
            v3 = xround(v3, rd64(p + 16));
            v4 = xround(v4, rd64(p + 24));
        }
        h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
        h = xmerge(xmerge(xmerge(xmerge(h, v1), v2), v3), v4);
    } else {
        h = seed + P5;
    }
    h += len;
    for (; p + 8 <= end; p += 8) h = rotl(h ^ xround(0, rd64(p)), 27) * P1 + P4;
    if (p + 4 <= end) {
        h = rotl(h ^ (uint64_t)rd32(p) * P1, 23) * P2 + P3;
        p += 4;
    }
    for (; p < end; p++) h = rotl(h ^ *p * P5, 11) * P1;
    h ^= h >> 33;
    h *= P2;
    h ^= h >> 29;
    h *= P3;
    h ^= h >> 32;
    return h;
}

// -- bit readers --------------------------------------------------------------

int highbit(uint32_t v) {  // the index of the highest set bit; v > 0
    int r = 0;
    while (v >>= 1) r++;
    return r;
}

// Forward, least significant bit first (FSE table descriptions).
struct FwdBits {
    const uint8_t *p;
    size_t len;
    size_t pos = 0;  // in bits
    uint32_t read(int n) {
        uint32_t v = 0;
        for (int i = 0; i < n; i++, pos++) {
            if (pos / 8 >= len) fail(ERR_CORRUPT);
            v |= (uint32_t)((p[pos / 8] >> (pos % 8)) & 1) << i;
        }
        return v;
    }
    size_t bytes_used() const { return (pos + 7) / 8; }
};

// Backward (Huffman and FSE streams): the last byte's highest set bit marks
// the start; bits are read from there towards the first byte, and reading
// past the first byte gives zeros (``bits`` then goes negative).
struct BackBits {
    const uint8_t *p = nullptr;
    int64_t bits = 0;  // unread bits: positions [0, bits)
    void init(const uint8_t *data, size_t len) {
        if (len == 0) fail(ERR_CORRUPT);
        uint8_t last = data[len - 1];
        if (last == 0) fail(ERR_CORRUPT);
        p = data;
        bits = (int64_t)(len - 1) * 8 + highbit(last);
    }
    uint64_t peek(int n) const {
        if (n == 0 || bits <= 0) return 0;
        int64_t lo = bits - n, first = lo < 0 ? 0 : lo;
        int64_t b0 = first / 8, b1 = (bits - 1) / 8;
        uint64_t acc = 0;
        for (int64_t b = b1; b >= b0; b--) acc = (acc << 8) | p[b];  // n <= 32: 5 bytes
        acc = (acc >> (first - b0 * 8)) & ((1ULL << (bits - first)) - 1);
        return lo < 0 ? acc << (-lo) : acc;
    }
    uint64_t read(int n) {
        uint64_t v = peek(n);
        bits -= n;
        return v;
    }
};

// -- FSE ------------------------------------------------------------------------

struct FseTable {
    int log = 0;
    std::vector<uint8_t> symbol, nbits;
    std::vector<uint16_t> base;
    bool valid = false;
};

void fse_build(FseTable &t, const int16_t *norm, int nsym, int log) {
    size_t size = (size_t)1 << log;
    t.log = log;
    t.symbol.assign(size, 0);
    t.nbits.assign(size, 0);
    t.base.assign(size, 0);
    std::vector<uint16_t> next(nsym);
    size_t high = size;
    for (int s = 0; s < nsym; s++)
        if (norm[s] == -1) {
            t.symbol[--high] = (uint8_t)s;
            next[s] = 1;
        }
    size_t step = (size >> 1) + (size >> 3) + 3, mask = size - 1, pos = 0;
    for (int s = 0; s < nsym; s++) {
        if (norm[s] <= 0) continue;
        next[s] = norm[s];
        for (int i = 0; i < norm[s]; i++) {
            t.symbol[pos] = (uint8_t)s;
            do {
                pos = (pos + step) & mask;
            } while (pos >= high);
        }
    }
    if (pos != 0) fail(ERR_CORRUPT);
    for (size_t i = 0; i < size; i++) {
        uint16_t d = next[t.symbol[i]]++;
        t.nbits[i] = (uint8_t)(log - highbit(d));
        t.base[i] = (uint16_t)(((uint32_t)d << t.nbits[i]) - size);
    }
    t.valid = true;
}

// An FSE table description at p (max_log, max symbol) → bytes read.
size_t fse_read_table(FseTable &t, const uint8_t *p, size_t len, int max_log, int max_sym) {
    FwdBits in{p, len};
    int log = 5 + (int)in.read(4);
    if (log > max_log) fail(ERR_CORRUPT);
    int32_t remaining = 1 << log;
    int16_t freq[256];
    int s = 0;
    while (remaining > 0 && s <= max_sym) {
        int bits = highbit((uint32_t)remaining + 1) + 1;
        uint32_t val = in.read(bits);
        uint32_t lower = (1u << (bits - 1)) - 1;
        uint32_t threshold = (1u << bits) - 1 - ((uint32_t)remaining + 1);
        if ((val & lower) < threshold) {
            in.pos--;
            val &= lower;
        } else if (val > lower) {
            val -= threshold;
        }
        int proba = (int)val - 1;
        remaining -= proba < 0 ? -proba : proba;
        freq[s++] = (int16_t)proba;
        if (proba == 0) {
            int repeat = (int)in.read(2);
            while (true) {
                for (int i = 0; i < repeat && s <= max_sym; i++) freq[s++] = 0;
                if (repeat != 3) break;
                repeat = (int)in.read(2);
            }
        }
    }
    if (remaining != 0 || s > max_sym + 1) fail(ERR_CORRUPT);
    fse_build(t, freq, s, log);
    return in.bytes_used();
}

void fse_rle(FseTable &t, uint8_t sym) {
    t.log = 0;
    t.symbol.assign(1, sym);
    t.nbits.assign(1, 0);
    t.base.assign(1, 0);
    t.valid = true;
}

// -- Huffman --------------------------------------------------------------------

struct Huffman {
    int log = 0;
    std::vector<uint8_t> symbol, nbits;
    bool valid = false;
};

// The tree description at p → bytes read.
size_t huf_read(Huffman &h, const uint8_t *p, size_t len) {
    if (len < 1) fail(ERR_CORRUPT);
    uint8_t weights[256];
    int n = 0;
    size_t used;
    int header = p[0];
    if (header >= 128) {
        n = header - 127;
        used = 1 + (size_t)(n + 1) / 2;
        if (used > len) fail(ERR_CORRUPT);
        for (int i = 0; i < n; i++) {
            uint8_t b = p[1 + i / 2];
            weights[i] = i % 2 ? (b & 15) : (b >> 4);
        }
    } else {
        used = 1 + (size_t)header;
        if (used > len || header == 0) fail(ERR_CORRUPT);
        FseTable t;
        size_t hdr = fse_read_table(t, p + 1, header, 6, 255);
        if (hdr >= (size_t)header) fail(ERR_CORRUPT);
        BackBits in;
        in.init(p + 1 + hdr, header - hdr);
        uint64_t s1 = in.read(t.log), s2 = in.read(t.log);
        while (true) {
            if (n >= 255) fail(ERR_CORRUPT);
            weights[n++] = t.symbol[s1];
            s1 = t.base[s1] + in.read(t.nbits[s1]);
            if (in.bits < 0) {
                if (n >= 255) fail(ERR_CORRUPT);
                weights[n++] = t.symbol[s2];
                break;
            }
            if (n >= 255) fail(ERR_CORRUPT);
            weights[n++] = t.symbol[s2];
            s2 = t.base[s2] + in.read(t.nbits[s2]);
            if (in.bits < 0) {
                if (n >= 255) fail(ERR_CORRUPT);
                weights[n++] = t.symbol[s1];
                break;
            }
        }
    }
    uint32_t sum = 0;
    for (int i = 0; i < n; i++) {
        if (weights[i] > 11) fail(ERR_CORRUPT);
        if (weights[i]) sum += 1u << (weights[i] - 1);
    }
    if (sum == 0) fail(ERR_CORRUPT);
    int log = highbit(sum) + 1;
    if (log > 11) fail(ERR_CORRUPT);
    uint32_t left = (1u << log) - sum;
    if (left & (left - 1)) fail(ERR_CORRUPT);
    weights[n++] = (uint8_t)(highbit(left) + 1);
    uint32_t rank_start[13] = {0}, count[13] = {0};
    for (int i = 0; i < n; i++) count[weights[i]]++;
    uint32_t next = 0;
    for (int w = 1; w <= log; w++) {
        rank_start[w] = next;
        next += count[w] << (w - 1);
    }
    h.log = log;
    h.symbol.assign((size_t)1 << log, 0);
    h.nbits.assign((size_t)1 << log, 0);
    for (int s = 0; s < n; s++) {
        int w = weights[s];
        if (!w) continue;
        uint32_t len_ = (1u << w) >> 1;
        for (uint32_t i = 0; i < len_; i++) {
            h.symbol[rank_start[w] + i] = (uint8_t)s;
            h.nbits[rank_start[w] + i] = (uint8_t)(log + 1 - w);
        }
        rank_start[w] += len_;
    }
    h.valid = true;
    return used;
}

void huf_stream(const Huffman &h, const uint8_t *p, size_t len, uint8_t *out, size_t n) {
    BackBits in;
    in.init(p, len);
    for (size_t i = 0; i < n; i++) {
        uint64_t idx = in.peek(h.log);
        out[i] = h.symbol[idx];
        in.bits -= h.nbits[idx];
    }
    if (in.bits != 0) fail(ERR_CORRUPT);
}

// -- sequences ------------------------------------------------------------------

const uint32_t kLLBase[36] = {0,  1,  2,   3,   4,   5,    6,    7,    8,    9,     10,    11,
                              12, 13, 14,  15,  16,  18,   20,   22,   24,   28,    32,    40,
                              48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const uint8_t kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,  0,  0,  0,  0,  0,  1,  1,
                             1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const uint32_t kMLBase[53] = {3,  4,  5,  6,  7,  8,  9,  10,   11,   12,   13,    14,    15,    16,
                              17, 18, 19, 20, 21, 22, 23, 24,   25,   26,   27,    28,    29,    30,
                              31, 32, 33, 34, 35, 37, 39, 41,   43,   47,   51,    59,    67,    83,
                              99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const uint8_t kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
                             2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const int16_t kLLDefault[36] = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                                2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const int16_t kMLDefault[53] = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const int16_t kOFDefault[29] = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

struct Frame {
    std::vector<uint8_t> &out;
    size_t start;  // the frame's first byte in out
    size_t max_out;
    Huffman huf;
    FseTable ll, of, ml;
    uint32_t rep[3] = {1, 4, 8};
    std::vector<uint8_t> lit;

    void grow(size_t n) {
        if (out.size() + n > max_out) fail(ERR_TOO_LARGE);
    }

    // The literals section at p → bytes read; the literals in lit.
    size_t literals(const uint8_t *p, size_t len) {
        if (len < 1) fail(ERR_CORRUPT);
        int type = p[0] & 3, fmt = (p[0] >> 2) & 3;
        size_t regen, comp = 0, hdr;
        if (type < 2) {
            if (fmt == 0 || fmt == 2) {
                hdr = 1;
                regen = p[0] >> 3;
            } else if (fmt == 1) {
                hdr = 2;
                if (len < 2) fail(ERR_CORRUPT);
                regen = (p[0] >> 4) + ((size_t)p[1] << 4);
            } else {
                hdr = 3;
                if (len < 3) fail(ERR_CORRUPT);
                regen = (p[0] >> 4) + ((size_t)p[1] << 4) + ((size_t)p[2] << 12);
            }
            if (regen > 128 * 1024) fail(ERR_CORRUPT);
            lit.resize(regen);
            if (type == 0) {
                if (hdr + regen > len) fail(ERR_CORRUPT);
                std::memcpy(lit.data(), p + hdr, regen);
                return hdr + regen;
            }
            if (hdr + 1 > len) fail(ERR_CORRUPT);
            std::memset(lit.data(), p[hdr], regen);
            return hdr + 1;
        }
        int streams = fmt == 0 ? 1 : 4;
        if (fmt < 2) {
            hdr = 3;
            if (len < 3) fail(ERR_CORRUPT);
            uint32_t h = p[0] | (p[1] << 8) | ((uint32_t)p[2] << 16);
            regen = (h >> 4) & 0x3FF;
            comp = (h >> 14) & 0x3FF;
        } else if (fmt == 2) {
            hdr = 4;
            if (len < 4) fail(ERR_CORRUPT);
            uint32_t h = rd32(p);
            regen = (h >> 4) & 0x3FFF;
            comp = (h >> 18) & 0x3FFF;
        } else {
            hdr = 5;
            if (len < 5) fail(ERR_CORRUPT);
            uint64_t h = rd32(p) | ((uint64_t)p[4] << 32);
            regen = (h >> 4) & 0x3FFFF;
            comp = (h >> 22) & 0x3FFFF;
        }
        if (regen > 128 * 1024 || hdr + comp > len) fail(ERR_CORRUPT);
        const uint8_t *q = p + hdr;
        size_t qlen = comp;
        if (type == 2) {
            size_t used = huf_read(huf, q, qlen);
            q += used;
            qlen -= used;
        } else if (!huf.valid) {
            fail(ERR_CORRUPT);  // treeless literals with no earlier tree
        }
        lit.resize(regen);
        if (streams == 1) {
            huf_stream(huf, q, qlen, lit.data(), regen);
        } else {
            if (qlen < 6) fail(ERR_CORRUPT);
            size_t s1 = q[0] | (q[1] << 8), s2 = q[2] | (q[3] << 8), s3 = q[4] | (q[5] << 8);
            if (6 + s1 + s2 + s3 > qlen) fail(ERR_CORRUPT);
            size_t s4 = qlen - 6 - s1 - s2 - s3;
            size_t seg = (regen + 3) / 4;
            if (3 * seg > regen) fail(ERR_CORRUPT);
            const uint8_t *d = q + 6;
            huf_stream(huf, d, s1, lit.data(), seg);
            huf_stream(huf, d + s1, s2, lit.data() + seg, seg);
            huf_stream(huf, d + s1 + s2, s3, lit.data() + 2 * seg, seg);
            huf_stream(huf, d + s1 + s2 + s3, s4, lit.data() + 3 * seg, regen - 3 * seg);
        }
        return hdr + comp;
    }

    size_t table(FseTable &t, int mode, const uint8_t *p, size_t len, const int16_t *dflt,
                 int ndflt, int dlog, int max_log, int max_sym) {
        switch (mode) {
        case 0:
            fse_build(t, dflt, ndflt, dlog);
            return 0;
        case 1:
            if (len < 1) fail(ERR_CORRUPT);
            if (p[0] > max_sym) fail(ERR_CORRUPT);
            fse_rle(t, p[0]);
            return 1;
        case 2:
            return fse_read_table(t, p, len, max_log, max_sym);
        default:
            if (!t.valid) fail(ERR_CORRUPT);  // repeat with no earlier table
            return 0;
        }
    }

    void copy_literals(const uint8_t *src, size_t n) {
        grow(n);
        out.insert(out.end(), src, src + n);
    }

    void block(const uint8_t *p, size_t len) {
        size_t used = literals(p, len);
        p += used;
        len -= used;
        if (len < 1) fail(ERR_CORRUPT);
        size_t nseq;
        if (p[0] == 0) {
            nseq = 0;
            p += 1;
            len -= 1;
        } else if (p[0] < 128) {
            nseq = p[0];
            p += 1;
            len -= 1;
        } else if (p[0] < 255) {
            if (len < 2) fail(ERR_CORRUPT);
            nseq = ((size_t)(p[0] - 128) << 8) + p[1];
            p += 2;
            len -= 2;
        } else {
            if (len < 3) fail(ERR_CORRUPT);
            nseq = p[1] + ((size_t)p[2] << 8) + 0x7F00;
            p += 3;
            len -= 3;
        }
        if (nseq == 0) {
            if (len != 0) fail(ERR_CORRUPT);
            copy_literals(lit.data(), lit.size());
            return;
        }
        if (len < 1) fail(ERR_CORRUPT);
        uint8_t modes = p[0];
        if (modes & 3) fail(ERR_RESERVED);
        p += 1;
        len -= 1;
        size_t u = table(ll, modes >> 6, p, len, kLLDefault, 36, 6, 9, 35);
        p += u;
        len -= u;
        u = table(of, (modes >> 4) & 3, p, len, kOFDefault, 29, 5, 8, 31);
        p += u;
        len -= u;
        u = table(ml, (modes >> 2) & 3, p, len, kMLDefault, 53, 6, 9, 52);
        p += u;
        len -= u;
        BackBits in;
        in.init(p, len);
        uint64_t sll = in.read(ll.log), sof = in.read(of.log), sml = in.read(ml.log);
        size_t lit_pos = 0;
        for (size_t i = 0; i < nseq; i++) {
            uint8_t ofc = of.symbol[sof], llc = ll.symbol[sll], mlc = ml.symbol[sml];
            if (llc > 35 || mlc > 52 || ofc > 31) fail(ERR_CORRUPT);
            uint32_t offv = (uint32_t)((1ULL << ofc) + in.read(ofc));
            uint32_t mlen = kMLBase[mlc] + (uint32_t)in.read(kMLBits[mlc]);
            uint32_t llen = kLLBase[llc] + (uint32_t)in.read(kLLBits[llc]);
            if (i + 1 < nseq) {
                sll = ll.base[sll] + in.read(ll.nbits[sll]);
                sml = ml.base[sml] + in.read(ml.nbits[sml]);
                sof = of.base[sof] + in.read(of.nbits[sof]);
            }
            if (in.bits < 0) fail(ERR_CORRUPT);
            uint32_t offset;
            if (offv > 3) {
                offset = offv - 3;
                rep[2] = rep[1];
                rep[1] = rep[0];
                rep[0] = offset;
            } else {
                uint32_t idx = offv - 1 + (llen == 0);
                if (idx == 0) {
                    offset = rep[0];
                } else {
                    offset = idx < 3 ? rep[idx] : rep[0] - 1;
                    if (idx > 1) rep[2] = rep[1];
                    rep[1] = rep[0];
                    rep[0] = offset;
                }
            }
            if (lit_pos + llen > lit.size()) fail(ERR_CORRUPT);
            copy_literals(lit.data() + lit_pos, llen);
            lit_pos += llen;
            if (offset == 0 || offset > out.size() - start) fail(ERR_OFFSET);
            grow(mlen);
            size_t from = out.size() - offset;
            for (uint32_t k = 0; k < mlen; k++) out.push_back(out[from + k]);
        }
        if (in.bits != 0) fail(ERR_CORRUPT);
        copy_literals(lit.data() + lit_pos, lit.size() - lit_pos);
    }
};

// One frame at p (magic checked by the caller) → bytes read.
size_t frame(const uint8_t *p, size_t len, std::vector<uint8_t> &out, size_t max_out) {
    size_t pos = 4;
    if (len < pos + 1) fail(ERR_TRUNCATED);
    uint8_t fhd = p[pos++];
    int fcs_flag = fhd >> 6, single = (fhd >> 5) & 1, checksum = (fhd >> 2) & 1, did = fhd & 3;
    if (fhd & 8) fail(ERR_RESERVED);
    uint64_t window = 0;
    if (!single) {
        if (len < pos + 1) fail(ERR_TRUNCATED);
        uint8_t wd = p[pos++];
        int exponent = wd >> 3, mantissa = wd & 7;
        uint64_t base = 1ULL << (10 + exponent);
        window = base + (base / 8) * mantissa;
    }
    static const int kDidBytes[4] = {0, 1, 2, 4};
    if (len < pos + kDidBytes[did]) fail(ERR_TRUNCATED);
    uint32_t dict = 0;
    for (int i = 0; i < kDidBytes[did]; i++) dict |= (uint32_t)p[pos + i] << (8 * i);
    pos += kDidBytes[did];
    if (dict != 0) fail(ERR_DICTIONARY);
    int fcs_bytes = fcs_flag == 0 ? (single ? 1 : 0) : fcs_flag == 1 ? 2 : fcs_flag == 2 ? 4 : 8;
    bool has_size = fcs_bytes > 0;
    uint64_t size = 0;
    if (len < pos + fcs_bytes) fail(ERR_TRUNCATED);
    for (int i = 0; i < fcs_bytes; i++) size |= (uint64_t)p[pos + i] << (8 * i);
    if (fcs_bytes == 2) size += 256;
    pos += fcs_bytes;
    if (single) window = size;
    if (has_size && size > max_out - out.size()) fail(ERR_TOO_LARGE);
    uint64_t block_max = window < 128 * 1024 ? window : 128 * 1024;
    Frame f{out, out.size(), max_out};
    if (has_size) out.reserve(out.size() + size);
    while (true) {
        if (len < pos + 3) fail(ERR_TRUNCATED);
        uint32_t bh = p[pos] | (p[pos + 1] << 8) | ((uint32_t)p[pos + 2] << 16);
        pos += 3;
        int last = bh & 1, type = (bh >> 1) & 3;
        size_t bsize = bh >> 3;
        if (type == 3) fail(ERR_RESERVED);
        if (type == 1) {
            if (bsize > 128 * 1024) fail(ERR_CORRUPT);
            if (len < pos + 1) fail(ERR_TRUNCATED);
            f.grow(bsize);
            out.insert(out.end(), bsize, p[pos]);
            pos += 1;
        } else {
            if (bsize > block_max) fail(ERR_CORRUPT);
            if (len < pos + bsize) fail(ERR_TRUNCATED);
            if (type == 0) {
                f.copy_literals(p + pos, bsize);
            } else {
                size_t before = out.size();
                f.block(p + pos, bsize);
                if (out.size() - before > 128 * 1024) fail(ERR_CORRUPT);
            }
            pos += bsize;
        }
        if (last) break;
    }
    if (has_size && out.size() - f.start != size) fail(ERR_SIZE);
    if (checksum) {
        if (len < pos + 4) fail(ERR_TRUNCATED);
        uint32_t want = rd32(p + pos);
        uint32_t got = (uint32_t)xxh64(out.data() + f.start, out.size() - f.start, 0);
        if (want != got) fail(ERR_CHECKSUM);
        pos += 4;
    }
    return pos;
}

}  // namespace

extern "C" {

// Every frame of src[0, n) → *out (malloc'ed; release with host_zstd_free)
// and *out_len. → 0, or a negative error code (nothing to free then).
int host_zstd_decompress(const uint8_t *src, int64_t n, int64_t max_out, uint8_t **out,
                         int64_t *out_len) {
    *out = nullptr;
    *out_len = 0;
    if (n < 0 || max_out < 0) return ERR_CORRUPT;
    std::vector<uint8_t> buf;
    try {
        size_t pos = 0, len = (size_t)n;
        while (pos < len) {
            if (len - pos < 4) return ERR_TRUNCATED;
            uint32_t magic = rd32(src + pos);
            if (magic == 0xFD2FB528u) {
                pos += frame(src + pos, len - pos, buf, (size_t)max_out);
            } else if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {
                if (len - pos < 8) return ERR_TRUNCATED;
                uint64_t skip = rd32(src + pos + 4);
                if (len - pos - 8 < skip) return ERR_TRUNCATED;
                pos += 8 + skip;
            } else {
                return ERR_MAGIC;
            }
        }
    } catch (const Error &e) {
        return e.code;
    } catch (const std::bad_alloc &) {
        return ERR_NO_MEMORY;
    }
    uint8_t *mem = (uint8_t *)std::malloc(buf.size() ? buf.size() : 1);
    if (!mem) return ERR_NO_MEMORY;
    std::memcpy(mem, buf.data(), buf.size());
    *out = mem;
    *out_len = (int64_t)buf.size();
    return OK;
}

void host_zstd_free(uint8_t *p) { std::free(p); }

// XXH64 of p[0, n) with seed 0 (the content checksum's hash). For the tests.
uint64_t host_xxh64(const uint8_t *p, int64_t n) { return xxh64(p, (size_t)n, 0); }

}  // extern "C"
