// The bit-level halves of the port's image file codec, for the host CPU.
//
// Plain C interface, called through ctypes by ``ops/host_jpeg.py`` and
// ``ops/host_png.py``; built with the host C++ compiler (``_build.build_host``),
// not with nvcc. The lossy JPEG stages (DCTs, quantisation, colour, sampling)
// stay in numpy; this file does only what is sequential by nature:
//
// - ``jpeg_decode_scan``: one baseline (Huffman, 8-bit) scan's entropy-coded
//   data -> quantised coefficients, natural order, one int16 buffer per
//   component. Byte stuffing, fill bytes, RSTn markers (the DC predictors
//   reset), interleaved and single-component scans. Truncated or corrupt data
//   is an error, never a partial image.
// - ``jpeg_decode_progressive_scan``: one progressive (SOF2) scan, as
//   libjpeg-turbo's ``jdphuff.c`` decodes it: DC first and refinement scans,
//   interleaved or not; AC first and refinement scans of one component with
//   their EOB runs. The coefficients add up across scans.
// - ``jpeg_smooth_blocks``: libjpeg-turbo 3.1's block smoothing
//   (``jdcoefct.c``'s ``decompress_smooth_data``) of one component whose
//   scans left some of its first nine AC coefficients incomplete.
// - ``jpeg_encode_scan``: the inverse, one interleaved scan, padded with ones
//   to a whole byte as libjpeg's ``flush_bits`` pads it.
// - ``png_unfilter``: PNG filter types 0-4 for 1-8 bytes per pixel.

#include <cstdint>
#include <cstring>

namespace {

enum {
    OK = 0,
    ERR_TRUNCATED = -1,    // the scan's data ran out before its last MCU
    ERR_BAD_CODE = -2,     // a bit pattern no Huffman code of the table matches
    ERR_BAD_RESTART = -3,  // a restart interval not followed by the expected RSTn
    ERR_COEF_INDEX = -4,   // a run of zeros past the block's 64th coefficient
    ERR_BAD_TABLE = -5,    // an over-full Huffman table, or a symbol it lacks
    ERR_ARGS = -6,
    ERR_OUT_FULL = -7,     // the encoder's output buffer is too small
    ERR_FILTER = -8,       // a PNG filter type above 4
    ERR_BAD_DC = -9,       // a DC value past the range of an int
};

const int kNatural[64] = {
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
};

// kNatural with 16 entries more, each 63: jdphuff.c's reads past the band
// (a run that overshoots Se) land on the last coefficient, as libjpeg's
// jpeg_natural_order[DCTSIZE2 + 16] makes them land.
const int kNaturalPad[80] = {
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63,
};

const int kLookBits = 9;
const int kTableBytes = 16 + 256;  // one DHT table: counts of lengths 1-16, symbols
const int kParamsPerComp = 5;      // h, v, blocks per buffer row, DC table, AC table

// A Huffman table for decoding (libjpeg's jpeg_make_d_derived_tbl): a
// lookahead of kLookBits bits for the short codes, canonical ranges for the
// rest.
struct DTable {
    int32_t maxcode[18];
    int32_t valoffset[18];
    uint8_t vals[256];
    uint16_t look[1 << kLookBits];  // (length << 8) | symbol; 0: longer code
};

// → false if the counts name more than 256 codes or leave no code that is
// not all ones, as libjpeg refuses them.
bool make_dtable(const uint8_t *t, DTable *d) {
    int huffsize[257];
    uint32_t huffcode[257];
    int n = 0;
    for (int l = 1; l <= 16; ++l) {
        for (int i = 0; i < t[l - 1]; ++i) {
            if (n >= 256) return false;
            huffsize[n++] = l;
        }
    }
    huffsize[n] = 0;
    uint32_t code = 0;
    int si = n ? huffsize[0] : 0, p = 0;
    while (huffsize[p]) {
        while (huffsize[p] == si) huffcode[p++] = code++;
        if (code >= (1u << si)) return false;  // no code may be all ones
        code <<= 1;
        ++si;
    }
    memcpy(d->vals, t + 16, 256);
    p = 0;
    for (int l = 1; l <= 16; ++l) {
        if (t[l - 1]) {
            d->valoffset[l] = p - (int32_t)huffcode[p];
            p += t[l - 1];
            d->maxcode[l] = (int32_t)huffcode[p - 1];
        } else {
            d->maxcode[l] = -1;
        }
    }
    d->maxcode[17] = 0x7FFFFFFF;
    memset(d->look, 0, sizeof d->look);
    p = 0;
    for (int l = 1; l <= kLookBits; ++l) {
        for (int i = 0; i < t[l - 1]; ++i, ++p) {
            uint32_t first = huffcode[p] << (kLookBits - l);
            for (uint32_t k = 0; k < (1u << (kLookBits - l)); ++k)
                d->look[first + k] = (uint16_t)((l << 8) | t[16 + p]);
        }
    }
    return true;
}

// The bits of one restart interval's entropy-coded data. Past the next
// marker (or the end of the file) it reads zeros and counts them in
// ``fake``: a scan that consumed any of them was truncated.
struct Reader {
    const uint8_t *data;
    int64_t size, pos;
    uint64_t buf = 0;  // the next ``nbits`` bits, left-aligned
    int nbits = 0, fake = 0;
    int64_t marker = -1;  // where the marker that ended the data starts, past its fill bytes

    int next_byte() {
        if (marker < 0) {
            if (pos >= size) {
                marker = size;
            } else if (data[pos] != 0xFF) {
                return data[pos++];
            } else {
                int64_t q = pos + 1;
                while (q < size && data[q] == 0xFF) ++q;  // fill bytes
                if (q < size && data[q] == 0) {
                    pos = q + 1;
                    return 0xFF;  // a stuffed 0xFF data byte
                }
                marker = q - 1;  // the last 0xFF, just before the marker's code
            }
        }
        fake += 8;
        return 0;
    }
    void fill() {
        while (nbits <= 56) {
            buf |= (uint64_t)next_byte() << (56 - nbits);
            nbits += 8;
        }
    }
    int get(int n) {  // n in 0..16
        if (n == 0) return 0;
        if (nbits < n) fill();
        int v = (int)(buf >> (64 - n));
        buf <<= n;
        nbits -= n;
        return v;
    }
    bool overrun() const { return nbits < fake; }
    int decode(const DTable &t) {  // → the symbol, or -1
        if (nbits < 16) fill();
        int look = t.look[buf >> (64 - kLookBits)];
        if (look) {
            int l = look >> 8;
            buf <<= l;
            nbits -= l;
            return look & 0xFF;
        }
        int l = kLookBits + 1;
        int32_t code = get(l);
        while (code > t.maxcode[l]) {
            if (++l > 16) return -1;
            code = (code << 1) | get(1);
        }
        return t.vals[t.valoffset[l] + code];
    }
    // The position of the next marker at or after the unread data.
    int64_t next_marker() {
        if (marker >= 0) return marker;
        while (marker < 0) next_byte();
        return marker;
    }
};

inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

// The encoder's Huffman codes (libjpeg's jpeg_make_c_derived_tbl).
struct CTable {
    uint32_t code[256];
    uint8_t size[256];
};

bool make_ctable(const uint8_t *t, CTable *c) {
    DTable d;
    if (!make_dtable(t, &d)) return false;
    memset(c->size, 0, sizeof c->size);
    uint32_t code = 0;
    int p = 0;
    for (int l = 1; l <= 16; ++l) {
        for (int i = 0; i < t[l - 1]; ++i, ++p) {
            c->code[t[16 + p]] = code++;
            c->size[t[16 + p]] = (uint8_t)l;
        }
        code <<= 1;
    }
    return true;
}

struct Writer {
    uint8_t *out;
    int64_t cap, n = 0;
    uint64_t acc = 0;
    int nbits = 0;
    bool full = false;

    void byte(uint8_t b) {
        if (n + 2 > cap) {
            full = true;
            return;
        }
        out[n++] = b;
        if (b == 0xFF) out[n++] = 0;
    }
    void put(uint32_t bits, int len) {
        acc = (acc << len) | (bits & ((1u << len) - 1));
        nbits += len;
        while (nbits >= 8) {
            nbits -= 8;
            byte((uint8_t)(acc >> nbits));
        }
    }
    void flush() {  // pad with ones to a whole byte
        if (nbits) put(0x7F, 8 - nbits);
    }
};

inline int nbits_of(int v) {
    int a = v < 0 ? -v : v, s = 0;
    while (a) {
        ++s;
        a >>= 1;
    }
    return s;
}

}  // namespace

extern "C" {

// Decode one baseline scan whose entropy-coded data start at ``data[start]``.
// ``params``: comps in scan, MCUs per row, MCU rows, restart interval (MCUs,
// 0 for none), then for each component h, v (blocks per MCU; 1, 1 in a
// single-component scan), blocks per row of its buffer, DC table slot (0-3)
// and AC table slot (4-7). ``tables``: 8 tables of kTableBytes; ``coefs[c]``:
// the component's zeroed int16 buffer, 64 a block, natural order.
// → 0 and ``*end`` the position of the marker after the scan, or an error.
int jpeg_decode_scan(const uint8_t *data, int64_t size, int64_t start, const int32_t *params,
                     const uint8_t *tables, int16_t *const *coefs, int64_t *end) {
    const int ncomp = params[0], mcus_x = params[1], mcus_y = params[2];
    const int restart = params[3];
    if (ncomp < 1 || ncomp > 4 || mcus_x < 1 || mcus_y < 1 || restart < 0 || start > size)
        return ERR_ARGS;
    DTable tabs[8];
    bool made[8] = {false};
    const int32_t *cp = params + 4;
    for (int c = 0; c < ncomp; ++c) {
        for (int k = 3; k <= 4; ++k) {
            int slot = cp[c * kParamsPerComp + k];
            if (slot < 0 || slot > 7) return ERR_ARGS;
            if (!made[slot] && !make_dtable(tables + slot * kTableBytes, &tabs[slot]))
                return ERR_BAD_TABLE;
            made[slot] = true;
        }
    }
    Reader r{data, size, start};
    int pred[4] = {0, 0, 0, 0};
    int next_rst = 0;
    const int64_t total = (int64_t)mcus_x * mcus_y;
    for (int64_t m = 0; m < total; ++m) {
        if (restart && m && m % restart == 0) {
            int64_t mk = r.next_marker();
            if (mk + 1 >= size || data[mk + 1] != 0xD0 + next_rst) return ERR_BAD_RESTART;
            next_rst = (next_rst + 1) & 7;
            r = Reader{data, size, mk + 2};
            memset(pred, 0, sizeof pred);
        }
        const int my = (int)(m / mcus_x), mx = (int)(m % mcus_x);
        for (int c = 0; c < ncomp; ++c) {
            const int32_t *q = cp + c * kParamsPerComp;
            const int h = q[0], v = q[1], stride = q[2];
            const DTable &dc = tabs[q[3]], &ac = tabs[q[4]];
            for (int by = 0; by < v; ++by) {
                for (int bx = 0; bx < h; ++bx) {
                    int16_t *blk = coefs[c] + ((int64_t)(my * v + by) * stride + mx * h + bx) * 64;
                    int s = r.decode(dc);
                    if (s < 0) return r.overrun() ? ERR_TRUNCATED : ERR_BAD_CODE;
                    if (s > 15) return ERR_BAD_TABLE;  // a DC category past 8-bit's
                    if (s) pred[c] += extend(r.get(s), s);
                    blk[0] = (int16_t)pred[c];
                    for (int k = 1; k < 64; ++k) {
                        int rs = r.decode(ac);
                        if (rs < 0) return r.overrun() ? ERR_TRUNCATED : ERR_BAD_CODE;
                        int run = rs >> 4, sz = rs & 15;
                        if (sz) {
                            k += run;
                            if (k > 63) return ERR_COEF_INDEX;
                            blk[kNatural[k]] = (int16_t)extend(r.get(sz), sz);
                        } else if (run == 15) {
                            k += 15;
                        } else {
                            break;
                        }
                    }
                }
            }
        }
        if (r.overrun()) return ERR_TRUNCATED;
    }
    *end = r.next_marker();
    return OK;
}

// One progressive scan (SOF2, Huffman, 8-bit) whose entropy-coded data start
// at ``data[start]``, added to the coefficients earlier scans left in
// ``coefs``. ``params``: as ``jpeg_decode_scan``'s, with Ss, Se, Ah and Al
// after the restart interval (8 header entries); the caller has checked them
// as jdphuff.c's start_pass_phuff_decoder does. A DC first scan (Ss 0, Ah 0)
// sets each block's DC to the predicted difference shifted left by Al; a DC
// refinement (Ah > 0) ORs one bit an MCU into it; an AC first scan (one
// component) codes Ss..Se shifted by Al with EOB runs; an AC refinement adds
// a correction bit to each coefficient already nonzero and makes new ones
// +-(1 << Al). An RSTn resets the DC predictors and the EOB run.
// -> 0 and ``*end`` the position of the marker after the scan, or an error.
int jpeg_decode_progressive_scan(const uint8_t *data, int64_t size, int64_t start,
                                 const int32_t *params, const uint8_t *tables,
                                 int16_t *const *coefs, int64_t *end) {
    const int ncomp = params[0], mcus_x = params[1], mcus_y = params[2];
    const int restart = params[3], ss = params[4], se = params[5], ah = params[6];
    const int al = params[7];
    const bool dc_scan = ss == 0;
    if (ncomp < 1 || ncomp > 4 || mcus_x < 1 || mcus_y < 1 || restart < 0 || start > size ||
        se > 63 || ss > se || al > 13 || (!dc_scan && ncomp != 1))
        return ERR_ARGS;
    DTable tabs[8];
    bool made[8] = {false};
    const int32_t *cp = params + 8;
    for (int c = 0; c < ncomp; ++c) {
        // a DC first scan needs its DC table, an AC scan its AC table, a DC
        // refinement none
        if (dc_scan && ah) continue;
        const int slot = cp[c * kParamsPerComp + (dc_scan ? 3 : 4)];
        if (slot < 0 || slot > 7) return ERR_ARGS;
        if (!made[slot] && !make_dtable(tables + slot * kTableBytes, &tabs[slot]))
            return ERR_BAD_TABLE;
        made[slot] = true;
    }
    const int p1 = 1 << al, m1 = -p1;
    Reader r{data, size, start};
    int64_t pred[4] = {0, 0, 0, 0};
    unsigned eobrun = 0;
    int next_rst = 0;
    const int64_t total = (int64_t)mcus_x * mcus_y;
    for (int64_t m = 0; m < total; ++m) {
        if (restart && m && m % restart == 0) {
            int64_t mk = r.next_marker();
            if (mk + 1 >= size || data[mk + 1] != 0xD0 + next_rst) return ERR_BAD_RESTART;
            next_rst = (next_rst + 1) & 7;
            r = Reader{data, size, mk + 2};
            memset(pred, 0, sizeof pred);
            eobrun = 0;
        }
        const int my = (int)(m / mcus_x), mx = (int)(m % mcus_x);
        for (int c = 0; c < ncomp; ++c) {
            const int32_t *q = cp + c * kParamsPerComp;
            const int h = q[0], v = q[1], stride = q[2];
            for (int by = 0; by < v; ++by) {
                for (int bx = 0; bx < h; ++bx) {
                    int16_t *blk = coefs[c] + ((int64_t)(my * v + by) * stride + mx * h + bx) * 64;
                    if (dc_scan && !ah) {  // decode_mcu_DC_first
                        int s = r.decode(tabs[q[3]]);
                        if (s < 0) return r.overrun() ? ERR_TRUNCATED : ERR_BAD_CODE;
                        if (s > 15) return ERR_BAD_TABLE;
                        if (s) pred[c] += extend(r.get(s), s);
                        if (pred[c] > INT32_MAX || pred[c] < INT32_MIN) return ERR_BAD_DC;
                        blk[0] = (int16_t)(uint32_t)((uint32_t)pred[c] << al);
                    } else if (dc_scan) {  // decode_mcu_DC_refine
                        if (r.get(1)) blk[0] = (int16_t)(blk[0] | p1);
                    } else if (!ah) {  // decode_mcu_AC_first
                        if (eobrun > 0) {
                            --eobrun;
                            continue;
                        }
                        const DTable &ac = tabs[q[4]];
                        for (int k = ss; k <= se; ++k) {
                            int rs = r.decode(ac);
                            if (rs < 0) return r.overrun() ? ERR_TRUNCATED : ERR_BAD_CODE;
                            int run = rs >> 4, sz = rs & 15;
                            if (sz) {
                                k += run;
                                blk[kNaturalPad[k]] =
                                    (int16_t)(uint32_t)((uint32_t)extend(r.get(sz), sz) << al);
                            } else if (run == 15) {
                                k += 15;
                            } else {
                                eobrun = 1u << run;
                                if (run) eobrun += r.get(run);
                                --eobrun;
                                break;
                            }
                        }
                    } else {  // decode_mcu_AC_refine
                        const DTable &ac = tabs[q[4]];
                        int k = ss;
                        if (eobrun == 0) {
                            for (; k <= se; ++k) {
                                int rs = r.decode(ac);
                                if (rs < 0) return r.overrun() ? ERR_TRUNCATED : ERR_BAD_CODE;
                                int run = rs >> 4, s = rs & 15;
                                if (s) {  // a size other than 1 only warns in libjpeg
                                    s = r.get(1) ? p1 : m1;
                                } else if (run != 15) {
                                    eobrun = 1u << run;
                                    if (run) eobrun += r.get(run);
                                    break;
                                }
                                do {
                                    int16_t *coef = blk + kNaturalPad[k];
                                    if (*coef != 0) {
                                        if (r.get(1) && (*coef & p1) == 0)
                                            *coef = (int16_t)(*coef + (*coef >= 0 ? p1 : m1));
                                    } else if (--run < 0) {
                                        break;
                                    }
                                    ++k;
                                } while (k <= se);
                                if (s) blk[kNaturalPad[k]] = (int16_t)s;
                            }
                        }
                        if (eobrun > 0) {
                            for (; k <= se; ++k) {
                                int16_t *coef = blk + kNaturalPad[k];
                                if (*coef != 0 && r.get(1) && (*coef & p1) == 0)
                                    *coef = (int16_t)(*coef + (*coef >= 0 ? p1 : m1));
                            }
                            --eobrun;
                        }
                    }
                }
            }
        }
        if (r.overrun()) return ERR_TRUNCATED;
    }
    *end = r.next_marker();
    return OK;
}

// libjpeg-turbo 3.1's block smoothing of one component (jdcoefct.c,
// decompress_smooth_data, with no scan cut short): each block whose
// coefficient k of the first nine AC ones in zigzag order (1, 8, 16, 9, 2, 3,
// 10, 17, 24 in natural order) is still zero and not known to its last bit
// (``coef_bits[k]`` != 0: the Al of the last scan that coded it, -1 if none
// did) gets an estimate from the DC values of the 5x5 blocks around it; where
// no scan coded any of the nine (all -1), the DC is re-estimated as well.
// The window's rows follow libjpeg's iMCU row logic (including its use of
// the padding rows of the last iMCU rows), its columns clamp to the
// component's blocks. ``coefs``: the component's whole buffer (``stride``
// blocks a row, ``v * imcu_rows`` rows); ``out``: a copy of it into which
// the estimates are written. ``params``: stride, width and height in blocks,
// v (blocks an iMCU row holds), iMCU rows. ``qt``: the 64 quantisation values,
// natural order. -> 0.
int jpeg_smooth_blocks(const int16_t *coefs, int16_t *out, const int32_t *params,
                       const int32_t *coef_bits, const int32_t *qt) {
    const int stride = params[0], width = params[1], height = params[2], v = params[3];
    const int imcu_rows = params[4];
    if (stride < width || width < 1 || height < 1 || v < 1 || imcu_rows < 1 ||
        (int64_t)v * imcu_rows < height)
        return ERR_ARGS;
    static const int kPos[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};
    bool change_dc = true;
    for (int k = 1; k <= 9; ++k) change_dc = change_dc && coef_bits[k] == -1;
    int64_t Q[10];
    for (int k = 0; k < 10; ++k) Q[k] = qt[kPos[k]];
    for (int k = 0; k < 10; ++k)
        if (Q[k] == 0) return ERR_ARGS;  // smoothing_ok has ruled this out
    auto estimate = [](int64_t num, int64_t qk, int al, bool clip) {
        int64_t p = ((qk << 7) + (num >= 0 ? num : -num)) / (qk << 8);
        if (clip && al > 0 && p >= (1 << al)) p = (1 << al) - 1;
        return (int16_t)(num >= 0 ? p : -p);
    };
    const int last_row = imcu_rows - 1, last_col = width - 1;
    for (int row = 0; row < imcu_rows; ++row) {
        int block_rows = v;
        if (row == last_row) {
            block_rows = height % v;
            if (block_rows == 0) block_rows = v;
        }
        const int64_t image_block_rows = (int64_t)block_rows * imcu_rows;
        for (int b = 0; b < block_rows; ++b) {
            const int64_t image_block_row = (int64_t)row * block_rows + b;
            const int64_t cur = (int64_t)row * v + b;  // the buffer row
            const int64_t prev = image_block_row > 0 ? cur - 1 : cur;
            const int64_t prev2 = image_block_row > 1 ? cur - 2 : prev;
            const int64_t next = image_block_row < image_block_rows - 1 ? cur + 1 : cur;
            const int64_t next2 = image_block_row < image_block_rows - 2 ? cur + 2 : next;
            const int64_t rows5[5] = {prev2, prev, cur, next, next2};
            for (int col = 0; col < width; ++col) {
                int dc[26];  // DC01..DC25 as libjpeg names them, row by row
                for (int i = 0; i < 5; ++i) {
                    for (int j = 0; j < 5; ++j) {
                        int x = col + j - 2;
                        x = x < 0 ? 0 : (x > last_col ? last_col : x);
                        dc[1 + 5 * i + j] = coefs[(rows5[i] * stride + x) * 64];
                    }
                }
                const int16_t *src = coefs + (cur * stride + col) * 64;
                int16_t *w = out + (cur * stride + col) * 64;
                const int64_t Q00 = Q[0];
#define DC(n) ((int64_t)dc[n])
                if (coef_bits[1] != 0 && src[1] == 0) {
                    int64_t num = Q00 * (change_dc
                        ? (-DC(1) - DC(2) + DC(4) + DC(5) - 3 * DC(6) + 13 * DC(7) -
                           13 * DC(9) + 3 * DC(10) - 3 * DC(11) + 38 * DC(12) - 38 * DC(14) +
                           3 * DC(15) - 3 * DC(16) + 13 * DC(17) - 13 * DC(19) + 3 * DC(20) -
                           DC(21) - DC(22) + DC(24) + DC(25))
                        : (-7 * DC(11) + 50 * DC(12) - 50 * DC(14) + 7 * DC(15)));
                    w[1] = estimate(num, Q[1], coef_bits[1], true);
                }
                if (coef_bits[2] != 0 && src[8] == 0) {
                    int64_t num = Q00 * (change_dc
                        ? (-DC(1) - 3 * DC(2) - 3 * DC(3) - 3 * DC(4) - DC(5) - DC(6) +
                           13 * DC(7) + 38 * DC(8) + 13 * DC(9) - DC(10) + DC(16) -
                           13 * DC(17) - 38 * DC(18) - 13 * DC(19) + DC(20) + DC(21) +
                           3 * DC(22) + 3 * DC(23) + 3 * DC(24) + DC(25))
                        : (-7 * DC(3) + 50 * DC(8) - 50 * DC(18) + 7 * DC(23)));
                    w[8] = estimate(num, Q[2], coef_bits[2], true);
                }
                if (coef_bits[3] != 0 && src[16] == 0) {
                    int64_t num = Q00 * (change_dc
                        ? (DC(3) + 2 * DC(7) + 7 * DC(8) + 2 * DC(9) - 5 * DC(12) -
                           14 * DC(13) - 5 * DC(14) + 2 * DC(17) + 7 * DC(18) + 2 * DC(19) +
                           DC(23))
                        : (-DC(3) + 13 * DC(8) - 24 * DC(13) + 13 * DC(18) - DC(23)));
                    w[16] = estimate(num, Q[3], coef_bits[3], true);
                }
                if (coef_bits[4] != 0 && src[9] == 0) {
                    int64_t num = Q00 * (change_dc
                        ? (-DC(1) + DC(5) + 9 * DC(7) - 9 * DC(9) - 9 * DC(17) + 9 * DC(19) +
                           DC(21) - DC(25))
                        : (DC(10) + DC(16) - 10 * DC(17) + 10 * DC(19) - DC(2) - DC(20) +
                           DC(22) - DC(24) + DC(4) - DC(6) + 10 * DC(7) - 10 * DC(9)));
                    w[9] = estimate(num, Q[4], coef_bits[4], true);
                }
                if (coef_bits[5] != 0 && src[2] == 0) {
                    int64_t num = Q00 * (change_dc
                        ? (2 * DC(7) - 5 * DC(8) + 2 * DC(9) + DC(11) + 7 * DC(12) -
                           14 * DC(13) + 7 * DC(14) + DC(15) + 2 * DC(17) - 5 * DC(18) +
                           2 * DC(19))
                        : (-DC(11) + 13 * DC(12) - 24 * DC(13) + 13 * DC(14) - DC(15)));
                    w[2] = estimate(num, Q[5], coef_bits[5], true);
                }
                if (change_dc) {
                    if (coef_bits[6] != 0 && src[3] == 0)
                        w[3] = estimate(Q00 * (DC(7) - DC(9) + 2 * DC(12) - 2 * DC(14) + DC(17) -
                                               DC(19)), Q[6], coef_bits[6], true);
                    if (coef_bits[7] != 0 && src[10] == 0)
                        w[10] = estimate(Q00 * (DC(7) - 3 * DC(8) + DC(9) - DC(17) +
                                                3 * DC(18) - DC(19)), Q[7], coef_bits[7], true);
                    if (coef_bits[8] != 0 && src[17] == 0)
                        w[17] = estimate(Q00 * (DC(7) - DC(9) - 3 * DC(12) + 3 * DC(14) +
                                                DC(17) - DC(19)), Q[8], coef_bits[8], true);
                    if (coef_bits[9] != 0 && src[24] == 0)
                        w[24] = estimate(Q00 * (DC(7) + 2 * DC(8) + DC(9) - DC(17) -
                                                2 * DC(18) - DC(19)), Q[9], coef_bits[9], true);
                    w[0] = estimate(Q00 * (-2 * DC(1) - 6 * DC(2) - 8 * DC(3) - 6 * DC(4) -
                                           2 * DC(5) - 6 * DC(6) + 6 * DC(7) + 42 * DC(8) +
                                           6 * DC(9) - 6 * DC(10) - 8 * DC(11) + 42 * DC(12) +
                                           152 * DC(13) + 42 * DC(14) - 8 * DC(15) -
                                           6 * DC(16) + 6 * DC(17) + 42 * DC(18) + 6 * DC(19) -
                                           6 * DC(20) - 2 * DC(21) - 6 * DC(22) - 8 * DC(23) -
                                           6 * DC(24) - 2 * DC(25)), Q00, 0, false);
                }
#undef DC
            }
        }
    }
    return OK;
}

// Encode one interleaved scan (no restart interval) of the quantised
// coefficients ``coefs`` (laid out as for ``jpeg_decode_scan``, with the
// same ``params`` and ``tables``) into ``out``. → the bytes written, or an
// error (ERR_OUT_FULL: call again with a larger buffer).
int64_t jpeg_encode_scan(const int32_t *params, const uint8_t *tables,
                         const int16_t *const *coefs, uint8_t *out, int64_t cap) {
    const int ncomp = params[0], mcus_x = params[1], mcus_y = params[2];
    if (ncomp < 1 || ncomp > 4 || mcus_x < 1 || mcus_y < 1 || params[3] != 0) return ERR_ARGS;
    CTable tabs[8];
    bool made[8] = {false};
    const int32_t *cp = params + 4;
    for (int c = 0; c < ncomp; ++c) {
        for (int k = 3; k <= 4; ++k) {
            int slot = cp[c * kParamsPerComp + k];
            if (slot < 0 || slot > 7) return ERR_ARGS;
            if (!made[slot] && !make_ctable(tables + slot * kTableBytes, &tabs[slot]))
                return ERR_BAD_TABLE;
            made[slot] = true;
        }
    }
    Writer w{out, cap};
    int pred[4] = {0, 0, 0, 0};
    for (int my = 0; my < mcus_y; ++my) {
        for (int mx = 0; mx < mcus_x; ++mx) {
            for (int c = 0; c < ncomp; ++c) {
                const int32_t *q = cp + c * kParamsPerComp;
                const int h = q[0], v = q[1], stride = q[2];
                const CTable &dc = tabs[q[3]], &ac = tabs[q[4]];
                for (int by = 0; by < v; ++by) {
                    for (int bx = 0; bx < h; ++bx) {
                        const int16_t *blk =
                            coefs[c] + ((int64_t)(my * v + by) * stride + mx * h + bx) * 64;
                        int diff = blk[0] - pred[c];
                        pred[c] = blk[0];
                        int s = nbits_of(diff);
                        if (!dc.size[s]) return ERR_BAD_TABLE;
                        w.put(dc.code[s], dc.size[s]);
                        if (s) w.put((uint32_t)(diff < 0 ? diff - 1 : diff), s);
                        int run = 0;
                        for (int k = 1; k < 64; ++k) {
                            int val = blk[kNatural[k]];
                            if (!val) {
                                ++run;
                                continue;
                            }
                            for (; run > 15; run -= 16) {
                                if (!ac.size[0xF0]) return ERR_BAD_TABLE;
                                w.put(ac.code[0xF0], ac.size[0xF0]);
                            }
                            int sz = nbits_of(val), sym = (run << 4) | sz;
                            if (!ac.size[sym]) return ERR_BAD_TABLE;
                            w.put(ac.code[sym], ac.size[sym]);
                            w.put((uint32_t)(val < 0 ? val - 1 : val), sz);
                            run = 0;
                        }
                        if (run) {
                            if (!ac.size[0]) return ERR_BAD_TABLE;
                            w.put(ac.code[0], ac.size[0]);
                        }
                    }
                }
            }
            if (w.full) return ERR_OUT_FULL;
        }
    }
    w.flush();
    return w.full ? (int64_t)ERR_OUT_FULL : w.n;
}

// Undo PNG's row filters: ``src`` holds ``rows`` rows of a filter-type byte
// and ``rowbytes`` bytes, ``dst`` receives rows * rowbytes bytes; ``bpp`` is
// the bytes of a whole pixel, at least 1. → 0, or ERR_FILTER.
int png_unfilter(const uint8_t *src, int64_t rows, int64_t rowbytes, int32_t bpp,
                 uint8_t *dst) {
    if (rows < 0 || rowbytes < 1 || bpp < 1 || bpp > 8) return ERR_ARGS;
    for (int64_t y = 0; y < rows; ++y) {
        const uint8_t *in = src + y * (rowbytes + 1);
        uint8_t *cur = dst + y * rowbytes;
        const uint8_t *up = y ? cur - rowbytes : nullptr;
        const int type = in[0];
        ++in;
        for (int64_t x = 0; x < rowbytes; ++x) {
            const int a = x >= bpp ? cur[x - bpp] : 0;
            const int b = up ? up[x] : 0;
            const int c = up && x >= bpp ? up[x - bpp] : 0;
            int pred;
            switch (type) {
                case 0: pred = 0; break;
                case 1: pred = a; break;
                case 2: pred = b; break;
                case 3: pred = (a + b) >> 1; break;
                case 4: {
                    const int p = a + b - c;
                    const int pa = p > a ? p - a : a - p;
                    const int pb = p > b ? p - b : b - p;
                    const int pc = p > c ? p - c : c - p;
                    pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
                    break;
                }
                default: return ERR_FILTER;
            }
            cur[x] = (uint8_t)(in[x] + pred);
        }
    }
    return OK;
}

}  // extern "C"
