// TrueType text as Pillow 12.1 draws it with FreeType 2.14 and HarfBuzz 12
// (through raqm 0.10): the hinted glyph loader with the version-40 bytecode
// interpreter in its backward-compatibility mode, the smooth (gray)
// rasteriser, HarfBuzz's default-feature positioning (GPOS pair kerning,
// FreeType's unhinted advances) and Pillow's ``font_render`` compositing.
//
// Built at first use by ``twinvoice_tpu_torch._build.build_host`` and bound
// by ``ocr/fonts/truetype.py``. Every integer formula follows the library's
// own (FT_MulFix, FT_MulDiv, the 26.6 and F2Dot14 roundings, the cell
// accumulation of ftgrays.c), so that masks equal Pillow's byte for byte.
#include <algorithm>
#include <climits>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

typedef int64_t Long;

// ----------------------------------------------------------- fixed point

Long mul_fix(Long a, Long b) {  // FT_MulFix (x86-64: 32-bit operands)
    long long r = (long long)(int32_t)a * (int32_t)b;
    r += 0x8000 + (r >> 63);
    return (int32_t)(r >> 16);
}

Long div_fix(Long a, Long b) {  // FT_DivFix
    int s = 1;
    uint64_t ua = (uint64_t)a, ub = (uint64_t)b;
    if (a < 0) { ua = (uint64_t)(-a); s = -s; }
    if (b < 0) { ub = (uint64_t)(-b); s = -s; }
    uint64_t q = ub > 0 ? ((ua << 16) + (ub >> 1)) / ub : 0x7FFFFFFFUL;
    Long r = (Long)q;
    return s < 0 ? -r : r;
}

Long mul_div(Long a, Long b, Long c) {  // FT_MulDiv
    int s = 1;
    if (a < 0) { a = -a; s = -s; }
    if (b < 0) { b = -b; s = -s; }
    if (c < 0) { c = -c; s = -s; }
    uint64_t d = c > 0 ? ((uint64_t)a * (uint64_t)b + ((uint64_t)c >> 1)) / (uint64_t)c
                       : 0x7FFFFFFFUL;
    return s < 0 ? -(Long)d : (Long)d;
}

Long mul_div_no_round(Long a, Long b, Long c) {  // FT_MulDiv_No_Round
    int s = 1;
    if (a < 0) { a = -a; s = -s; }
    if (b < 0) { b = -b; s = -s; }
    if (c < 0) { c = -c; s = -s; }
    uint64_t d = c > 0 ? ((uint64_t)a * (uint64_t)b) / (uint64_t)c : 0x7FFFFFFFUL;
    return s < 0 ? -(Long)d : (Long)d;
}

Long mul_fix14(Long a, Long b) {  // TT_MulFix14
    int64_t ab = (int64_t)(int32_t)a * (int32_t)b;
    ab += 0x2000 + (ab >> 63);
    return (int32_t)(ab >> 14);
}

Long dot_fix14(Long ax, Long ay, Long bx, Long by) {  // TT_DotFix14
    int64_t t1 = (int64_t)(int32_t)ax * (int32_t)bx;
    int64_t t2 = (int64_t)(int32_t)ay * (int32_t)by;
    t1 += t2;
    t1 += 0x2000 + (t1 >> 63);
    return (int32_t)(t1 >> 14);
}

inline Long pix_floor(Long x) { return x & -64; }
inline Long pix_round(Long x) { return (x + 32) & -64; }
inline Long pix_ceil(Long x) { return (x + 63) & -64; }

int msb32(uint32_t z) { int s = 0; while (z >>= 1) s++; return s; }

// FT_Vector_NormLen: the unit vector in 16.16, by Newton's iterations.
void norm_len(Long& vx, Long& vy) {
    int32_t x_ = (int32_t)vx, y_ = (int32_t)vy;
    uint32_t x = (uint32_t)x_, y = (uint32_t)y_;
    int sx = 1, sy = 1;
    if (x_ < 0) { x = (uint32_t)(-x_); sx = -sx; }
    if (y_ < 0) { y = (uint32_t)(-y_); sy = -sy; }
    if (x == 0) { if (y > 0) vy = sy * 0x10000; return; }
    if (y == 0) { if (x > 0) vx = sx * 0x10000; return; }
    uint32_t l = x > y ? x + (y >> 1) : y + (x >> 1);
    int shift = 31 - msb32(l);
    shift -= 15 + (l >= (0xAAAAAAAAUL >> shift));
    if (shift > 0) {
        x <<= shift;
        y <<= shift;
        l = x > y ? x + (y >> 1) : y + (x >> 1);
    } else {
        x >>= -shift;
        y >>= -shift;
        l >>= -shift;
    }
    int32_t b = 0x10000 - (int32_t)l;
    x_ = (int32_t)x;
    y_ = (int32_t)y;
    uint32_t u, v;
    int32_t z;
    do {
        u = (uint32_t)(x_ + (int32_t)(((int64_t)x_ * b) >> 16));
        v = (uint32_t)(y_ + (int32_t)(((int64_t)y_ * b) >> 16));
        z = -(int32_t)(u * u + v * v) / 0x200;
        z = (int32_t)(((int64_t)z * ((0x10000 + b) >> 8)) / 0x10000);
        b += z;
    } while (z > 0);
    vx = sx < 0 ? -(Long)u : (Long)u;
    vy = sy < 0 ? -(Long)v : (Long)v;
}

// ------------------------------------------------------------ sfnt bytes

struct Bytes {
    const uint8_t* p = nullptr;
    size_t n = 0;
    uint8_t u8(size_t o) const { return o < n ? p[o] : 0; }
    uint16_t u16(size_t o) const { return (uint16_t)((u8(o) << 8) | u8(o + 1)); }
    int16_t s16(size_t o) const { return (int16_t)u16(o); }
    uint32_t u32(size_t o) const { return ((uint32_t)u16(o) << 16) | u16(o + 2); }
};

struct Vec { Long x = 0, y = 0; };

struct Zone {
    int n_points = 0, n_contours = 0;
    Vec* org = nullptr;
    Vec* cur = nullptr;
    Vec* orus = nullptr;
    uint8_t* tags = nullptr;
    uint16_t* contours = nullptr;
};

struct ZoneStore {
    std::vector<Vec> org, cur, orus;
    std::vector<uint8_t> tags;
    std::vector<uint16_t> contours;
    Zone zone() {
        Zone z;
        z.n_points = (int)org.size();
        z.n_contours = (int)contours.size();
        z.org = org.data(); z.cur = cur.data(); z.orus = orus.data();
        z.tags = tags.data(); z.contours = contours.data();
        return z;
    }
};

const uint8_t TOUCH_X = 0x08, TOUCH_Y = 0x10, TOUCH_BOTH = 0x18;

struct GS {
    Long proj_x = 0x4000, proj_y = 0, dual_x = 0x4000, dual_y = 0, free_x = 0x4000, free_y = 0;
    Long loop = 1;
    Long minimum_distance = 64;
    int round_state = 1;
    bool auto_flip = true;
    Long control_value_cutin = 68;
    Long single_width_cutin = 0;
    Long single_width_value = 0;
    int delta_base = 9;
    int delta_shift = 3;
    uint8_t instruct_control = 0;
    bool scan_control = false;
    int scan_type = 0;
    int gep0 = 1, gep1 = 1, gep2 = 1;
    int rp0 = 0, rp1 = 0, rp2 = 0;
};

struct Def { int range = 0; Long start = 0, end = 0; int opc = 0; bool active = false; };
struct CallRec { int caller_range; Long caller_ip; Long cur_count; Def* def; };

enum { RANGE_NONE = 0, RANGE_FONT = 1, RANGE_CVT = 2, RANGE_GLYPH = 3 };

signed char opcode_length(int op) {
    if (op == 0x40) return -1;
    if (op == 0x41) return -2;
    if (op >= 0xB0 && op <= 0xB7) return (signed char)(op - 0xB0 + 2);
    if (op >= 0xB8 && op <= 0xBF) return (signed char)((op - 0xB8) * 2 + 3);
    return 1;
}

#define PP(a, b) (uint8_t)(((a) << 4) | (b))
const uint8_t POP_PUSH[256] = {
    /* 0x00 */ PP(0,0),PP(0,0),PP(0,0),PP(0,0),PP(0,0),PP(0,0),PP(2,0),PP(2,0),
               PP(2,0),PP(2,0),PP(2,0),PP(2,0),PP(0,2),PP(0,2),PP(0,0),PP(5,0),
    /* 0x10 */ PP(1,0),PP(1,0),PP(1,0),PP(1,0),PP(1,0),PP(1,0),PP(1,0),PP(1,0),
               PP(0,0),PP(0,0),PP(1,0),PP(0,0),PP(1,0),PP(1,0),PP(1,0),PP(1,0),
    /* 0x20 */ PP(1,2),PP(1,0),PP(0,0),PP(2,2),PP(0,1),PP(1,1),PP(1,0),PP(2,0),
               PP(0,0),PP(1,0),PP(2,0),PP(1,0),PP(1,0),PP(0,0),PP(1,0),PP(1,0),
    /* 0x30 */ PP(0,0),PP(0,0),PP(0,0),PP(0,0),PP(1,0),PP(1,0),PP(1,0),PP(1,0),
               PP(1,0),PP(0,0),PP(2,0),PP(2,0),PP(0,0),PP(0,0),PP(2,0),PP(2,0),
    /* 0x40 */ PP(0,0),PP(0,0),PP(2,0),PP(1,1),PP(2,0),PP(1,1),PP(1,1),PP(1,1),
               PP(2,0),PP(2,1),PP(2,1),PP(0,1),PP(0,1),PP(0,0),PP(0,0),PP(0,0),
    /* 0x50 */ PP(2,1),PP(2,1),PP(2,1),PP(2,1),PP(2,1),PP(2,1),PP(1,1),PP(1,1),
               PP(1,0),PP(0,0),PP(2,1),PP(2,1),PP(1,1),PP(1,0),PP(1,0),PP(1,0),
    /* 0x60 */ PP(2,1),PP(2,1),PP(2,1),PP(2,1),PP(1,1),PP(1,1),PP(1,1),PP(1,1),
               PP(1,1),PP(1,1),PP(1,1),PP(1,1),PP(1,1),PP(1,1),PP(1,1),PP(1,1),
    /* 0x70 */ PP(2,0),PP(1,0),PP(1,0),PP(1,0),PP(1,0),PP(1,0),PP(1,0),PP(1,0),
               PP(2,0),PP(2,0),PP(0,0),PP(0,0),PP(0,0),PP(0,0),PP(1,0),PP(1,0),
    /* 0x80 */ PP(0,0),PP(2,0),PP(2,0),PP(0,0),PP(0,0),PP(1,0),PP(2,0),PP(2,0),
               PP(1,1),PP(1,0),PP(3,3),PP(2,1),PP(2,1),PP(1,0),PP(2,0),PP(0,0),
    /* 0x90 */ PP(0,0),PP(0,0),PP(0,0),PP(0,0),PP(0,0),PP(0,0),PP(0,0),PP(0,0),
               PP(0,0),PP(0,0),PP(0,0),PP(0,0),PP(0,0),PP(0,0),PP(0,0),PP(0,0),
    /* 0xA0 */ PP(0,0),PP(0,0),PP(0,0),PP(0,0),PP(0,0),PP(0,0),PP(0,0),PP(0,0),
               PP(0,0),PP(0,0),PP(0,0),PP(0,0),PP(0,0),PP(0,0),PP(0,0),PP(0,0),
    /* 0xB0 */ PP(0,1),PP(0,2),PP(0,3),PP(0,4),PP(0,5),PP(0,6),PP(0,7),PP(0,8),
               PP(0,1),PP(0,2),PP(0,3),PP(0,4),PP(0,5),PP(0,6),PP(0,7),PP(0,8),
    /* 0xC0 */ PP(1,0),PP(1,0),PP(1,0),PP(1,0),PP(1,0),PP(1,0),PP(1,0),PP(1,0),
               PP(1,0),PP(1,0),PP(1,0),PP(1,0),PP(1,0),PP(1,0),PP(1,0),PP(1,0),
    /* 0xD0 */ PP(1,0),PP(1,0),PP(1,0),PP(1,0),PP(1,0),PP(1,0),PP(1,0),PP(1,0),
               PP(1,0),PP(1,0),PP(1,0),PP(1,0),PP(1,0),PP(1,0),PP(1,0),PP(1,0),
    /* 0xE0 */ PP(2,0),PP(2,0),PP(2,0),PP(2,0),PP(2,0),PP(2,0),PP(2,0),PP(2,0),
               PP(2,0),PP(2,0),PP(2,0),PP(2,0),PP(2,0),PP(2,0),PP(2,0),PP(2,0),
    /* 0xF0 */ PP(2,0),PP(2,0),PP(2,0),PP(2,0),PP(2,0),PP(2,0),PP(2,0),PP(2,0),
               PP(2,0),PP(2,0),PP(2,0),PP(2,0),PP(2,0),PP(2,0),PP(2,0),PP(2,0)};
#undef PP

struct Face;

// ----------------------------------------------------- the interpreter

struct Exec {
    // code ranges
    const uint8_t* ranges[4] = {nullptr, nullptr, nullptr, nullptr};
    Long range_size[4] = {0, 0, 0, 0};
    int cur_range = 0, ini_range = 0;
    const uint8_t* code = nullptr;
    Long code_size = 0;
    Long IP = 0;
    int opcode = 0;
    Long length = 0;
    bool step_ins = true;
    int error = 0;
    // stack
    std::vector<Long> stack;
    Long top = 0, args = 0, new_top = 0;
    std::vector<CallRec> calls;
    int call_top = 0;
    std::vector<Def> fdefs, idefs;
    int num_fdefs = 0, max_fdefs = 0, num_idefs = 0, max_idefs = 0, max_func = 0, max_ins = 0;
    // state
    GS gs;
    Zone zp0, zp1, zp2, pts, twilight;
    Long* cvt = nullptr;
    Long cvt_size = 0;
    Long* storage = nullptr;
    Long store_size = 0;
    Long F_dot_P = 0x4000;
    int proj_kind = 0, dual_kind = 0, move_kind = 0;  // 0 general, 1 x, 2 y
    Long period = 64, phase = 0, threshold = 0;
    Long ppem = 0, point_size = 0, scale = 0;
    Long x_scale = 0, y_scale = 0;  // exc->metrics (1.0 for a composite's own program)
    bool is_composite = false;
    bool backward_compatibility = true;
    bool iupx_called = false, iupy_called = false;
    bool grayscale = false, subpixel_hinting_lean = true, grayscale_cleartype = true;
    Long loopcall_counter = 0, loopcall_counter_max = 0, neg_jump_counter = 0, neg_jump_counter_max = 0;

    Long project(Long dx, Long dy) const {
        if (proj_kind == 1) return dx;
        if (proj_kind == 2) return dy;
        return dot_fix14(dx, dy, gs.proj_x, gs.proj_y);
    }
    Long dualproj(Long dx, Long dy) const {
        if (dual_kind == 1) return dx;
        if (dual_kind == 2) return dy;
        return dot_fix14(dx, dy, gs.dual_x, gs.dual_y);
    }
    Long PROJECT(const Vec& a, const Vec& b) const { return project(a.x - b.x, a.y - b.y); }
    Long DUALPROJ(const Vec& a, const Vec& b) const { return dualproj(a.x - b.x, a.y - b.y); }
    Long FAST_PROJECT(const Vec& a) const { return project(a.x, a.y); }
    Long FAST_DUALPROJ(const Vec& a) const { return dualproj(a.x, a.y); }

    void compute_funcs() {
        if (gs.free_x == 0x4000) F_dot_P = gs.proj_x;
        else if (gs.free_y == 0x4000) F_dot_P = gs.proj_y;
        else F_dot_P = ((Long)gs.proj_x * gs.free_x + (Long)gs.proj_y * gs.free_y) >> 14;
        proj_kind = gs.proj_x == 0x4000 ? 1 : gs.proj_y == 0x4000 ? 2 : 0;
        dual_kind = gs.dual_x == 0x4000 ? 1 : gs.dual_y == 0x4000 ? 2 : 0;
        move_kind = 0;
        if (F_dot_P == 0x4000L) {
            if (gs.free_x == 0x4000) move_kind = 1;
            else if (gs.free_y == 0x4000) move_kind = 2;
        }
        if (std::labs(F_dot_P) < 0x400L) F_dot_P = 0x4000L;
    }

    bool post_iup() const { return backward_compatibility && iupx_called && iupy_called; }

    void move(Zone& z, int p, Long d) {
        if (move_kind == 1) {
            if (!backward_compatibility) z.cur[p].x += d;
            z.tags[p] |= TOUCH_X;
            return;
        }
        if (move_kind == 2) {
            if (!post_iup()) z.cur[p].y += d;
            z.tags[p] |= TOUCH_Y;
            return;
        }
        if (gs.free_x != 0) {
            if (!backward_compatibility) z.cur[p].x += mul_div(d, gs.free_x, F_dot_P);
            z.tags[p] |= TOUCH_X;
        }
        if (gs.free_y != 0) {
            if (!post_iup()) z.cur[p].y += mul_div(d, gs.free_y, F_dot_P);
            z.tags[p] |= TOUCH_Y;
        }
    }

    void move_orig(Zone& z, int p, Long d) {
        if (move_kind == 1) { z.org[p].x += d; return; }
        if (move_kind == 2) { z.org[p].y += d; return; }
        if (gs.free_x != 0) z.org[p].x += mul_div(d, gs.free_x, F_dot_P);
        if (gs.free_y != 0) z.org[p].y += mul_div(d, gs.free_y, F_dot_P);
    }

    void move_zp2(int p, Long dx, Long dy, bool touch) {
        if (gs.free_x != 0) {
            if (!backward_compatibility) zp2.cur[p].x += dx;
            if (touch) zp2.tags[p] |= TOUCH_X;
        }
        if (gs.free_y != 0) {
            if (!post_iup()) zp2.cur[p].y += dy;
            if (touch) zp2.tags[p] |= TOUCH_Y;
        }
    }

    Long round(Long d) const {
        Long v;
        switch (gs.round_state) {
        case 0:  // half grid
            if (d >= 0) { v = pix_floor(d) + 32; if (v < 0) v = 32; }
            else { v = -(pix_floor(-d) + 32); if (v > 0) v = -32; }
            return v;
        case 1:  // grid
            if (d >= 0) { v = pix_round(d); if (v < 0) v = 0; }
            else { v = -pix_round(-d); if (v > 0) v = 0; }
            return v;
        case 2:  // double grid
            if (d >= 0) { v = (d + 16) & -32; if (v < 0) v = 0; }
            else { v = -((-d + 16) & -32); if (v > 0) v = 0; }
            return v;
        case 3:  // down to grid
            if (d >= 0) { v = pix_floor(d); if (v < 0) v = 0; }
            else { v = -pix_floor(-d); if (v > 0) v = 0; }
            return v;
        case 4:  // up to grid
            if (d >= 0) { v = pix_ceil(d); if (v < 0) v = 0; }
            else { v = -pix_ceil(-d); if (v > 0) v = 0; }
            return v;
        case 5:  // off
            return d;
        case 6:  // super
            if (d >= 0) {
                v = (d + (threshold - phase)) & -period;
                v += phase;
                if (v < 0) v = phase;
            } else {
                v = -(((threshold - phase) - d) & -period);
                v -= phase;
                if (v > 0) v = -phase;
            }
            return v;
        default:  // super 45
            if (d >= 0) {
                v = ((d + (threshold - phase)) / period) * period;
                v += phase;
                if (v < 0) v = phase;
            } else {
                v = -((((threshold - phase) - d) / period) * period);
                v -= phase;
                if (v > 0) v = -phase;
            }
            return v;
        }
    }

    void set_super_round(Long grid_period, Long selector) {
        switch ((int)(selector & 0xC0)) {
        case 0: period = grid_period / 2; break;
        case 0x40: period = grid_period; break;
        case 0x80: period = grid_period * 2; break;
        default: period = grid_period; break;
        }
        switch ((int)(selector & 0x30)) {
        case 0: phase = 0; break;
        case 0x10: phase = period / 4; break;
        case 0x20: phase = period / 2; break;
        default: phase = period * 3 / 4; break;
        }
        if ((selector & 0x0F) == 0) threshold = period - 1;
        else threshold = ((int)(selector & 0x0F) - 4) * period / 8;
        period >>= 8;
        phase >>= 8;
        threshold >>= 8;
    }

    void normalize(Long vx, Long vy, Long& rx, Long& ry) {
        if (vx == 0 && vy == 0) return;
        norm_len(vx, vy);
        rx = (int16_t)(vx / 4);
        ry = (int16_t)(vy / 4);
    }

    bool goto_range(int range, Long ip) {
        if (range < 1 || range > 3 || !ranges[range]) { error = 1; return false; }
        if (ip > range_size[range]) { error = 1; return false; }
        code = ranges[range];
        code_size = range_size[range];
        IP = ip;
        cur_range = range;
        return true;
    }

    bool skip_code() {
        IP += length;
        if (IP < code_size) {
            opcode = code[IP];
            length = opcode_length(opcode);
            if (length < 0) {
                if (IP + 1 >= code_size) { error = 1; return false; }
                length = 2 - length * code[IP + 1];
            }
            if (IP + length <= code_size) return true;
        }
        error = 1;
        return false;
    }

    static bool bounds(Long x, Long n) { return (uint64_t)x >= (uint64_t)n; }

    Zone* zone_for(int n) { return n == 0 ? &twilight : &pts; }

    int run();
    void ins_iup();
    void ins_ip();
    void ins_deltap(Long* a);
    void ins_deltac(Long* a);
    void ins_mdrp(Long* a);
    void ins_mirp(Long* a);
    bool point_displacement(Long& dx, Long& dy, Zone& zone, int& refp);
};

// IUP helpers (exc->pts, one axis)
struct IupWorker {
    Vec* orgs; Vec* curs; Vec* orus; int max_points; bool ax;  // ax: x axis
    Long& o(Vec* a, int i) { return ax ? a[i].x : a[i].y; }
    void shift(int p1, int p2, int p) {
        Long dx = o(curs, p) - o(orgs, p);
        if (dx != 0) {
            for (int i = p1; i < p; i++) o(curs, i) += dx;
            for (int i = p + 1; i <= p2; i++) o(curs, i) += dx;
        }
    }
    void interpolate(int p1, int p2, int ref1, int ref2) {
        if (p1 > p2) return;
        if ((unsigned)ref1 >= (unsigned)max_points || (unsigned)ref2 >= (unsigned)max_points) return;
        Long orus1 = o(orus, ref1), orus2 = o(orus, ref2);
        if (orus1 > orus2) { std::swap(orus1, orus2); std::swap(ref1, ref2); }
        Long org1 = o(orgs, ref1), org2 = o(orgs, ref2);
        Long cur1 = o(curs, ref1), cur2 = o(curs, ref2);
        Long delta1 = cur1 - org1, delta2 = cur2 - org2;
        if (cur1 == cur2 || orus1 == orus2) {
            for (int i = p1; i <= p2; i++) {
                Long x = o(orgs, i);
                if (x <= org1) x += delta1;
                else if (x >= org2) x += delta2;
                else x = cur1;
                o(curs, i) = x;
            }
        } else {
            Long scale = 0;
            bool valid = false;
            for (int i = p1; i <= p2; i++) {
                Long x = o(orgs, i);
                if (x <= org1) x += delta1;
                else if (x >= org2) x += delta2;
                else {
                    if (!valid) { valid = true; scale = div_fix(cur2 - cur1, orus2 - orus1); }
                    x = cur1 + mul_fix(o(orus, i) - orus1, scale);
                }
                o(curs, i) = x;
            }
        }
    }
};

void Exec::ins_iup() {
    if (pts.n_contours == 0) return;
    IupWorker w;
    uint8_t mask;
    w.orgs = pts.org; w.curs = pts.cur; w.orus = pts.orus; w.max_points = pts.n_points;
    if (opcode & 1) { mask = TOUCH_X; w.ax = true; }
    else { mask = TOUCH_Y; w.ax = false; }
    if (backward_compatibility) {
        if (iupx_called && iupy_called) return;
        if (opcode & 1) iupx_called = true; else iupy_called = true;
    }
    int contour = 0, point = 0;
    do {
        int end_point = pts.contours[contour];
        int first_point = point;
        if (bounds(end_point, pts.n_points)) end_point = pts.n_points - 1;
        while (point <= end_point && (pts.tags[point] & mask) == 0) point++;
        if (point <= end_point) {
            int first_touched = point, cur_touched = point;
            point++;
            while (point <= end_point) {
                if (pts.tags[point] & mask) {
                    w.interpolate(cur_touched + 1, point - 1, cur_touched, point);
                    cur_touched = point;
                }
                point++;
            }
            if (cur_touched == first_touched) w.shift(first_point, end_point, cur_touched);
            else {
                w.interpolate(cur_touched + 1, end_point, cur_touched, first_touched);
                if (first_touched > 0) w.interpolate(first_point, first_touched - 1, cur_touched, first_touched);
            }
        }
        contour++;
    } while (contour < pts.n_contours);
}

void Exec::ins_ip() {
    Long old_range, cur_range_;
    if (top < gs.loop) goto Fail;
    {
        bool tw = gs.gep0 == 0 || gs.gep1 == 0 || gs.gep2 == 0;
        if (bounds(gs.rp1, zp0.n_points)) goto Fail;
        Vec orus_base = tw ? zp0.org[gs.rp1] : zp0.orus[gs.rp1];
        Vec cur_base = zp0.cur[gs.rp1];
        if (bounds(gs.rp1, zp0.n_points) || bounds(gs.rp2, zp1.n_points)) {
            old_range = 0; cur_range_ = 0;
        } else {
            if (tw) old_range = DUALPROJ(zp1.org[gs.rp2], orus_base);
            else if (x_scale == y_scale) old_range = DUALPROJ(zp1.orus[gs.rp2], orus_base);
            else {
                Vec v;
                v.x = mul_fix(zp1.orus[gs.rp2].x - orus_base.x, x_scale);
                v.y = mul_fix(zp1.orus[gs.rp2].y - orus_base.y, y_scale);
                old_range = FAST_DUALPROJ(v);
            }
            cur_range_ = PROJECT(zp1.cur[gs.rp2], cur_base);
        }
        for (; gs.loop > 0; gs.loop--) {
            Long point = stack[--args];
            if (bounds(point, zp2.n_points)) continue;
            Long org_dist, cur_dist, new_dist;
            if (tw) org_dist = DUALPROJ(zp2.org[point], orus_base);
            else if (x_scale == y_scale) org_dist = DUALPROJ(zp2.orus[point], orus_base);
            else {
                Vec v;
                v.x = mul_fix(zp2.orus[point].x - orus_base.x, x_scale);
                v.y = mul_fix(zp2.orus[point].y - orus_base.y, y_scale);
                org_dist = FAST_DUALPROJ(v);
            }
            cur_dist = PROJECT(zp2.cur[point], cur_base);
            if (org_dist) {
                if (old_range) new_dist = mul_div(org_dist, cur_range_, old_range);
                else new_dist = org_dist;
            } else new_dist = 0;
            move(zp2, (int)point, new_dist - cur_dist);
        }
    }
Fail:
    gs.loop = 1;
    new_top = args;
}

void Exec::ins_deltap(Long* a) {
    Long P = ppem;
    Long nump = a[0];
    for (Long k = 1; k <= nump; k++) {
        if (args < 2) { args = 0; goto Fail; }
        args -= 2;
        {
            Long A = (uint16_t)stack[args + 1];
            Long B = stack[args];
            if (!bounds(A, zp0.n_points)) {
                uint64_t C = ((uint64_t)B & 0xF0) >> 4;
                if (opcode == 0x71) C += 16;
                else if (opcode == 0x72) C += 32;
                C += gs.delta_base;
                if ((uint64_t)P == C) {
                    B = (Long)((uint64_t)B & 0xF) - 8;
                    if (B >= 0) B++;
                    B *= 1L << (6 - gs.delta_shift);
                    if (backward_compatibility) {
                        if (!(iupx_called && iupy_called) &&
                            ((is_composite && gs.free_y != 0) || (zp0.tags[A] & TOUCH_Y)))
                            move(zp0, (int)A, B);
                    } else move(zp0, (int)A, B);
                }
            }
        }
    }
Fail:
    new_top = args;
}

void Exec::ins_deltac(Long* a) {
    Long P = ppem;
    Long nump = a[0];
    for (Long k = 1; k <= nump; k++) {
        if (args < 2) { args = 0; goto Fail; }
        args -= 2;
        {
            uint64_t A = (uint64_t)stack[args + 1];
            Long B = stack[args];
            if (A >= (uint64_t)cvt_size) return;
            uint64_t C = ((uint64_t)B & 0xF0) >> 4;
            if (opcode == 0x74) C += 16;
            else if (opcode == 0x75) C += 32;
            C += gs.delta_base;
            if ((uint64_t)P == C) {
                B = (Long)((uint64_t)B & 0xF) - 8;
                if (B >= 0) B++;
                B *= 1L << (6 - gs.delta_shift);
                cvt[A] += B;
            }
        }
    }
Fail:
    new_top = args;
}

void Exec::ins_mdrp(Long* a) {
    int point = (uint16_t)a[0];
    Long org_dist, distance;
    if (bounds(point, zp1.n_points) || bounds(gs.rp0, zp0.n_points)) goto Fail;
    if (gs.gep0 == 0 || gs.gep1 == 0) {
        org_dist = DUALPROJ(zp1.org[point], zp0.org[gs.rp0]);
    } else {
        const Vec& v1 = zp1.orus[point];
        const Vec& v2 = zp0.orus[gs.rp0];
        if (x_scale == y_scale) {
            org_dist = DUALPROJ(v1, v2);
            org_dist = mul_fix(org_dist, x_scale);
        } else {
            Vec v;
            v.x = mul_fix(v1.x - v2.x, x_scale);
            v.y = mul_fix(v1.y - v2.y, y_scale);
            org_dist = FAST_DUALPROJ(v);
        }
    }
    if (gs.single_width_cutin > 0 && org_dist < gs.single_width_value + gs.single_width_cutin &&
        org_dist > gs.single_width_value - gs.single_width_cutin) {
        org_dist = org_dist >= 0 ? gs.single_width_value : -gs.single_width_value;
    }
    if (opcode & 4) distance = round(org_dist);
    else distance = org_dist;  // Round_None, no compensation
    if (opcode & 8) {
        Long md = gs.minimum_distance;
        if (org_dist >= 0) { if (distance < md) distance = md; }
        else { if (distance > -md) distance = -md; }
    }
    org_dist = PROJECT(zp1.cur[point], zp0.cur[gs.rp0]);
    move(zp1, point, distance - org_dist);
Fail:
    gs.rp1 = gs.rp0;
    gs.rp2 = point;
    if (opcode & 16) gs.rp0 = point;
}

void Exec::ins_mirp(Long* a) {
    int point = (uint16_t)a[0];
    uint64_t cvt_entry = (uint64_t)(a[1] + 1);
    Long cvt_dist, distance, cur_dist, org_dist, delta;
    if (bounds(point, zp1.n_points) || cvt_entry >= (uint64_t)(cvt_size + 1) ||
        bounds(gs.rp0, zp0.n_points))
        goto Fail;
    cvt_dist = cvt_entry ? cvt[cvt_entry - 1] : 0;
    delta = cvt_dist - gs.single_width_value;
    if (delta < 0) delta = -delta;
    if (delta < gs.single_width_cutin)
        cvt_dist = cvt_dist >= 0 ? gs.single_width_value : -gs.single_width_value;
    if (gs.gep1 == 0) {
        zp1.org[point].x = zp0.org[gs.rp0].x + mul_fix14(cvt_dist, gs.free_x);
        zp1.org[point].y = zp0.org[gs.rp0].y + mul_fix14(cvt_dist, gs.free_y);
        zp1.cur[point] = zp1.org[point];
    }
    org_dist = DUALPROJ(zp1.org[point], zp0.org[gs.rp0]);
    cur_dist = PROJECT(zp1.cur[point], zp0.cur[gs.rp0]);
    if (gs.auto_flip) {
        if ((org_dist ^ cvt_dist) < 0) cvt_dist = -cvt_dist;
    }
    if (opcode & 4) {
        if (gs.gep0 == gs.gep1) {
            delta = cvt_dist - org_dist;
            if (delta < 0) delta = -delta;
            if (delta > gs.control_value_cutin) cvt_dist = org_dist;
        }
        distance = round(cvt_dist);
    } else distance = cvt_dist;
    if (opcode & 8) {
        Long md = gs.minimum_distance;
        if (org_dist >= 0) { if (distance < md) distance = md; }
        else { if (distance > -md) distance = -md; }
    }
    move(zp1, point, distance - cur_dist);
Fail:
    gs.rp1 = gs.rp0;
    if (opcode & 16) gs.rp0 = point;
    gs.rp2 = point;
}

bool Exec::point_displacement(Long& x, Long& y, Zone& zone, int& refp) {
    Zone zp;
    int p;
    if (opcode & 1) { zp = zp0; p = gs.rp1; }
    else { zp = zp1; p = gs.rp2; }
    if (bounds(p, zp.n_points)) { refp = 0; return false; }
    zone = zp;
    refp = p;
    Long d = PROJECT(zp.cur[p], zp.org[p]);
    x = mul_div(d, gs.free_x, F_dot_P);
    y = mul_div(d, gs.free_y, F_dot_P);
    return true;
}

// ----------------------------------------------------------- the face

struct Glyph {
    std::vector<Vec> pts;         // 26.6, origin-shifted
    std::vector<uint8_t> tags;    // bit 0: on curve
    std::vector<uint16_t> ends;
    Long advance = 0;             // FreeType's hinted advance (26.6)
    Long linear = 0;              // unhinted advance in font units
};

// The auto-hinter's state (FreeType's autofit, Latin writing system):
// the face's style metrics in font units, scaled at each size, and the
// hints of one glyph. The algorithms are in "the auto-hinter" below.
namespace af {

enum { DIR_NONE = 4, DIR_RIGHT = 1, DIR_LEFT = -1, DIR_UP = 2, DIR_DOWN = -2 };
enum { FL_CONIC = 1, FL_CUBIC = 2, FL_CONTROL = 3, FL_TOUCH_X = 4, FL_TOUCH_Y = 8,
       FL_WEAK = 16, FL_NEAR = 32 };
enum { ED_ROUND = 1, ED_SERIF = 2, ED_DONE = 4, ED_NEUTRAL = 8 };
enum { BL_TOP = 1, BL_NEUTRAL = 4, BL_ADJUSTMENT = 8, BL_ACTIVE = 16 };
enum { STYLE_NONE = 0, STYLE_LATIN = 1, STYLE_NONBASE = 0x2000, STYLE_ADJUST_UP = 0x4000,
       STYLE_DIGIT = 0x8000 };

struct Width { Long org = 0, cur = 0, fit = 0; };
struct Blue { Width ref, shoot; Long ascender = 0, descender = 0; int flags = 0; };
struct Axis {  // AF_LatinAxisRec
    std::vector<Width> widths;
    Long standard_width = 0, edge_distance_threshold = 0, scale = 0, delta = 0;
    bool extra_light = false;
    std::vector<Blue> blues;
};
struct Metrics {  // AF_LatinMetricsRec of the latn_dflt style
    int upem = 0;
    Axis axis[2];
    bool digits_have_same_width = true;
};

struct Point { Long fx = 0, fy = 0, ox = 0, oy = 0, x = 0, y = 0, u = 0, v = 0;
               int flags = 0, in_dir = DIR_NONE, out_dir = DIR_NONE, next = 0, prev = 0; };
struct Segment {
    int dir = 0, flags = 0;
    Long pos = 0, delta = 0, min_coord = 0, max_coord = 0, height = 0, score = 32000;
    int link = -1, serif = -1, edge = -1, edge_next = -1, first = -1, last = -1;
};
struct Edge {
    Long fpos = 0, opos = 0, pos = 0, scale = 0;
    int flags = 0, dir = 0;
    const Width* blue_edge = nullptr;
    int link = -1, serif = -1, first = -1, last = -1;
};
struct AxisHints { std::vector<Segment> segments; std::vector<Edge> edges; int major_dir = 0; };
struct Hints {
    std::vector<Point> pts;
    std::vector<int> contours;  // the first point of each contour
    AxisHints axis[2];
    Long x_scale = 0, x_delta = 0, y_scale = 0, y_delta = 0;
    int upem = 1000;
};

}  // namespace af

struct Face {
    std::vector<uint8_t> data;
    Bytes b;
    size_t head = 0, hhea = 0, hmtx = 0, maxp = 0, loca = 0, glyf = 0, cvt_t = 0, fpgm = 0,
           prep = 0, cmap = 0, gpos = 0, gdef = 0, os2 = 0, hvar = 0, post = 0, kern = 0;
    uint32_t glyf_len = 0, cvt_len = 0, fpgm_len = 0, prep_len = 0, loca_len = 0, hmtx_len = 0;
    int upem = 1000, loca_long = 0, num_glyphs = 0, num_hmetrics = 0, head_flags = 0;
    int ascender = 0, descender = 0;
    int max_twilight = 0, max_storage = 0, max_fdefs = 0, max_idefs = 0, max_stack = 0,
        max_ins = 0;
    size_t cmap_sub = 0;
    int cmap_fmt = 0;
    // size
    int ppem = 0;
    Long x_scale = 0, y_scale = 0, size_ascender = 0, size_descender = 0;
    std::vector<Long> cvt_units;   // raw FWord values
    std::vector<Long> cvt;         // scaled
    std::vector<Long> storage;
    ZoneStore twilight;
    GS size_gs;
    Exec exec;
    bool bytecode_ready = false;
    int fpgm_error = 0, prep_error = 0;
    bool hinting_disabled = false;
    // GPOS pair-kerning lookups of the default features, per script class
    std::vector<size_t> kern_latn, kern_dflt;
    std::vector<int> kern_latn_flags, kern_dflt_flags;
    std::vector<uint8_t> last_mask;  // tt_render_text's mask, for tt_take_mask
    bool basic_layout = false;       // Pillow's Layout.BASIC (else raqm)
    // the auto-hinter: each glyph's style, the Latin metrics, their size
    std::vector<uint16_t> af_styles;
    af::Metrics af_metrics;
    Long af_x_scale = 0, af_y_scale = 0;

    bool load(const uint8_t* p, size_t n);
    // FreeType auto-hints a face without a font program.
    bool autohinted() const { return fpgm == 0 || fpgm_len == 0; }
    bool fixed_pitch() const { return post && b.u32(post + 12) != 0; }
    bool italic() const {
        if (os2 && b.u16(os2) != 0xFFFF) return (b.u16(os2 + 62) & (512 | 1)) != 0;
        return (b.u16(head + 44) & 2) != 0;
    }
    uint32_t char_index(uint32_t c) const;
    void hmetrics(int gid, int& aw, int& lsb) const;
    bool set_size(int size);
    int load_glyph(int gid, bool hinted, Glyph& out);
    int load_unscaled(int gid, Glyph& out);
    int load_recursive(int gid, bool hinted, int depth, ZoneStore& zs, Vec pp[4], bool& have_comp_outline);
};

bool Face::load(const uint8_t* p, size_t n) {
    data.assign(p, p + n);
    b.p = data.data();
    b.n = data.size();
    uint32_t tag0 = b.u32(0);
    if (tag0 != 0x00010000 && tag0 != 0x74727565) return false;
    int num_tables = b.u16(4);
    for (int i = 0; i < num_tables; i++) {
        size_t r = 12 + 16 * i;
        uint32_t tag = b.u32(r), off = b.u32(r + 8), len = b.u32(r + 12);
        if ((size_t)off + len > n) return false;
        switch (tag) {
        case 0x68656164: head = off; break;                       // head
        case 0x68686561: hhea = off; break;                       // hhea
        case 0x686d7478: hmtx = off; hmtx_len = len; break;       // hmtx
        case 0x6d617870: maxp = off; break;                       // maxp
        case 0x6c6f6361: loca = off; loca_len = len; break;       // loca
        case 0x676c7966: glyf = off; glyf_len = len; break;       // glyf
        case 0x63767420: cvt_t = off; cvt_len = len; break;       // 'cvt '
        case 0x6670676d: fpgm = off; fpgm_len = len; break;       // fpgm
        case 0x70726570: prep = off; prep_len = len; break;       // prep
        case 0x636d6170: cmap = off; break;                       // cmap
        case 0x47504f53: gpos = off; break;                       // GPOS
        case 0x47444546: gdef = off; break;                       // GDEF
        case 0x4f532f32: os2 = off; break;                        // OS/2
        case 0x706f7374: post = off; break;                       // post
        case 0x6b65726e: kern = off; break;                       // kern
        default: break;
        }
    }
    if (!head || !hhea || !maxp || !loca || !glyf || !cmap || !hmtx) return false;
    upem = b.u16(head + 18);
    head_flags = b.u16(head + 16);
    loca_long = b.s16(head + 50);
    num_glyphs = b.u16(maxp + 4);
    if (b.u32(maxp) >= 0x00010000) {
        max_twilight = b.u16(maxp + 16);
        max_storage = b.u16(maxp + 18);
        max_fdefs = b.u16(maxp + 20);
        max_idefs = b.u16(maxp + 22);
        max_stack = b.u16(maxp + 24);
        max_ins = b.u16(maxp + 26);
    }
    num_hmetrics = b.u16(hhea + 34);
    ascender = b.s16(hhea + 4);
    descender = b.s16(hhea + 6);
    if (os2 && b.u16(os2) != 0xFFFF && (b.u16(os2 + 62) & 128)) {  // USE_TYPO_METRICS
        ascender = b.s16(os2 + 68);
        descender = b.s16(os2 + 70);
    }
    // cmap: the best Unicode subtable (format 12 over format 4)
    int nsub = b.u16(cmap + 2);
    int best = -1;
    for (int i = 0; i < nsub; i++) {
        size_t r = cmap + 4 + 8 * i;
        int pid = b.u16(r), eid = b.u16(r + 2);
        size_t off = cmap + b.u32(r + 4);
        int fmt = b.u16(off);
        int rank = -1;
        if (fmt == 12 && ((pid == 3 && eid == 10) || (pid == 0 && (eid == 4 || eid == 6)))) rank = 3;
        else if (fmt == 4 && ((pid == 3 && eid == 1) || pid == 0)) rank = 2;
        if (rank > best) { best = rank; cmap_sub = off; cmap_fmt = fmt; }
    }
    if (best < 0) return false;
    if (cvt_t) {
        for (uint32_t i = 0; i + 1 < cvt_len; i += 2) cvt_units.push_back(b.s16(cvt_t + i));
    }
    return true;
}

uint32_t Face::char_index(uint32_t c) const {
    if (cmap_fmt == 4) {
        if (c > 0xFFFF) return 0;
        int segx2 = b.u16(cmap_sub + 6);
        size_t ends = cmap_sub + 14, starts = ends + segx2 + 2, deltas = starts + segx2,
               offs = deltas + segx2;
        for (int i = 0; i < segx2; i += 2) {
            uint32_t end = b.u16(ends + i);
            if (c > end) continue;
            uint32_t start = b.u16(starts + i);
            if (c < start) return 0;
            uint32_t ro = b.u16(offs + i);
            int delta = b.s16(deltas + i);
            if (ro == 0) return (uint16_t)(c + delta);
            size_t gp = offs + i + ro + 2 * (c - start);
            uint32_t g = b.u16(gp);
            return g ? (uint16_t)(g + delta) : 0;
        }
        return 0;
    }
    uint32_t ngroups = b.u32(cmap_sub + 12);
    for (uint32_t i = 0; i < ngroups; i++) {
        size_t g = cmap_sub + 16 + 12 * i;
        uint32_t s = b.u32(g), e = b.u32(g + 4);
        if (c >= s && c <= e) return b.u32(g + 8) + (c - s);
    }
    return 0;
}

void Face::hmetrics(int gid, int& aw, int& lsb) const {
    if (num_hmetrics == 0) { aw = 0; lsb = 0; return; }
    if (gid < num_hmetrics) {
        aw = b.u16(hmtx + 4 * gid);
        lsb = b.s16(hmtx + 4 * gid + 2);
    } else {
        aw = b.u16(hmtx + 4 * (num_hmetrics - 1));
        size_t o = hmtx + 4 * num_hmetrics + 2 * (gid - num_hmetrics);
        lsb = o + 2 <= hmtx + hmtx_len ? b.s16(o) : 0;
    }
}

// ------------------------------------------------------ the main loop

int Exec::run() {
    Long ins_counter = 0;
    ini_range = cur_range;
    compute_funcs();
    iupx_called = false;
    iupy_called = false;
    if (IP >= code_size) return 0;
    do {
        opcode = code[IP];
        length = opcode_length(opcode);
        if (length < 0) {
            if (IP + 1 >= code_size) return 1;
            length = 2 - length * code[IP + 1];
        }
        if (IP + length > code_size) return 1;
        args = top - (POP_PUSH[opcode] >> 4);
        if (args < 0) {
            for (int i = 0; i < (POP_PUSH[opcode] >> 4); i++) stack[i] = 0;
            args = 0;
        }
        new_top = args + (POP_PUSH[opcode] & 15);
        if (new_top > (Long)stack.size()) return 1;
        step_ins = true;
        error = 0;
        Long* a = stack.data() + args;
        int op = opcode;
        switch (op) {
        case 0x00: case 0x01: {  // SVTCA
            Long A = (Long)(op & 1) << 14, B = A ^ 0x4000;
            gs.free_x = gs.proj_x = gs.dual_x = A;
            gs.free_y = gs.proj_y = gs.dual_y = B;
            compute_funcs();
            break;
        }
        case 0x02: case 0x03: {  // SPVTCA
            Long A = (Long)(op & 1) << 14, B = A ^ 0x4000;
            gs.proj_x = gs.dual_x = A;
            gs.proj_y = gs.dual_y = B;
            compute_funcs();
            break;
        }
        case 0x04: case 0x05: {  // SFVTCA
            Long A = (Long)(op & 1) << 14, B = A ^ 0x4000;
            gs.free_x = A;
            gs.free_y = B;
            compute_funcs();
            break;
        }
        case 0x06: case 0x07: case 0x08: case 0x09: {  // SPVTL, SFVTL
            int i1 = (uint16_t)a[1], i2 = (uint16_t)a[0];
            if (bounds(i1, zp2.n_points) || bounds(i2, zp1.n_points)) break;
            const Vec& p1 = zp1.cur[i2];
            const Vec& p2 = zp2.cur[i1];
            Long A = p1.x - p2.x, B = p1.y - p2.y;
            int oc = op;
            if (A == 0 && B == 0) { A = 0x4000; oc = 0; }
            if (oc & 1) { Long C = B; B = A; A = -C; }
            if (op <= 0x07) {
                normalize(A, B, gs.proj_x, gs.proj_y);
                gs.dual_x = gs.proj_x; gs.dual_y = gs.proj_y;
            } else normalize(A, B, gs.free_x, gs.free_y);
            compute_funcs();
            break;
        }
        case 0x0A: case 0x0B: {  // SPVFS, SFVFS
            Long Y = (int16_t)a[1], X = (int16_t)a[0];
            if (op == 0x0A) {
                normalize(X, Y, gs.proj_x, gs.proj_y);
                gs.dual_x = gs.proj_x; gs.dual_y = gs.proj_y;
            } else normalize(X, Y, gs.free_x, gs.free_y);
            compute_funcs();
            break;
        }
        case 0x0C: a[0] = gs.proj_x; a[1] = gs.proj_y; break;   // GPV
        case 0x0D: a[0] = gs.free_x; a[1] = gs.free_y; break;   // GFV
        case 0x0E: gs.free_x = gs.proj_x; gs.free_y = gs.proj_y; compute_funcs(); break;  // SFVTPV
        case 0x0F: {  // ISECT
            int point = (uint16_t)a[0], a0 = (uint16_t)a[1], a1 = (uint16_t)a[2],
                b0 = (uint16_t)a[3], b1 = (uint16_t)a[4];
            if (bounds(b0, zp0.n_points) || bounds(b1, zp0.n_points) || bounds(a0, zp1.n_points) ||
                bounds(a1, zp1.n_points) || bounds(point, zp2.n_points))
                break;
            Long dbx = zp0.cur[b1].x - zp0.cur[b0].x, dby = zp0.cur[b1].y - zp0.cur[b0].y;
            Long dax = zp1.cur[a1].x - zp1.cur[a0].x, day = zp1.cur[a1].y - zp1.cur[a0].y;
            Long dx = zp0.cur[b0].x - zp1.cur[a0].x, dy = zp0.cur[b0].y - zp1.cur[a0].y;
            Long disc = mul_div(dax, -dby, 0x40) + mul_div(day, dbx, 0x40);
            Long dotp = mul_div(dax, dbx, 0x40) + mul_div(day, dby, 0x40);
            if (19 * std::labs(disc) > std::labs(dotp)) {
                Long val = mul_div(dx, -dby, 0x40) + mul_div(dy, dbx, 0x40);
                Long rx = mul_div(val, dax, disc), ry = mul_div(val, day, disc);
                zp2.cur[point].x = zp1.cur[a0].x + rx;
                zp2.cur[point].y = zp1.cur[a0].y + ry;
            } else {
                zp2.cur[point].x = (zp1.cur[a0].x + zp1.cur[a1].x + zp0.cur[b0].x + zp0.cur[b1].x) / 4;
                zp2.cur[point].y = (zp1.cur[a0].y + zp1.cur[a1].y + zp0.cur[b0].y + zp0.cur[b1].y) / 4;
            }
            zp2.tags[point] |= TOUCH_BOTH;
            break;
        }
        case 0x10: gs.rp0 = (uint16_t)a[0]; break;
        case 0x11: gs.rp1 = (uint16_t)a[0]; break;
        case 0x12: gs.rp2 = (uint16_t)a[0]; break;
        case 0x13: case 0x14: case 0x15: case 0x16: {  // SZP0, SZP1, SZP2, SZPS
            if (a[0] != 0 && a[0] != 1) { error = 1; break; }
            Zone* z = zone_for((int)a[0]);
            if (op == 0x13) { zp0 = *z; gs.gep0 = (int)a[0]; }
            else if (op == 0x14) { zp1 = *z; gs.gep1 = (int)a[0]; }
            else if (op == 0x15) { zp2 = *z; gs.gep2 = (int)a[0]; }
            else { zp0 = zp1 = zp2 = *z; gs.gep0 = gs.gep1 = gs.gep2 = (int)a[0]; }
            break;
        }
        case 0x17:  // SLOOP
            if (a[0] < 0) error = 1;
            else gs.loop = a[0] > 0xFFFFL ? 0xFFFFL : a[0];
            break;
        case 0x18: gs.round_state = 1; break;  // RTG
        case 0x19: gs.round_state = 0; break;  // RTHG
        case 0x1A: gs.minimum_distance = a[0]; break;
        case 0x1B: {  // ELSE
            int nifs = 1;
            do {
                if (!skip_code()) break;
                if (opcode == 0x58) nifs++;
                else if (opcode == 0x59) nifs--;
            } while (nifs != 0);
            break;
        }
        case 0x1C:  // JMPR
        jmpr:
            if (a[0] == 0 && args == 0) { error = 1; break; }
            IP += a[0];
            if (IP < 0 || (call_top > 0 && IP > calls[call_top - 1].def->end)) { error = 1; break; }
            step_ins = false;
            if (a[0] < 0 && ++neg_jump_counter > neg_jump_counter_max) error = 1;
            break;
        case 0x1D: gs.control_value_cutin = a[0]; break;
        case 0x1E: gs.single_width_cutin = a[0]; break;
        case 0x1F: gs.single_width_value = mul_fix(a[0], scale); break;
        case 0x20: a[1] = a[0]; break;  // DUP
        case 0x21: break;               // POP
        case 0x22: new_top = 0; break;  // CLEAR
        case 0x23: std::swap(a[0], a[1]); break;
        case 0x24: a[0] = top; break;   // DEPTH
        case 0x25: {  // CINDEX
            Long L = a[0];
            if (L <= 0 || L > args) { error = 1; a[0] = 0; }
            else a[0] = stack[args - L];
            break;
        }
        case 0x26: {  // MINDEX
            Long L = a[0];
            if (L <= 0 || L > args) { error = 1; break; }
            Long K = stack[args - L];
            std::memmove(&stack[args - L], &stack[args - L + 1], (size_t)(L - 1) * sizeof(Long));
            stack[args - 1] = K;
            break;
        }
        case 0x27: {  // ALIGNPTS
            int p1 = (uint16_t)a[0], p2 = (uint16_t)a[1];
            if (bounds(p1, zp1.n_points) || bounds(p2, zp0.n_points)) break;
            Long d = PROJECT(zp0.cur[p2], zp1.cur[p1]) / 2;
            move(zp1, p1, d);
            move(zp0, p2, -d);
            break;
        }
        case 0x29: {  // UTP
            int point = (uint16_t)a[0];
            if (bounds(point, zp0.n_points)) break;
            uint8_t mask = 0xFF;
            if (gs.free_x != 0) mask &= ~TOUCH_X;
            if (gs.free_y != 0) mask &= ~TOUCH_Y;
            zp0.tags[point] &= mask;
            break;
        }
        case 0x2A: case 0x2B: {  // LOOPCALL, CALL
            uint64_t F = (uint64_t)(op == 0x2B ? a[0] : a[1]);
            if (F >= (uint64_t)max_func + 1 || fdefs.empty()) { error = 1; break; }
            Def* def = &fdefs[F];
            if (max_func + 1 != num_fdefs || (uint64_t)def->opc != F) {
                def = nullptr;
                for (int i = 0; i < num_fdefs; i++)
                    if ((uint64_t)fdefs[i].opc == F) { def = &fdefs[i]; break; }
                if (!def) { error = 1; break; }
            }
            if (!def->active) { error = 1; break; }
            if (op == 0x2A && a[0] <= 0) break;
            if (call_top >= (int)calls.size()) { error = 1; break; }
            CallRec& r = calls[call_top];
            r.caller_range = cur_range;
            r.caller_ip = IP + 1;
            r.cur_count = op == 0x2B ? 1 : a[0];
            r.def = def;
            call_top++;
            goto_range(def->range, def->start);
            step_ins = false;
            if (op == 0x2A) {
                loopcall_counter += a[0];
                if (loopcall_counter > loopcall_counter_max) error = 1;
            }
            break;
        }
        case 0x2C: {  // FDEF
            if (ini_range == RANGE_GLYPH) { error = 1; break; }
            uint64_t n = (uint64_t)a[0];
            int idx = -1;
            for (int i = 0; i < num_fdefs; i++) if ((uint64_t)fdefs[i].opc == n) { idx = i; break; }
            if (idx < 0) {
                if (num_fdefs >= max_fdefs) { error = 1; break; }
                idx = num_fdefs++;
            }
            if (n > 0xFFFFU) { error = 1; break; }
            Def& rec = fdefs[idx];
            rec.range = cur_range;
            rec.opc = (int)n;
            rec.start = IP + 1;
            rec.active = true;
            if ((int)n > max_func) max_func = (int)n;
            bool done = false;
            while (skip_code()) {
                if (opcode == 0x89 || opcode == 0x2C) { error = 1; done = true; break; }
                if (opcode == 0x2D) { rec.end = IP; done = true; break; }
            }
            (void)done;
            break;
        }
        case 0x2D: {  // ENDF
            if (call_top <= 0) { error = 1; break; }
            call_top--;
            CallRec& r = calls[call_top];
            r.cur_count--;
            step_ins = false;
            if (r.cur_count > 0) {
                call_top++;
                IP = r.def->start;
            } else goto_range(r.caller_range, r.caller_ip);
            break;
        }
        case 0x2E: case 0x2F: {  // MDAP
            int point = (uint16_t)a[0];
            if (bounds(point, zp0.n_points)) break;
            Long d = 0;
            if (op & 1) {
                Long cd = FAST_PROJECT(zp0.cur[point]);
                d = round(cd) - cd;
            }
            move(zp0, point, d);
            gs.rp0 = point;
            gs.rp1 = point;
            break;
        }
        case 0x30: case 0x31: ins_iup(); break;
        case 0x32: case 0x33: {  // SHP
            if (top < gs.loop) { gs.loop = 1; new_top = args; break; }
            Zone zp; int refp; Long dx, dy;
            if (!point_displacement(dx, dy, zp, refp)) break;
            while (gs.loop > 0) {
                args--;
                int point = (uint16_t)stack[args];
                if (!bounds(point, zp2.n_points)) {
                    if (backward_compatibility) move_zp2(point, 0, dy, true);
                    else move_zp2(point, dx, dy, true);
                }
                gs.loop--;
            }
            gs.loop = 1;
            new_top = args;
            break;
        }
        case 0x34: case 0x35: {  // SHC
            int contour = (int16_t)a[0];
            int bnds = gs.gep2 == 0 ? 1 : zp2.n_contours;
            if (bounds(contour, bnds)) break;
            Zone zp; int refp; Long dx, dy;
            if (!point_displacement(dx, dy, zp, refp)) break;
            int start = contour == 0 ? 0 : zp2.contours[contour - 1] + 1;
            int limit = gs.gep2 == 0 ? zp2.n_points : zp2.contours[contour] + 1;
            for (int i = start; i < limit; i++)
                if (zp.cur != zp2.cur || refp != i) move_zp2(i, dx, dy, true);
            break;
        }
        case 0x36: case 0x37: {  // SHZ
            if (bounds(a[0], 2)) break;
            Zone zp; int refp; Long dx, dy;
            if (!point_displacement(dx, dy, zp, refp)) break;
            int limit;
            if (gs.gep2 == 0) limit = zp2.n_points;
            else if (gs.gep2 == 1 && zp2.n_contours > 0) limit = zp2.contours[zp2.n_contours - 1] + 1;
            else limit = 0;
            for (int i = 0; i < limit; i++)
                if (zp.cur != zp2.cur || refp != i) move_zp2(i, dx, dy, false);
            break;
        }
        case 0x38: {  // SHPIX
            bool in_tw = gs.gep0 == 0 || gs.gep1 == 0 || gs.gep2 == 0;
            if (top < gs.loop + 1) { gs.loop = 1; new_top = args; break; }
            Long dx = mul_fix14(a[0], gs.free_x), dy = mul_fix14(a[0], gs.free_y);
            while (gs.loop > 0) {
                args--;
                int point = (uint16_t)stack[args];
                if (!bounds(point, zp2.n_points)) {
                    if (backward_compatibility) {
                        if (in_tw || (!(iupx_called && iupy_called) &&
                                      ((is_composite && gs.free_y != 0) || (zp2.tags[point] & TOUCH_Y))))
                            move_zp2(point, 0, dy, true);
                    } else move_zp2(point, dx, dy, true);
                }
                gs.loop--;
            }
            gs.loop = 1;
            new_top = args;
            break;
        }
        case 0x39: ins_ip(); break;
        case 0x3A: case 0x3B: {  // MSIRP
            int point = (uint16_t)a[0];
            if (bounds(point, zp1.n_points) || bounds(gs.rp0, zp0.n_points)) break;
            if (gs.gep1 == 0) {
                zp1.org[point] = zp0.org[gs.rp0];
                move_orig(zp1, point, a[1]);
                zp1.cur[point] = zp1.org[point];
            }
            Long d = PROJECT(zp1.cur[point], zp0.cur[gs.rp0]);
            move(zp1, point, a[1] - d);
            gs.rp1 = gs.rp0;
            gs.rp2 = point;
            if (op & 1) gs.rp0 = point;
            break;
        }
        case 0x3C: {  // ALIGNRP
            if (top < gs.loop || bounds(gs.rp0, zp0.n_points)) { gs.loop = 1; new_top = args; break; }
            while (gs.loop > 0) {
                args--;
                int point = (uint16_t)stack[args];
                if (!bounds(point, zp1.n_points)) {
                    Long d = PROJECT(zp1.cur[point], zp0.cur[gs.rp0]);
                    move(zp1, point, -d);
                }
                gs.loop--;
            }
            gs.loop = 1;
            new_top = args;
            break;
        }
        case 0x3D: gs.round_state = 2; break;  // RTDG
        case 0x3E: case 0x3F: {  // MIAP
            uint64_t ce = (uint64_t)a[1];
            int point = (uint16_t)a[0];
            if (bounds(point, zp0.n_points) || ce >= (uint64_t)cvt_size) {
                gs.rp0 = point; gs.rp1 = point; break;
            }
            Long distance = cvt[ce];
            if (gs.gep0 == 0) {
                zp0.org[point].x = mul_fix14(distance, gs.free_x);
                zp0.org[point].y = mul_fix14(distance, gs.free_y);
                zp0.cur[point] = zp0.org[point];
            }
            Long org_dist = FAST_PROJECT(zp0.cur[point]);
            if (op & 1) {
                Long delta = distance - org_dist;
                if (delta < 0) delta = -delta;
                if (delta > gs.control_value_cutin) distance = org_dist;
                distance = round(distance);
            }
            move(zp0, point, distance - org_dist);
            gs.rp0 = point;
            gs.rp1 = point;
            break;
        }
        case 0x40: case 0x41: {  // NPUSHB, NPUSHW
            Long L = code[IP + 1];
            if (L + top > (Long)stack.size()) { error = 1; break; }
            if (op == 0x40) for (Long k = 0; k < L; k++) a[k] = code[IP + 2 + k];
            else for (Long k = 0; k < L; k++)
                a[k] = (int16_t)((code[IP + 2 + 2 * k] << 8) | code[IP + 3 + 2 * k]);
            new_top += L;
            break;
        }
        case 0x42: {  // WS
            uint64_t I = (uint64_t)a[0];
            if (I >= (uint64_t)store_size) break;
            storage[I] = a[1];
            break;
        }
        case 0x43: {  // RS
            uint64_t I = (uint64_t)a[0];
            a[0] = I >= (uint64_t)store_size ? 0 : storage[I];
            break;
        }
        case 0x44: {  // WCVTP
            uint64_t I = (uint64_t)a[0];
            if (I >= (uint64_t)cvt_size) break;
            cvt[I] = a[1];
            break;
        }
        case 0x45: {  // RCVT
            uint64_t I = (uint64_t)a[0];
            a[0] = I >= (uint64_t)cvt_size ? 0 : cvt[I];
            break;
        }
        case 0x46: case 0x47: {  // GC
            uint64_t L = (uint64_t)a[0];
            if (L >= (uint64_t)zp2.n_points) a[0] = 0;
            else a[0] = (op & 1) ? FAST_DUALPROJ(zp2.org[L]) : FAST_PROJECT(zp2.cur[L]);
            break;
        }
        case 0x48: {  // SCFS
            int L = (uint16_t)a[0];
            if (bounds(L, zp2.n_points)) break;
            Long K = FAST_PROJECT(zp2.cur[L]);
            move(zp2, L, a[1] - K);
            if (gs.gep2 == 0) zp2.org[L] = zp2.cur[L];
            break;
        }
        case 0x49: case 0x4A: {  // MD
            int K = (uint16_t)a[1], L = (uint16_t)a[0];
            Long D;
            if (bounds(L, zp0.n_points) || bounds(K, zp1.n_points)) D = 0;
            else if (op & 1) D = PROJECT(zp0.cur[L], zp1.cur[K]);
            else if (gs.gep0 == 0 || gs.gep1 == 0) D = DUALPROJ(zp0.org[L], zp1.org[K]);
            else if (x_scale == y_scale) D = mul_fix(DUALPROJ(zp0.orus[L], zp1.orus[K]), x_scale);
            else {
                Vec v;
                v.x = mul_fix(zp0.orus[L].x - zp1.orus[K].x, x_scale);
                v.y = mul_fix(zp0.orus[L].y - zp1.orus[K].y, y_scale);
                D = FAST_DUALPROJ(v);
            }
            a[0] = D;
            break;
        }
        case 0x4B: a[0] = ppem; break;        // MPPEM
        case 0x4C: a[0] = point_size; break;  // MPS (v40: the point size)
        case 0x4D: gs.auto_flip = true; break;
        case 0x4E: gs.auto_flip = false; break;
        case 0x4F: error = 1; break;          // DEBUG
        case 0x50: a[0] = a[0] < a[1]; break;
        case 0x51: a[0] = a[0] <= a[1]; break;
        case 0x52: a[0] = a[0] > a[1]; break;
        case 0x53: a[0] = a[0] >= a[1]; break;
        case 0x54: a[0] = a[0] == a[1]; break;
        case 0x55: a[0] = a[0] != a[1]; break;
        case 0x56: a[0] = (round(a[0]) & 127) == 64; break;
        case 0x57: a[0] = (round(a[0]) & 127) == 0; break;
        case 0x58: {  // IF
            if (a[0] != 0) break;
            int nifs = 1;
            bool out = false;
            do {
                if (!skip_code()) break;
                if (opcode == 0x58) nifs++;
                else if (opcode == 0x1B) out = nifs == 1;
                else if (opcode == 0x59) { nifs--; out = nifs == 0; }
            } while (!out);
            break;
        }
        case 0x59: break;  // EIF
        case 0x5A: a[0] = a[0] && a[1]; break;
        case 0x5B: a[0] = a[0] || a[1]; break;
        case 0x5C: a[0] = !a[0]; break;
        case 0x5D: case 0x71: case 0x72: ins_deltap(a); break;
        case 0x5E: gs.delta_base = (int)a[0]; break;
        case 0x5F:
            if ((uint64_t)a[0] > 6UL) error = 1;
            else gs.delta_shift = (int)a[0];
            break;
        case 0x60: a[0] += a[1]; break;
        case 0x61: a[0] -= a[1]; break;
        case 0x62:
            if (a[1] == 0) error = 1;
            else a[0] = mul_div_no_round(a[0], 64L, a[1]);
            break;
        case 0x63: a[0] = mul_div(a[0], a[1], 64L); break;
        case 0x64: a[0] = std::labs(a[0]); break;
        case 0x65: a[0] = -a[0]; break;
        case 0x66: a[0] = pix_floor(a[0]); break;
        case 0x67: a[0] = pix_ceil(a[0]); break;
        case 0x68: case 0x69: case 0x6A: case 0x6B: a[0] = round(a[0]); break;
        case 0x6C: case 0x6D: case 0x6E: case 0x6F: break;  // NROUND: no compensation
        case 0x70: {  // WCVTF
            uint64_t I = (uint64_t)a[0];
            if (I >= (uint64_t)cvt_size) break;
            cvt[I] = mul_fix(a[1], scale);
            break;
        }
        case 0x73: case 0x74: case 0x75: ins_deltac(a); break;
        case 0x76: set_super_round(0x4000, a[0]); gs.round_state = 6; break;
        case 0x77: set_super_round(0x2D41, a[0]); gs.round_state = 7; break;
        case 0x78:  // JROT
            if (a[1] != 0) { a[0] = a[0]; goto jmpr; }
            break;
        case 0x79:  // JROF
            if (a[1] == 0) goto jmpr;
            break;
        case 0x7A: gs.round_state = 5; break;  // ROFF
        case 0x7C: gs.round_state = 4; break;  // RUTG
        case 0x7D: gs.round_state = 3; break;  // RDTG
        case 0x7E: case 0x7F: break;           // SANGW, AA
        case 0x80: {  // FLIPPT
            if (post_iup()) { gs.loop = 1; new_top = args; break; }
            if (top < gs.loop) { gs.loop = 1; new_top = args; break; }
            while (gs.loop > 0) {
                args--;
                int point = (uint16_t)stack[args];
                if (!bounds(point, pts.n_points)) pts.tags[point] ^= 1;
                gs.loop--;
            }
            gs.loop = 1;
            new_top = args;
            break;
        }
        case 0x81: case 0x82: {  // FLIPRGON, FLIPRGOFF
            if (post_iup()) break;
            int K = (uint16_t)a[1], L = (uint16_t)a[0];
            if (bounds(K, pts.n_points) || bounds(L, pts.n_points)) break;
            for (int i = L; i <= K; i++) {
                if (op == 0x81) pts.tags[i] |= 1;
                else pts.tags[i] &= ~1;
            }
            break;
        }
        case 0x85: {  // SCANCTRL
            int A = (int)(a[0] & 0xFF);
            if (A == 0xFF) { gs.scan_control = true; break; }
            if (A == 0) { gs.scan_control = false; break; }
            if ((a[0] & 0x100) && ppem <= A) gs.scan_control = true;
            if ((a[0] & 0x800) && ppem > A) gs.scan_control = false;
            break;
        }
        case 0x86: case 0x87: {  // SDPVTL
            int p1 = (uint16_t)a[1], p2 = (uint16_t)a[0];
            if (bounds(p2, zp1.n_points) || bounds(p1, zp2.n_points)) break;
            int oc = op;
            Long A = zp1.org[p2].x - zp2.org[p1].x, B = zp1.org[p2].y - zp2.org[p1].y;
            if (A == 0 && B == 0) { A = 0x4000; oc = 0; }
            if (oc & 1) { Long C = B; B = A; A = -C; }
            normalize(A, B, gs.dual_x, gs.dual_y);
            A = zp1.cur[p2].x - zp2.cur[p1].x;
            B = zp1.cur[p2].y - zp2.cur[p1].y;
            if (A == 0 && B == 0) { A = 0x4000; oc = 0; }
            if (oc & 1) { Long C = B; B = A; A = -C; }
            normalize(A, B, gs.proj_x, gs.proj_y);
            compute_funcs();
            break;
        }
        case 0x88: {  // GETINFO
            Long K = 0, sel = a[0];
            if (sel & 1) K = 40;
            if ((sel & 32) && grayscale) K |= 1 << 12;
            if (subpixel_hinting_lean) {
                if (sel & 64) K |= 1 << 13;
                if (sel & 1024) K |= 1 << 17;
                if ((sel & 2048) && subpixel_hinting_lean) K |= 1 << 18;
                if ((sel & 4096) && grayscale_cleartype) K |= 1 << 19;
            }
            a[0] = K;
            break;
        }
        case 0x89: {  // IDEF
            if (ini_range == RANGE_GLYPH) { error = 1; break; }
            int idx = -1;
            for (int i = 0; i < num_idefs; i++) if (idefs[i].opc == (int)a[0]) { idx = i; break; }
            if (idx < 0) {
                if (num_idefs >= max_idefs) { error = 1; break; }
                idx = num_idefs++;
            }
            if ((uint64_t)a[0] > 0xFF) { error = 1; break; }
            Def& d = idefs[idx];
            d.opc = (int)a[0];
            d.start = IP + 1;
            d.range = cur_range;
            d.active = true;
            if ((int)a[0] > max_ins) max_ins = (int)a[0];
            while (skip_code()) {
                if (opcode == 0x89 || opcode == 0x2C) { error = 1; break; }
                if (opcode == 0x2D) { d.end = IP; break; }
            }
            break;
        }
        case 0x8A: { Long A = a[2]; a[2] = a[1]; a[1] = a[0]; a[0] = A; break; }  // ROLL
        case 0x8B: a[0] = std::max(a[0], a[1]); break;
        case 0x8C: a[0] = std::min(a[0], a[1]); break;
        case 0x8D: if (a[0] >= 0) gs.scan_type = (int)a[0] & 0xFFFF; break;
        case 0x8E: {  // INSTCTRL
            uint64_t K = (uint64_t)a[1], L = (uint64_t)a[0];
            if (K < 1 || K > 3) break;
            uint64_t Kf = 1ULL << (K - 1);
            if (L != 0 && L != Kf) break;
            if (ini_range == RANGE_CVT) {
                gs.instruct_control &= ~(uint8_t)Kf;
                gs.instruct_control |= (uint8_t)L;
            } else if (ini_range == RANGE_GLYPH && K == 3) {
                backward_compatibility = !(L == 4);
            }
            break;
        }
        default:
            if (op >= 0xB0 && op <= 0xB7) {
                int L = op - 0xAF;
                for (int k = 0; k < L; k++) a[k] = code[IP + 1 + k];
            } else if (op >= 0xB8 && op <= 0xBF) {
                int L = op - 0xB7;
                for (int k = 0; k < L; k++)
                    a[k] = (int16_t)((code[IP + 1 + 2 * k] << 8) | code[IP + 2 + 2 * k]);
            } else if (op >= 0xC0 && op <= 0xDF) {
                ins_mdrp(a);
            } else if (op >= 0xE0) {
                ins_mirp(a);
            } else {
                // an instruction defined by IDEF, else an invalid opcode
                Def* d = nullptr;
                for (int i = 0; i < num_idefs; i++) if (idefs[i].active && idefs[i].opc == op) d = &idefs[i];
                if (!d || call_top >= (int)calls.size()) return 1;
                CallRec& r = calls[call_top];
                r.caller_range = cur_range;
                r.caller_ip = IP + 1;
                r.cur_count = 1;
                r.def = d;
                call_top++;
                if (!goto_range(d->range, d->start)) return 1;
                goto suite;
            }
            break;
        }
        if (error) return error;
        top = new_top;
        if (step_ins) IP += length;
        if (++ins_counter > 1000000) return 1;
    suite:
        if (IP >= code_size) {
            if (call_top > 0) return 1;
            return 0;
        }
    } while (true);
}

// ------------------------------------------------------- glyph loading

bool glyph_location(const Face& f, int gid, size_t& off, size_t& len) {
    if (gid < 0 || gid >= f.num_glyphs) return false;
    uint32_t a, bnd;
    if (f.loca_long) { a = f.b.u32(f.loca + 4 * gid); bnd = f.b.u32(f.loca + 4 * gid + 4); }
    else { a = 2u * f.b.u16(f.loca + 2 * gid); bnd = 2u * f.b.u16(f.loca + 2 * gid + 2); }
    if (bnd < a) bnd = a;
    if (bnd > f.glyf_len) bnd = f.glyf_len;
    if (a > bnd) a = bnd;
    off = f.glyf + a;
    len = bnd - a;
    return true;
}

void reset_exec_for_run(Exec& e) {
    e.zp0 = e.zp1 = e.zp2 = e.pts;
    e.gs.gep0 = e.gs.gep1 = e.gs.gep2 = 1;
    e.gs.proj_x = 0x4000; e.gs.proj_y = 0;
    e.gs.free_x = e.gs.dual_x = 0x4000; e.gs.free_y = e.gs.dual_y = 0;
    e.gs.round_state = 1;
    e.gs.loop = 1;
    e.top = 0;
    e.call_top = 0;
}

// Hint one zone (simple glyph, or a composite with its own program).
int hint_zone(Face& f, ZoneStore& zs, const uint8_t* ins, int n_ins, bool composite) {
    Exec& e = f.exec;
    int np = (int)zs.org.size();  // includes the four phantom points
    if (n_ins > 0) zs.org = zs.cur;
    e.gs = f.size_gs;
    if (composite) {
        e.x_scale = e.y_scale = 1 << 16;
        zs.orus = zs.cur;
    } else {
        e.x_scale = f.x_scale;
        e.y_scale = f.y_scale;
    }
    zs.cur[np - 4].x = pix_round(zs.cur[np - 4].x);
    zs.cur[np - 3].x = pix_round(zs.cur[np - 3].x);
    zs.cur[np - 2].y = pix_round(zs.cur[np - 2].y);
    zs.cur[np - 1].y = pix_round(zs.cur[np - 1].y);
    if (n_ins > 0) {
        e.ranges[RANGE_GLYPH] = ins;
        e.range_size[RANGE_GLYPH] = n_ins;
        e.is_composite = composite;
        e.pts = zs.zone();
        e.goto_range(RANGE_GLYPH, 0);
        reset_exec_for_run(e);
        e.loopcall_counter = 0;
        e.neg_jump_counter = 0;
        e.run();  // errors are not fatal (non-pedantic hinting)
    }
    return 0;
}

// Load glyph ``gid`` into ``zs`` (outline points then its four phantom
// points), scaled to 26.6 and hinted if ``hinted``.
int Face::load_recursive(int gid, bool hinted, int depth, ZoneStore& zs, Vec pp[4],
                         bool& have_outline) {
    if (depth > 8) return 1;
    size_t off, len;
    if (!glyph_location(*this, gid, off, len)) return 1;
    int aw, lsb;
    hmetrics(gid, aw, lsb);
    // vertical metrics: FreeType synthesises them from the horizontal header
    int asc = b.s16(hhea + 4), desc = b.s16(hhea + 6);
    int top_bearing, adv_h;
    int16_t n_contours = len >= 10 ? b.s16(off) : 0;
    int xmin = len >= 10 ? b.s16(off + 2) : 0, ymax = len >= 10 ? b.s16(off + 8) : 0;
    adv_h = asc - desc;
    top_bearing = asc - ymax;
    if (os2 && b.u16(os2) != 0xFFFF) {
        int ta = b.s16(os2 + 68), td = b.s16(os2 + 70);
        adv_h = ta - td;
        top_bearing = ta - ymax;
    }
    Vec p1, p2, p3, p4;
    p1.x = xmin - lsb; p1.y = 0;
    p2.x = p1.x + aw; p2.y = 0;
    p3.x = 0; p3.y = ymax + top_bearing;
    p4.x = 0; p4.y = p3.y - adv_h;
    if (len == 0 || n_contours == 0) {
        pp[0].x = mul_fix(p1.x, x_scale); pp[0].y = 0;
        pp[1].x = mul_fix(p2.x, x_scale); pp[1].y = 0;
        pp[2].x = mul_fix(p3.x, x_scale); pp[2].y = mul_fix(p3.y, y_scale);
        pp[3].x = mul_fix(p4.x, x_scale); pp[3].y = mul_fix(p4.y, y_scale);
        return 0;
    }
    if (n_contours > 0) {
        size_t p = off + 10;
        std::vector<uint16_t> ends(n_contours);
        for (int i = 0; i < n_contours; i++) ends[i] = b.u16(p + 2 * i);
        p += 2 * n_contours;
        int npts = ends[n_contours - 1] + 1;
        int n_ins = b.u16(p);
        p += 2;
        const uint8_t* ins = data.data() + p;
        p += n_ins;
        std::vector<uint8_t> flags(npts);
        for (int i = 0; i < npts;) {
            uint8_t c = b.u8(p++);
            flags[i++] = c;
            if (c & 8) {
                int cnt = b.u8(p++);
                while (cnt-- > 0 && i < npts) flags[i++] = c;
            }
        }
        std::vector<Long> xs(npts), ys(npts);
        Long x = 0;
        for (int i = 0; i < npts; i++) {
            uint8_t c = flags[i];
            if (c & 2) { int d = b.u8(p++); x += (c & 16) ? d : -d; }
            else if (!(c & 16)) { x += b.s16(p); p += 2; }
            xs[i] = x;
        }
        Long y = 0;
        for (int i = 0; i < npts; i++) {
            uint8_t c = flags[i];
            if (c & 4) { int d = b.u8(p++); y += (c & 32) ? d : -d; }
            else if (!(c & 32)) { y += b.s16(p); p += 2; }
            ys[i] = y;
        }
        ZoneStore z;
        int total = npts + 4;
        z.cur.resize(total);
        z.tags.assign(total, 0);
        for (int i = 0; i < npts; i++) {
            z.cur[i].x = xs[i];
            z.cur[i].y = ys[i];
            z.tags[i] = flags[i] & 1;
        }
        z.cur[npts] = p1; z.cur[npts + 1] = p2; z.cur[npts + 2] = p3; z.cur[npts + 3] = p4;
        z.contours = ends;
        if (hinted) z.orus = z.cur;
        for (int i = 0; i < total; i++) {
            z.cur[i].x = mul_fix(z.cur[i].x, x_scale);
            z.cur[i].y = mul_fix(z.cur[i].y, y_scale);
        }
        for (int k = 0; k < 4; k++) pp[k] = z.cur[npts + k];
        z.org = z.cur;
        if (!hinted) z.orus = z.cur;
        if (hinted) {
            hint_zone(*this, z, ins, n_ins, false);
            if (!exec.backward_compatibility)
                for (int k = 0; k < 4; k++) pp[k] = z.cur[npts + k];
        }
        // append the outline (without phantoms) to zs
        int base = (int)zs.cur.size();
        for (int i = 0; i < npts; i++) {
            zs.cur.push_back(z.cur[i]);
            zs.tags.push_back(z.tags[i]);
        }
        for (int i = 0; i < n_contours; i++) zs.contours.push_back((uint16_t)(ends[i] + base));
        have_outline = true;
        return 0;
    }
    // composite glyph
    Vec cpp[4];
    cpp[0].x = mul_fix(p1.x, x_scale); cpp[0].y = 0;
    cpp[1].x = mul_fix(p2.x, x_scale); cpp[1].y = 0;
    cpp[2].x = mul_fix(p3.x, x_scale); cpp[2].y = mul_fix(p3.y, y_scale);
    cpp[3].x = mul_fix(p4.x, x_scale); cpp[3].y = mul_fix(p4.y, y_scale);
    for (int k = 0; k < 4; k++) pp[k] = cpp[k];
    size_t p = off + 10;
    int start_point = (int)zs.cur.size();
    int start_contour = (int)zs.contours.size();
    bool we_have_instr = false;
    size_t ins_pos = 0;
    while (true) {
        int flags = b.u16(p), gi = b.u16(p + 2);
        p += 4;
        Long arg1, arg2;
        if (flags & 1) { arg1 = b.s16(p); arg2 = b.s16(p + 2); p += 4; }
        else if (flags & 2) { arg1 = (int8_t)b.u8(p); arg2 = (int8_t)b.u8(p + 1); p += 2; }
        else { arg1 = b.u8(p); arg2 = b.u8(p + 1); p += 2; }
        Long xx = 0x10000, xy = 0, yx = 0, yy = 0x10000;
        bool have_scale = false;
        if (flags & 8) { xx = yy = (Long)b.s16(p) * 4; p += 2; have_scale = true; }
        else if (flags & 0x40) { xx = (Long)b.s16(p) * 4; yy = (Long)b.s16(p + 2) * 4; p += 4; have_scale = true; }
        else if (flags & 0x80) {
            xx = (Long)b.s16(p) * 4; yx = (Long)b.s16(p + 2) * 4;
            xy = (Long)b.s16(p + 4) * 4; yy = (Long)b.s16(p + 6) * 4;
            p += 8; have_scale = true;
        }
        int num_base = (int)zs.cur.size();
        Vec sub_pp[4];
        bool sub_out = false;
        int err = load_recursive(gi, hinted, depth + 1, zs, sub_pp, sub_out);
        if (err) return err;
        if (flags & 0x200) for (int k = 0; k < 4; k++) pp[k] = sub_pp[k];  // USE_MY_METRICS
        int n_new = (int)zs.cur.size() - num_base;
        if (have_scale)
            for (int i = num_base; i < num_base + n_new; i++) {
                Vec v = zs.cur[i];
                zs.cur[i].x = mul_fix(v.x, xx) + mul_fix(v.y, xy);
                zs.cur[i].y = mul_fix(v.x, yx) + mul_fix(v.y, yy);
            }
        Long dx, dy;
        if (!(flags & 2)) {  // point matching
            int k = (int)arg1, l = (int)arg2;
            int ki = start_point + k, li = num_base + l;
            if (ki >= num_base || li >= (int)zs.cur.size()) return 1;
            dx = zs.cur[ki].x - zs.cur[li].x;
            dy = zs.cur[ki].y - zs.cur[li].y;
        } else {
            dx = arg1; dy = arg2;
            if (dx || dy) {
                if (have_scale && (flags & 0x800)) {  // SCALED_COMPONENT_OFFSET
                    Long mx = mul_fix(dx, xx) + mul_fix(dy, xy);
                    Long my = mul_fix(dx, yx) + mul_fix(dy, yy);
                    dx = mx; dy = my;
                }
                dx = mul_fix(dx, x_scale);
                dy = mul_fix(dy, y_scale);
                if ((flags & 4) && hinted) dy = pix_round(dy);  // ROUND_XY_TO_GRID (v40: y only)
            }
        }
        if (dx || dy)
            for (int i = num_base; i < num_base + n_new; i++) { zs.cur[i].x += dx; zs.cur[i].y += dy; }
        if (flags & 0x100) { we_have_instr = true; }
        if (!(flags & 0x20)) break;  // MORE_COMPONENTS
    }
    if (we_have_instr) ins_pos = p;
    have_outline = (int)zs.cur.size() > start_point;
    if (hinted && we_have_instr && (int)zs.cur.size() > start_point) {
        int n_ins = b.u16(ins_pos);
        const uint8_t* ins = data.data() + ins_pos + 2;
        ZoneStore z;
        int npts = (int)zs.cur.size() - start_point;
        z.cur.assign(zs.cur.begin() + start_point, zs.cur.end());
        z.tags.assign(zs.tags.begin() + start_point, zs.tags.end());
        for (int i = start_contour; i < (int)zs.contours.size(); i++)
            z.contours.push_back((uint16_t)(zs.contours[i] - start_point));
        for (int k = 0; k < 4; k++) z.cur.push_back(pp[k]), z.tags.push_back(0);
        for (auto& t : z.tags) t &= ~TOUCH_BOTH;
        z.org = z.cur;
        z.orus = z.cur;
        hint_zone(*this, z, ins, n_ins, true);
        if (!exec.backward_compatibility)
            for (int k = 0; k < 4; k++) pp[k] = z.cur[npts + k];
        for (int i = 0; i < npts; i++) {
            zs.cur[start_point + i] = z.cur[i];
            zs.tags[start_point + i] = z.tags[i];
        }
    }
    return 0;
}

int autohint_glyph(Face& f, int gid, Glyph& out);

int Face::load_glyph(int gid, bool hinted, Glyph& out) {
    if (hinted && autohinted()) return autohint_glyph(*this, gid, out);
    if (hinted && hinting_disabled) hinted = false;
    if (hinted) {
        exec.backward_compatibility = !(size_gs.instruct_control & 4);
    }
    ZoneStore zs;
    Vec pp[4];
    bool have = false;
    int err = load_recursive(gid, hinted, 0, zs, pp, have);
    if (err) return err;
    out.pts = zs.cur;
    out.tags.resize(zs.tags.size());
    for (size_t i = 0; i < zs.tags.size(); i++) out.tags[i] = zs.tags[i] & 1;
    out.ends = zs.contours;
    if (pp[0].x)
        for (auto& v : out.pts) v.x -= pp[0].x;
    Long adv = pp[1].x - pp[0].x;
    out.advance = hinted ? pix_round(adv) : adv;
    int aw, lsb;
    hmetrics(gid, aw, lsb);
    out.linear = aw;
    return 0;
}

bool Face::set_size(int size) {
    ppem = size;
    x_scale = y_scale = div_fix((Long)size << 6, upem);
    size_ascender = pix_ceil(mul_fix(ascender, y_scale));
    size_descender = pix_floor(mul_fix(descender, y_scale));
    // the execution context
    Exec& e = exec;
    e.stack.assign((size_t)max_stack + 32, 0);
    e.calls.assign(32, CallRec());
    e.fdefs.assign((size_t)max_fdefs, Def());
    e.idefs.assign((size_t)max_idefs, Def());
    e.max_fdefs = max_fdefs;
    e.max_idefs = max_idefs;
    e.num_fdefs = e.num_idefs = 0;
    e.max_func = 0;
    e.max_ins = 0;
    e.ranges[RANGE_FONT] = fpgm ? data.data() + fpgm : nullptr;
    e.range_size[RANGE_FONT] = fpgm ? fpgm_len : 0;
    e.ranges[RANGE_CVT] = prep ? data.data() + prep : nullptr;
    e.range_size[RANGE_CVT] = prep ? prep_len : 0;
    storage.assign((size_t)max_storage, 0);
    e.storage = storage.data();
    e.store_size = max_storage;
    int ntw = max_twilight + 4;
    twilight.org.assign(ntw, Vec());
    twilight.cur.assign(ntw, Vec());
    twilight.orus.assign(ntw, Vec());
    twilight.tags.assign(ntw, 0);
    twilight.contours.clear();
    e.twilight = twilight.zone();
    e.loopcall_counter_max = 100 * 1000;
    e.neg_jump_counter_max = 100 * 1000;
    e.grayscale = false;
    e.subpixel_hinting_lean = true;
    e.grayscale_cleartype = true;
    // fpgm, with no scale
    e.gs = GS();
    e.ppem = 0;
    e.scale = 0;
    e.point_size = (Long)size * 64;
    e.period = 64; e.phase = 0; e.threshold = 0;
    e.F_dot_P = 0x4000;
    e.cvt = nullptr;
    e.cvt_size = 0;
    fpgm_error = 0;
    if (fpgm && fpgm_len > 0) {
        e.top = 0; e.call_top = 0;
        e.pts = Zone();
        e.zp0 = e.zp1 = e.zp2 = e.pts;
        e.goto_range(RANGE_FONT, 0);
        fpgm_error = e.run();
    }
    // prep
    cvt.assign(cvt_units.size(), 0);
    Long sc = x_scale;
    for (size_t i = 0; i < cvt_units.size(); i++) cvt[i] = mul_fix(cvt_units[i] * 64 / 64, sc);
    e.cvt = cvt.data();
    e.cvt_size = (Long)cvt.size();
    e.ppem = size;
    e.scale = x_scale;
    e.x_scale = x_scale;
    e.y_scale = y_scale;
    e.gs = GS();
    prep_error = 0;
    if (prep && prep_len > 0 && !fpgm_error) {
        e.top = 0; e.call_top = 0;
        e.pts = Zone();
        e.zp0 = e.zp1 = e.zp2 = e.pts;
        e.goto_range(RANGE_CVT, 0);
        prep_error = e.run();
    }
    GS g = e.gs;
    g.dual_x = g.proj_x = g.free_x = 0x4000;
    g.dual_y = g.proj_y = g.free_y = 0;
    g.rp0 = g.rp1 = g.rp2 = 0;
    g.gep0 = g.gep1 = g.gep2 = 1;
    g.loop = 1;
    size_gs = g;
    hinting_disabled = (g.instruct_control & 1) != 0 || fpgm_error != 0;
    bytecode_ready = true;
    return true;
}

// ------------------------------------------------------- the auto-hinter
//
// FreeType 2.14.1's autofit module as FT_Load_Glyph runs it on a face
// without a font program, in the normal render mode: the Latin writing
// system's style metrics (standard widths, blue zones, the x-height
// scale), its segments, edges and stem fitting, the point alignment, and
// the loader's hinted metrics (afhints.c, aflatin.c, afloader.c). Glyphs
// outside the Latin ranges take the fallback style, which only scales.

namespace af {

inline Long ab(Long x) { return x < 0 ? -x : x; }

int direction(Long dx, Long dy) {  // af_direction_compute
    Long ll, ss;
    int dir;
    if (dy >= dx) {
        if (dy >= -dx) { dir = DIR_UP; ll = dy; ss = dx; }
        else { dir = DIR_LEFT; ll = -dx; ss = dy; }
    } else {
        if (dy >= -dx) { dir = DIR_RIGHT; ll = dx; ss = dy; }
        else { dir = DIR_DOWN; ll = -dy; ss = dx; }
    }
    if (ll <= 14 * ab(ss)) dir = DIR_NONE;
    return dir;
}

Long hypot_(Long x, Long y) {  // FT_HYPOT
    x = ab(x); y = ab(y);
    return x > y ? x + ((3 * y) >> 3) : y + ((3 * x) >> 3);
}

bool corner_is_flat(Long in_x, Long in_y, Long out_x, Long out_y) {  // ft_corner_is_flat
    Long ax = in_x + out_x, ay = in_y + out_y;
    Long d_in = hypot_(in_x, in_y), d_out = hypot_(out_x, out_y), d_hypot = hypot_(ax, ay);
    return (d_in + d_out - d_hypot) < (d_hypot >> 4);
}

// FT_Outline_Get_Orientation: → true for a PostScript (counter-clockwise) outline.
bool postscript_orientation(const std::vector<Vec>& pts, const std::vector<uint16_t>& ends) {
    if (pts.empty()) return false;
    Long x0 = pts[0].x, x1 = x0, y0 = pts[0].y, y1 = y0;
    for (auto& v : pts) { x0 = std::min(x0, v.x); x1 = std::max(x1, v.x); y0 = std::min(y0, v.y); y1 = std::max(y1, v.y); }
    if (x0 == x1 || y0 == y1) return false;
    int xs = msb32((uint32_t)(ab(x1) | ab(x0))) - 14;
    if (xs < 0) xs = 0;
    int ys = msb32((uint32_t)(y1 - y0)) - 14;
    if (ys < 0) ys = 0;
    Long area = 0;
    int first = 0;
    for (size_t c = 0; c < ends.size(); c++) {
        int last = ends[c];
        Long px = pts[last].x >> xs, py = pts[last].y >> ys;
        for (int n = first; n <= last; n++) {
            Long cx = pts[n].x >> xs, cy = pts[n].y >> ys;
            area += (cy - py) * (cx + px);
            px = cx; py = cy;
        }
        first = last + 1;
    }
    return area > 0;
}

// af_glyph_hints_reload: the points in font units and scaled, their
// directions, and the weak points.
void reload(Hints& h, const std::vector<Vec>& vec, const std::vector<uint8_t>& tags,
            const std::vector<uint16_t>& ends) {
    for (int d = 0; d < 2; d++) { h.axis[d].segments.clear(); h.axis[d].edges.clear(); }
    h.axis[0].major_dir = DIR_UP;
    h.axis[1].major_dir = DIR_LEFT;
    if (postscript_orientation(vec, ends)) {
        h.axis[0].major_dir = DIR_DOWN;
        h.axis[1].major_dir = DIR_RIGHT;
    }
    int n = (int)vec.size();
    h.pts.assign(n, Point());
    h.contours.clear();
    if (n == 0 || ends.empty()) return;
    int near_limit = 20 * h.upem / 2048;
    {
        size_t ci = 0;
        int endpoint = ends[0], end = endpoint, prev = end;
        for (int i = 0; i < n; i++) {
            Point& p = h.pts[i];
            p.in_dir = p.out_dir = DIR_NONE;
            p.fx = (int16_t)vec[i].x;
            p.fy = (int16_t)vec[i].y;
            p.ox = p.x = mul_fix(vec[i].x, h.x_scale) + h.x_delta;
            p.oy = p.y = mul_fix(vec[i].y, h.y_scale) + h.y_delta;
            h.pts[end].fx = (int16_t)vec[endpoint].x;
            h.pts[end].fy = (int16_t)vec[endpoint].y;
            p.flags = (tags[i] & 1) ? 0 : FL_CONIC;
            Long ox = p.fx - h.pts[prev].fx, oy = p.fy - h.pts[prev].fy;
            if (ab(ox) + ab(oy) < near_limit) h.pts[prev].flags |= FL_NEAR;
            p.prev = prev;
            h.pts[prev].next = i;
            prev = i;
            if (i == end && ++ci < ends.size()) {
                endpoint = ends[ci];
                end = endpoint;
                prev = end;
            }
        }
    }
    {
        int idx = 0;
        for (size_t c = 0; c < ends.size(); c++) { h.contours.push_back(idx); idx = ends[c] + 1; }
    }
    std::vector<Point>& P = h.pts;
    int near_limit2 = 2 * near_limit - 1;
    for (size_t c = 0; c < h.contours.size(); c++) {
        int first = h.contours[c];
        int point = first, prev = P[first].prev;
        while (prev != first) {
            Long ox = P[point].fx - P[prev].fx, oy = P[point].fy - P[prev].fy;
            if (ab(ox) + ab(oy) >= near_limit2) break;
            point = prev;
            prev = P[prev].prev;
        }
        first = point;
        int curr = first;
        P[curr].u = first - curr;
        P[first].v = -P[curr].u;
        Long ox = 0, oy = 0;
        int next = first;
        do {
            point = next;
            next = P[point].next;
            ox += P[next].fx - P[point].fx;
            oy += P[next].fy - P[point].fy;
            if (ab(ox) + ab(oy) < near_limit) {
                P[next].flags |= FL_WEAK;
                continue;
            }
            P[curr].u = next - curr;
            P[next].v = -P[curr].u;
            int od = direction(ox, oy);
            P[curr].out_dir = od;
            for (curr = P[curr].next; curr != next; curr = P[curr].next) {
                P[curr].in_dir = od;
                P[curr].out_dir = od;
            }
            P[next].in_dir = od;
            P[curr].u = first - curr;
            P[first].v = -P[curr].u;
            ox = 0;
            oy = 0;
        } while (next != first);
    }
    for (int i = 0; i < n; i++) {
        Point& p = P[i];
        if (p.flags & FL_WEAK) continue;
        if (p.in_dir == DIR_NONE && p.out_dir == DIR_NONE) {
            int nu = i + (int)p.u, pv = i + (int)p.v;
            Long in_x = p.fx - P[pv].fx, in_y = p.fy - P[pv].fy;
            Long out_x = P[nu].fx - p.fx, out_y = P[nu].fy - p.fy;
            if ((in_x ^ out_x) >= 0 && (in_y ^ out_y) >= 0) {
                p.flags |= FL_WEAK;
                P[pv].u = nu - pv;
                P[nu].v = -P[pv].u;
            }
        }
    }
    for (int i = 0; i < n; i++) {
        Point& p = P[i];
        if (p.flags & FL_WEAK) continue;
        if (p.flags & FL_CONTROL) {
            p.flags |= FL_WEAK;
        } else if (p.out_dir == p.in_dir) {
            if (p.out_dir != DIR_NONE) {
                p.flags |= FL_WEAK;
                continue;
            }
            int nu = i + (int)p.u, pv = i + (int)p.v;
            if (corner_is_flat(p.fx - P[pv].fx, p.fy - P[pv].fy, P[nu].fx - p.fx, P[nu].fy - p.fy)) {
                P[pv].u = nu - pv;
                P[nu].v = -P[pv].u;
                p.flags |= FL_WEAK;
            }
        } else if (p.in_dir == -p.out_dir) {
            p.flags |= FL_WEAK;
        }
    }
}

// af_latin_hints_compute_segments
void compute_segments(Hints& h, int dim) {
    AxisHints& ax = h.axis[dim];
    std::vector<Point>& P = h.pts;
    Long flat_threshold = 33 * h.upem / 2048;
    int major_dir = std::abs(ax.major_dir), segment_dir = major_dir;
    ax.segments.clear();
    for (auto& p : P) {
        if (dim == 0) { p.u = p.fx; p.v = p.fy; }
        else { p.u = p.fy; p.v = p.fx; }
    }
    for (size_t c = 0; c < h.contours.size(); c++) {
        int point = h.contours[c];
        int last = P[point].prev;
        bool on_edge = false;
        Long min_pos = 32000, max_pos = -32000, min_coord = 32000, max_coord = -32000;
        int min_flags = 0, max_flags = 0;
        Long min_on_coord = 32000, max_on_coord = -32000;
        int seg = -1, prev_seg = -1;
        Long prev_min_pos = min_pos, prev_max_pos = max_pos, prev_min_coord = min_coord,
             prev_max_coord = max_coord, prev_min_on_coord = min_on_coord,
             prev_max_on_coord = max_on_coord;
        int prev_min_flags = min_flags, prev_max_flags = max_flags;
        if (std::abs(P[last].out_dir) == major_dir && std::abs(P[point].out_dir) == major_dir) {
            last = point;
            for (;;) {
                point = P[point].prev;
                if (std::abs(P[point].out_dir) != major_dir) { point = P[point].next; break; }
                if (point == last) break;
            }
        }
        last = point;
        bool passed = false;
        for (;;) {
            if (on_edge) {
                Long u = P[point].u;
                if (u < min_pos) min_pos = u;
                if (u > max_pos) max_pos = u;
                Long v = P[point].v;
                if (v < min_coord) { min_coord = v; min_flags = P[point].flags; }
                if (v > max_coord) { max_coord = v; max_flags = P[point].flags; }
                if (!(P[point].flags & FL_CONTROL)) {
                    if (v < min_on_coord) min_on_coord = v;
                    if (v > max_on_coord) max_on_coord = v;
                }
                if (P[point].out_dir != segment_dir || point == last) {
                    Segment& S = ax.segments[seg];
                    if (prev_seg < 0 || S.first != ax.segments[prev_seg].last) {
                        S.last = point;
                        S.pos = (int16_t)((min_pos + max_pos) >> 1);
                        S.delta = (int16_t)((max_pos - min_pos) >> 1);
                        if (((min_flags | max_flags) & FL_CONTROL) &&
                            (max_on_coord - min_on_coord) < flat_threshold)
                            S.flags |= ED_ROUND;
                        S.min_coord = (int16_t)min_coord;
                        S.max_coord = (int16_t)max_coord;
                        S.height = (int16_t)(S.max_coord - S.min_coord);
                        prev_seg = seg;
                        prev_min_pos = min_pos; prev_max_pos = max_pos;
                        prev_min_coord = min_coord; prev_max_coord = max_coord;
                        prev_min_flags = min_flags; prev_max_flags = max_flags;
                        prev_min_on_coord = min_on_coord; prev_max_on_coord = max_on_coord;
                    } else {
                        Segment& PS = ax.segments[prev_seg];
                        if (P[PS.last].in_dir == P[point].in_dir) {
                            Long u2 = P[point].u;
                            if (u2 < prev_min_pos) prev_min_pos = u2;
                            if (u2 > prev_max_pos) prev_max_pos = u2;
                            Long v2 = P[point].v;
                            if (v2 < prev_min_coord) { prev_min_coord = v2; prev_min_flags = P[point].flags; }
                            if (v2 > prev_max_coord) { prev_max_coord = v2; prev_max_flags = P[point].flags; }
                            if (!(P[point].flags & FL_CONTROL)) {
                                if (v2 < prev_min_on_coord) prev_min_on_coord = v2;
                                if (v2 > prev_max_on_coord) prev_max_on_coord = v2;
                            }
                            PS.last = point;
                            PS.pos = (int16_t)((prev_min_pos + prev_max_pos) >> 1);
                            PS.delta = (int16_t)((prev_max_pos - prev_min_pos) >> 1);
                            if (((prev_min_flags | prev_max_flags) & FL_CONTROL) &&
                                (prev_max_on_coord - prev_min_on_coord) < flat_threshold)
                                PS.flags |= ED_ROUND;
                            else
                                PS.flags &= ~ED_ROUND;
                            PS.min_coord = (int16_t)prev_min_coord;
                            PS.max_coord = (int16_t)prev_max_coord;
                            PS.height = (int16_t)(PS.max_coord - PS.min_coord);
                        } else if (ab(prev_max_coord - prev_min_coord) > ab(max_coord - min_coord)) {
                            if (min_pos < prev_min_pos) prev_min_pos = min_pos;
                            if (max_pos > prev_max_pos) prev_max_pos = max_pos;
                            PS.last = point;
                            PS.pos = (int16_t)((prev_min_pos + prev_max_pos) >> 1);
                            PS.delta = (int16_t)((prev_max_pos - prev_min_pos) >> 1);
                        } else {
                            if (prev_min_pos < min_pos) min_pos = prev_min_pos;
                            if (prev_max_pos > max_pos) max_pos = prev_max_pos;
                            S.last = point;
                            S.pos = (int16_t)((min_pos + max_pos) >> 1);
                            S.delta = (int16_t)((max_pos - min_pos) >> 1);
                            if (((min_flags | max_flags) & FL_CONTROL) &&
                                (max_on_coord - min_on_coord) < flat_threshold)
                                S.flags |= ED_ROUND;
                            S.min_coord = (int16_t)min_coord;
                            S.max_coord = (int16_t)max_coord;
                            S.height = (int16_t)(S.max_coord - S.min_coord);
                            PS = S;
                            prev_min_pos = min_pos; prev_max_pos = max_pos;
                            prev_min_coord = min_coord; prev_max_coord = max_coord;
                            prev_min_flags = min_flags; prev_max_flags = max_flags;
                            prev_min_on_coord = min_on_coord; prev_max_on_coord = max_on_coord;
                        }
                        ax.segments.pop_back();
                    }
                    on_edge = false;
                    seg = -1;
                }
            }
            if (point == last) {
                if (passed) break;
                passed = true;
            }
            if (!on_edge && (std::abs(P[point].out_dir) == major_dir || point == P[point].prev)) {
                if (ax.segments.size() > 1000) {
                    ax.segments.clear();
                    return;
                }
                segment_dir = P[point].out_dir;
                ax.segments.push_back(Segment());
                seg = (int)ax.segments.size() - 1;
                Segment& S = ax.segments[seg];
                S.dir = segment_dir;
                S.first = point;
                S.last = point;
                min_pos = max_pos = P[point].u;
                min_coord = max_coord = P[point].v;
                min_flags = max_flags = P[point].flags;
                if (P[point].flags & FL_CONTROL) { min_on_coord = 32000; max_on_coord = -32000; }
                else min_on_coord = max_on_coord = P[point].v;
                on_edge = true;
                if (point == P[point].prev) {
                    S.last = point;
                    S.pos = (int16_t)min_pos;
                    S.delta = 0;
                    S.min_coord = (int16_t)min_coord;
                    S.max_coord = (int16_t)max_coord;
                    S.height = 0;
                    on_edge = false;
                    seg = -1;
                }
            }
            point = P[point].next;
        }
    }
    for (auto& S : ax.segments) {
        const Point& first = P[S.first];
        const Point& last = P[S.last];
        Long fv = first.v, lv = last.v;
        if (fv < lv) {
            const Point& p = P[first.prev];
            if (p.v < fv) S.height = (int16_t)(S.height + ((fv - p.v) >> 1));
            const Point& q = P[last.next];
            if (q.v > lv) S.height = (int16_t)(S.height + ((q.v - lv) >> 1));
        } else {
            const Point& p = P[first.prev];
            if (p.v > fv) S.height = (int16_t)(S.height + ((p.v - fv) >> 1));
            const Point& q = P[last.next];
            if (q.v < lv) S.height = (int16_t)(S.height + ((lv - q.v) >> 1));
        }
    }
}

// af_latin_hints_link_segments; ``max_width`` is the largest standard width.
void link_segments(Hints& h, Long max_width, int dim) {
    AxisHints& ax = h.axis[dim];
    std::vector<Segment>& S = ax.segments;
    int ns = (int)S.size();
    Long len_threshold = 8 * (Long)h.upem / 2048;
    if (len_threshold == 0) len_threshold = 1;
    Long len_score = 6000 * (Long)h.upem / 2048;
    Long dist_score = 3000;
    for (int a = 0; a < ns; a++) {
        if (S[a].dir != ax.major_dir) continue;
        for (int b2 = 0; b2 < ns; b2++) {
            Long pos1 = S[a].pos, pos2 = S[b2].pos;
            if (S[a].dir + S[b2].dir == 0 && pos2 > pos1) {
                Long mn = S[a].min_coord, mx = S[a].max_coord;
                if (mn < S[b2].min_coord) mn = S[b2].min_coord;
                if (mx > S[b2].max_coord) mx = S[b2].max_coord;
                Long len = mx - mn;
                if (len >= len_threshold) {
                    Long dist = pos2 - pos1, dist_demerit;
                    if (max_width) {
                        Long delta = (dist << 10) / max_width - (1 << 10);
                        if (delta > 10000) dist_demerit = 32000;
                        else if (delta > 0) dist_demerit = delta * delta / dist_score;
                        else dist_demerit = 0;
                    } else {
                        dist_demerit = dist;
                    }
                    Long score = dist_demerit + len_score / len;
                    if (score < S[a].score) { S[a].score = score; S[a].link = b2; }
                    if (score < S[b2].score) { S[b2].score = score; S[b2].link = a; }
                }
            }
        }
    }
    for (int a = 0; a < ns; a++) {
        int b2 = S[a].link;
        if (b2 >= 0 && S[b2].link != a) {
            S[a].link = -1;
            S[a].serif = S[b2].link;
        }
    }
}

// af_latin_hints_compute_edges
void compute_edges(Hints& h, const Axis& laxis, int dim) {
    AxisHints& ax = h.axis[dim];
    std::vector<Segment>& S = ax.segments;
    std::vector<Edge>& E = ax.edges;
    E.clear();
    Long scale = dim == 0 ? h.x_scale : h.y_scale;
    Long segment_length_threshold = dim == 0 ? div_fix(64, h.y_scale) : 0;
    Long segment_width_threshold = div_fix(32, scale);
    Long edge_distance_threshold = mul_fix(laxis.edge_distance_threshold, scale);
    if (edge_distance_threshold > 64 / 4) edge_distance_threshold = 64 / 4;
    edge_distance_threshold = div_fix(edge_distance_threshold, scale);
    for (int s = 0; s < (int)S.size(); s++) {
        Segment& seg = S[s];
        if (seg.height < segment_length_threshold || seg.delta > segment_width_threshold ||
            seg.dir == DIR_NONE)
            continue;
        if (seg.serif >= 0 && 2 * seg.height < 3 * segment_length_threshold) continue;
        int found = -1;
        for (int e = 0; e < (int)E.size(); e++) {
            if (ab(seg.pos - E[e].fpos) < edge_distance_threshold && E[e].dir == seg.dir) {
                found = e;
                break;
            }
        }
        if (found < 0) {
            int idx = (int)E.size();
            E.push_back(Edge());
            while (idx > 0) {
                if (E[idx - 1].fpos < seg.pos) break;
                if (E[idx - 1].fpos == seg.pos && seg.dir == ax.major_dir) break;
                E[idx] = E[idx - 1];
                idx--;
            }
            Edge& edge = E[idx];
            edge = Edge();
            edge.first = s;
            edge.last = s;
            edge.dir = seg.dir;
            edge.fpos = seg.pos;
            edge.opos = mul_fix(seg.pos, scale);
            edge.pos = edge.opos;
            seg.edge_next = s;
        } else {
            seg.edge_next = E[found].first;
            S[E[found].last].edge_next = s;
            E[found].last = s;
        }
    }
    for (int s = 0; s < (int)S.size(); s++) {
        Segment& seg = S[s];
        if (seg.dir != DIR_NONE) continue;
        int found = -1;
        for (int e = 0; e < (int)E.size(); e++) {
            if (ab(seg.pos - E[e].fpos) < edge_distance_threshold) { found = e; break; }
        }
        if (found >= 0) {
            seg.edge_next = E[found].first;
            S[E[found].last].edge_next = s;
            E[found].last = s;
        }
    }
    for (int e = 0; e < (int)E.size(); e++) {
        int s = E[e].first;
        if (s >= 0) do {
            S[s].edge = e;
            s = S[s].edge_next;
        } while (s != E[e].first);
    }
    for (int e = 0; e < (int)E.size(); e++) {
        Edge& edge = E[e];
        int is_round = 0, is_straight = 0;
        int s = edge.first;
        do {
            Segment& seg = S[s];
            if (seg.flags & ED_ROUND) is_round++;
            else is_straight++;
            bool is_serif = seg.serif >= 0 && S[seg.serif].edge >= 0 && S[seg.serif].edge != e;
            if ((seg.link >= 0 && S[seg.link].edge >= 0) || is_serif) {
                int edge2 = edge.link;
                int seg2 = seg.link;
                if (is_serif) { seg2 = seg.serif; edge2 = edge.serif; }
                if (edge2 >= 0) {
                    Long edge_delta = ab(edge.fpos - E[edge2].fpos);
                    Long seg_delta = ab(seg.pos - S[seg2].pos);
                    if (seg_delta < edge_delta) edge2 = S[seg2].edge;
                } else {
                    edge2 = S[seg2].edge;
                }
                if (is_serif) {
                    edge.serif = edge2;
                    E[edge2].flags |= ED_SERIF;
                } else {
                    edge.link = edge2;
                }
            }
            s = seg.edge_next;
        } while (s != edge.first);
        edge.flags = 0;
        if (is_round > 0 && is_round >= is_straight) edge.flags |= ED_ROUND;
        if (edge.serif >= 0 && edge.link >= 0) edge.serif = -1;
    }
}

// af_latin_hints_compute_blue_edges
void compute_blue_edges(Hints& h, const Metrics& m) {
    AxisHints& ax = h.axis[1];
    const Axis& latin = m.axis[1];
    Long scale = latin.scale;
    for (auto& edge : ax.edges) {
        const Width* best_blue = nullptr;
        bool best_neutral = false;
        Long best_dist = mul_fix(m.upem / 40, scale);
        if (best_dist > 64 / 2) best_dist = 64 / 2;
        for (const Blue& blue : latin.blues) {
            if (!(blue.flags & BL_ACTIVE)) continue;
            bool is_top = (blue.flags & BL_TOP) != 0;
            bool is_neutral = (blue.flags & BL_NEUTRAL) != 0;
            bool is_major = edge.dir == ax.major_dir;
            if ((is_top ^ is_major) || is_neutral) {
                Long dist = mul_fix(ab(edge.fpos - blue.ref.org), scale);
                if (dist < best_dist) {
                    best_dist = dist;
                    best_blue = &blue.ref;
                    best_neutral = is_neutral;
                    // a round edge beyond the reference may take the overshoot
                    if ((edge.flags & ED_ROUND) && dist != 0 && !is_neutral) {
                        bool is_under_ref = edge.fpos < blue.ref.org;
                        if (is_top ^ is_under_ref) {
                            dist = mul_fix(ab(edge.fpos - blue.shoot.org), scale);
                            if (dist < best_dist) { best_dist = dist; best_blue = &blue.shoot; }
                        }
                    }
                }
            }
        }
        if (best_blue) {
            edge.blue_edge = best_blue;
            if (best_neutral) edge.flags |= ED_NEUTRAL;
        }
    }
}

// af_latin_compute_stem_width in the smooth (normal) mode
Long stem_width(const Metrics& m, int dim, int ppem, Long width, Long base_delta, int base_flags,
                int stem_flags) {
    const Axis& axis = m.axis[dim];
    Long dist = width;
    bool sign = false, vertical = dim == 1;
    if (axis.extra_light) return width;
    if (dist < 0) { dist = -width; sign = true; }
    if ((stem_flags & ED_SERIF) && vertical && dist < 3 * 64) {
        // leave the widths of serifs alone
    } else {
        if (base_flags & ED_ROUND) {
            if (dist < 80) dist = 64;
        } else if (dist < 56) {
            dist = 56;
        }
        if (!axis.widths.empty()) {
            Long delta = ab(dist - axis.widths[0].cur);
            if (delta < 40) {
                dist = axis.widths[0].cur;
                if (dist < 48) dist = 48;
            } else if (dist < 3 * 64) {
                delta = dist & 63;
                dist &= -64;
                if (delta < 10) dist += delta;
                else if (delta < 32) dist += 10;
                else if (delta < 54) dist += 54;
                else dist += delta;
            } else {
                Long bdelta = 0;
                if ((width > 0 && base_delta > 0) || (width < 0 && base_delta < 0)) {
                    if (ppem < 10) bdelta = base_delta;
                    else if (ppem < 30) bdelta = (base_delta * (Long)(30 - ppem)) / 20;
                    if (bdelta < 0) bdelta = -bdelta;
                }
                dist = (dist - bdelta + 32) & ~63;
            }
        }
    }
    return sign ? -dist : dist;
}

void align_linked_edge(const Metrics& m, int dim, int ppem, Edge& base, Edge& stem) {
    Long dist = stem.opos - base.opos;
    Long base_delta = base.pos - base.opos;
    stem.pos = base.pos + stem_width(m, dim, ppem, dist, base_delta, base.flags, stem.flags);
}

// af_latin_hint_edges
void hint_edges(Hints& h, const Metrics& m, int dim, int ppem) {
    std::vector<Edge>& E = h.axis[dim].edges;
    int n = (int)E.size();
    int anchor = -1, has_serifs = 0;
    if (dim == 1) {
        for (int e = 0; e < n; e++) {
            Edge& edge = E[e];
            if (edge.flags & ED_DONE) continue;
            int e1 = -1, e2 = edge.link;
            if (edge.blue_edge && e2 >= 0 && E[e2].blue_edge) {
                if (E[e2].flags & ED_NEUTRAL) { E[e2].blue_edge = nullptr; E[e2].flags &= ~ED_NEUTRAL; }
                else if (edge.flags & ED_NEUTRAL) { edge.blue_edge = nullptr; edge.flags &= ~ED_NEUTRAL; }
            }
            const Width* blue = edge.blue_edge;
            if (blue) e1 = e;
            else if (e2 >= 0 && E[e2].blue_edge) { blue = E[e2].blue_edge; e1 = e2; e2 = e; }
            if (e1 < 0) continue;
            E[e1].pos = blue->fit;
            E[e1].flags |= ED_DONE;
            if (e2 >= 0 && !E[e2].blue_edge) {
                align_linked_edge(m, dim, ppem, E[e1], E[e2]);
                E[e2].flags |= ED_DONE;
            }
            if (anchor < 0) anchor = e;
        }
    }
    for (int e = 0; e < n; e++) {
        Edge& edge = E[e];
        if (edge.flags & ED_DONE) continue;
        int e2 = edge.link;
        if (e2 < 0) { has_serifs++; continue; }
        Edge& edge2 = E[e2];
        if (edge2.blue_edge) {
            align_linked_edge(m, dim, ppem, edge2, edge);
            edge.flags |= ED_DONE;
            continue;
        }
        if (anchor < 0) {
            Long org_len = edge2.opos - edge.opos;
            Long cur_len = stem_width(m, dim, ppem, org_len, 0, edge.flags, edge2.flags);
            Long u_off, d_off;
            if (cur_len <= 64) { u_off = 32; d_off = 32; }
            else { u_off = 38; d_off = 26; }
            if (cur_len < 96) {
                Long org_center = edge.opos + (org_len >> 1);
                Long cur_pos1 = pix_round(org_center);
                Long error1 = ab(org_center - (cur_pos1 - u_off));
                Long error2 = ab(org_center - (cur_pos1 + d_off));
                if (error1 < error2) cur_pos1 -= u_off;
                else cur_pos1 += d_off;
                edge.pos = cur_pos1 - cur_len / 2;
                edge2.pos = edge.pos + cur_len;
            } else {
                edge.pos = pix_round(edge.opos);
            }
            anchor = e;
            edge.flags |= ED_DONE;
            align_linked_edge(m, dim, ppem, edge, edge2);
        } else {
            Long org_pos = E[anchor].pos + (edge.opos - E[anchor].opos);
            Long org_len = edge2.opos - edge.opos;
            Long org_center = org_pos + (org_len >> 1);
            Long cur_len = stem_width(m, dim, ppem, org_len, 0, edge.flags, edge2.flags);
            if (edge2.flags & ED_DONE) {
                edge.pos = edge2.pos - cur_len;
            } else if (cur_len < 96) {
                Long cur_pos1 = pix_round(org_center), u_off, d_off;
                if (cur_len <= 64) { u_off = 32; d_off = 32; }
                else { u_off = 38; d_off = 26; }
                Long delta1 = ab(org_center - (cur_pos1 - u_off));
                Long delta2 = ab(org_center - (cur_pos1 + d_off));
                if (delta1 < delta2) cur_pos1 -= u_off;
                else cur_pos1 += d_off;
                edge.pos = cur_pos1 - cur_len / 2;
                edge2.pos = cur_pos1 + cur_len / 2;
            } else {
                Long cur_pos1 = pix_round(org_pos);
                Long delta1 = ab(cur_pos1 + (cur_len >> 1) - org_center);
                Long cur_pos2 = pix_round(org_pos + org_len) - cur_len;
                Long delta2 = ab(cur_pos2 + (cur_len >> 1) - org_center);
                edge.pos = delta1 < delta2 ? cur_pos1 : cur_pos2;
                edge2.pos = edge.pos + cur_len;
            }
            edge.flags |= ED_DONE;
            edge2.flags |= ED_DONE;
            if (e > 0 && edge.pos < E[e - 1].pos) {
                if (edge.link >= 0 && ab(E[edge.link].pos - E[e - 1].pos) > 16)
                    edge.pos = E[e - 1].pos;
            }
        }
    }
    if (dim == 0 && (n == 6 || n == 12)) {
        int a1, a2, a3;
        if (n == 6) { a1 = 0; a2 = 2; a3 = 4; }
        else { a1 = 1; a2 = 5; a3 = 9; }
        Long dist1 = E[a2].opos - E[a1].opos, dist2 = E[a3].opos - E[a2].opos;
        if (ab(dist1 - dist2) < 8) {
            Long delta = E[a3].pos - (2 * E[a2].pos - E[a1].pos);
            E[a3].pos -= delta;
            if (E[a3].link >= 0) E[E[a3].link].pos -= delta;
            if (n == 12) { E[8].pos -= delta; E[11].pos -= delta; }
            E[a3].flags |= ED_DONE;
            if (E[a3].link >= 0) E[E[a3].link].flags |= ED_DONE;
        }
    }
    if (has_serifs || anchor < 0) {
        for (int e = 0; e < n; e++) {
            Edge& edge = E[e];
            if (edge.flags & ED_DONE) continue;
            // A serif within 1.5 px of a base that is not its neighbour in
            // the list stays where it is, as FreeType 2.14.1 leaves it (a
            // rule found by holding every glyph of the auto-hinted faces to
            // the library, not taken from its source).
            if (edge.serif >= 0 && std::abs(edge.serif - e) != 1 &&
                ab(E[edge.serif].opos - edge.opos) < 64 + 32) {
                edge.flags |= ED_DONE;
                continue;
            }
            Long delta = 1000;
            if (edge.serif >= 0) delta = ab(E[edge.serif].opos - edge.opos);
            if (delta < 64 + 16) {
                edge.pos = E[edge.serif].pos + (edge.opos - E[edge.serif].opos);
            } else if (anchor < 0) {
                edge.pos = pix_round(edge.opos);
                anchor = e;
            } else {
                int before = e - 1, after = e + 1;
                for (; before >= 0; before--) if (E[before].flags & ED_DONE) break;
                for (; after < n; after++) if (E[after].flags & ED_DONE) break;
                if (before >= 0 && after < n) {
                    if (E[after].opos == E[before].opos)
                        edge.pos = E[before].pos;
                    else
                        edge.pos = E[before].pos + mul_div(edge.opos - E[before].opos,
                                                           E[after].pos - E[before].pos,
                                                           E[after].opos - E[before].opos);
                } else {
                    edge.pos = E[anchor].pos + ((edge.opos - E[anchor].opos + 16) & ~31);
                }
            }
            edge.flags |= ED_DONE;
            if (e > 0 && edge.pos < E[e - 1].pos) {
                if (edge.link >= 0 && ab(E[edge.link].pos - E[e - 1].pos) > 16)
                    edge.pos = E[e - 1].pos;
            }
            if (e + 1 < n && (E[e + 1].flags & ED_DONE) && edge.pos > E[e + 1].pos) {
                // (FreeType compares with the edge before, as here)
                if (e > 0 && edge.link >= 0 && ab(E[edge.link].pos - E[e - 1].pos) > 16)
                    edge.pos = E[e + 1].pos;
            }
        }
    }
}

// af_glyph_hints_align_edge_points
void align_edge_points(Hints& h, int dim) {
    AxisHints& ax = h.axis[dim];
    for (auto& seg : ax.segments) {
        if (seg.edge < 0) continue;
        const Edge& edge = ax.edges[seg.edge];
        int point = seg.first;
        for (;;) {
            if (dim == 0) { h.pts[point].x = edge.pos; h.pts[point].flags |= FL_TOUCH_X; }
            else { h.pts[point].y = edge.pos; h.pts[point].flags |= FL_TOUCH_Y; }
            if (point == seg.last) break;
            point = h.pts[point].next;
        }
    }
}

// af_glyph_hints_align_strong_points
void align_strong_points(Hints& h, int dim) {
    std::vector<Edge>& E = h.axis[dim].edges;
    int ne = (int)E.size();
    int touch = dim == 0 ? FL_TOUCH_X : FL_TOUCH_Y;
    if (!ne) return;
    for (auto& p : h.pts) {
        if (p.flags & touch) continue;
        if (p.flags & FL_WEAK) continue;
        Long u = dim == 1 ? p.fy : p.fx, ou = dim == 1 ? p.oy : p.ox, fu = u;
        if (E[0].fpos - u >= 0) {
            u = E[0].pos - (E[0].opos - ou);
        } else if (u - E[ne - 1].fpos >= 0) {
            u = E[ne - 1].pos + (ou - E[ne - 1].opos);
        } else {
            int mn = 0, mx = ne;
            bool on_edge = false;
            if (mx <= 8) {
                int nn;
                for (nn = 0; nn < mx; nn++) if (E[nn].fpos >= u) break;
                if (E[nn].fpos == u) { u = E[nn].pos; on_edge = true; }
                mn = nn;
            } else {
                while (mn < mx) {
                    int mid = (mx + mn) >> 1;
                    Long fpos = E[mid].fpos;
                    if (u < fpos) mx = mid;
                    else if (u > fpos) mn = mid + 1;
                    else { u = E[mid].pos; on_edge = true; break; }
                }
            }
            if (!on_edge) {
                Edge& before = E[mn - 1];
                Edge& after = E[mn];
                if (before.scale == 0)
                    before.scale = div_fix(after.pos - before.pos, after.fpos - before.fpos);
                u = before.pos + mul_fix(fu - before.fpos, before.scale);
            }
        }
        if (dim == 0) p.x = u;
        else p.y = u;
        p.flags |= touch;
    }
}

void iup_shift(Hints& h, int p1, int p2, int ref) {
    Long delta = h.pts[ref].u - h.pts[ref].v;
    if (delta == 0) return;
    for (int p = p1; p < ref; p++) h.pts[p].u = h.pts[p].v + delta;
    for (int p = ref + 1; p <= p2; p++) h.pts[p].u = h.pts[p].v + delta;
}

void iup_interp(Hints& h, int p1, int p2, int ref1, int ref2) {
    if (p1 > p2) return;
    if (h.pts[ref1].v > h.pts[ref2].v) std::swap(ref1, ref2);
    Long v1 = h.pts[ref1].v, v2 = h.pts[ref2].v, u1 = h.pts[ref1].u, u2 = h.pts[ref2].u;
    Long d1 = u1 - v1, d2 = u2 - v2;
    if (u1 == u2 || v1 == v2) {
        for (int p = p1; p <= p2; p++) {
            Long u = h.pts[p].v;
            if (u <= v1) u += d1;
            else if (u >= v2) u += d2;
            else u = u1;
            h.pts[p].u = u;
        }
    } else {
        Long scale = div_fix(u2 - u1, v2 - v1);
        for (int p = p1; p <= p2; p++) {
            Long u = h.pts[p].v;
            if (u <= v1) u += d1;
            else if (u >= v2) u += d2;
            else u = u1 + mul_fix(u - v1, scale);
            h.pts[p].u = u;
        }
    }
}

// af_glyph_hints_align_weak_points
void align_weak_points(Hints& h, int dim) {
    int touch = dim == 0 ? FL_TOUCH_X : FL_TOUCH_Y;
    for (auto& p : h.pts) {
        if (dim == 0) { p.u = p.x; p.v = p.ox; }
        else { p.u = p.y; p.v = p.oy; }
    }
    for (size_t c = 0; c < h.contours.size(); c++) {
        int point = h.contours[c];
        int end_point = h.pts[point].prev;
        int first_point = point;
        for (;;) {
            if (point > end_point) goto NextContour;
            if (h.pts[point].flags & touch) break;
            point++;
        }
        {
            int first_touched = point, last_touched;
            for (;;) {
                while (point < end_point && (h.pts[point + 1].flags & touch)) point++;
                last_touched = point;
                point++;
                for (;;) {
                    if (point > end_point) goto EndContour;
                    if (h.pts[point].flags & touch) break;
                    point++;
                }
                iup_interp(h, last_touched + 1, point - 1, last_touched, point);
            }
        EndContour:
            if (last_touched == first_touched) {
                iup_shift(h, first_point, end_point, first_touched);
            } else {
                if (last_touched < end_point)
                    iup_interp(h, last_touched + 1, end_point, last_touched, first_touched);
                if (first_touched > 0)
                    iup_interp(h, first_point, first_touched - 1, last_touched, first_touched);
            }
        }
    NextContour:;
    }
    for (auto& p : h.pts) {
        if (dim == 0) p.x = p.u;
        else p.y = p.u;
    }
}

// The vertical separation of FreeType 2.14's adjustment database for a
// glyph whose top contour is a dot or an accent: after the vertical
// hinting, the top contour (the one whose lowest point is highest) is
// pushed up until one pixel separates it from the others.
void separate_top_contour(Hints& h) {
    int nc = (int)h.contours.size();
    if (nc < 2) return;
    std::vector<Long> lo(nc), hi(nc);
    for (int c = 0; c < nc; c++) {
        int first = h.contours[c], last = h.pts[first].prev;
        lo[c] = hi[c] = h.pts[first].y;
        for (int p = first; p <= last; p++) { lo[c] = std::min(lo[c], h.pts[p].y); hi[c] = std::max(hi[c], h.pts[p].y); }
    }
    int top = 0;
    for (int c = 1; c < nc; c++) if (lo[c] > lo[top]) top = c;
    Long others = LLONG_MIN;
    for (int c = 0; c < nc; c++) if (c != top) others = std::max(others, hi[c]);
    Long gap = lo[top] - others;
    if (gap >= 64) return;
    int first = h.contours[top], last = h.pts[first].prev;
    for (int p = first; p <= last; p++) h.pts[p].y += 64 - gap;
}

// af_sort_and_quantize_widths
void sort_and_quantize_widths(std::vector<Width>& t, Long threshold) {
    size_t count = t.size();
    if (count <= 1) return;
    for (size_t i = 1; i < count; i++)
        for (size_t j = i; j > 0; j--) {
            if (t[j].org >= t[j - 1].org) break;
            std::swap(t[j], t[j - 1]);
        }
    size_t cur_idx = 0;
    Long cur_val = t[cur_idx].org;
    for (size_t i = 1; i < count; i++) {
        if (t[i].org - cur_val > threshold || i == count - 1) {
            Long sum = 0;
            if (t[i].org - cur_val <= threshold && i == count - 1) i++;
            size_t j;
            for (j = cur_idx; j < i; j++) { sum += t[j].org; t[j].org = 0; }
            t[cur_idx].org = sum / (Long)j;
            if (i < count - 1) { cur_idx = i + 1; cur_val = t[cur_idx].org; }
        }
    }
    cur_idx = 1;
    for (size_t i = 1; i < count; i++)
        if (t[i].org) t[cur_idx++] = t[i];
    t.resize(cur_idx);
}

// The Unicode ranges of FreeType's Latin script (afranges.c), whose
// glyphs take the latn_dflt style.
const uint32_t LATIN_RANGES[][2] = {
    {0x0020, 0x007F}, {0x00A0, 0x00A9}, {0x00AB, 0x00B1}, {0x00B4, 0x00B8}, {0x00BB, 0x00FF},
    {0x0100, 0x017F}, {0x0180, 0x024F}, {0x0250, 0x02AF}, {0x02B9, 0x02DF}, {0x02E5, 0x02FF},
    {0x0300, 0x036F}, {0x1AB0, 0x1ABE}, {0x1D00, 0x1D2B}, {0x1D6B, 0x1D77}, {0x1D79, 0x1D7F},
    {0x1D80, 0x1D9A}, {0x1DC0, 0x1DFF}, {0x1E00, 0x1EFF}, {0x2000, 0x206F}, {0x20A0, 0x20B5},
    {0x20B9, 0x20BF}, {0x20D0, 0x20FF}, {0x2150, 0x218F}, {0x2C60, 0x2C7B}, {0x2C7E, 0x2C7F},
    {0x2E00, 0x2E7F}, {0xA720, 0xA76F}, {0xA771, 0xA7FF}, {0xAB30, 0xAB5B}, {0xAB60, 0xAB6F},
    {0xFB00, 0xFB06}, {0x1D400, 0x1D7FF}, {0x1F100, 0x1F1FF}};

// Its non-base characters (accents, modifiers), to which blue zones do not apply.
const uint32_t LATIN_NONBASE[][2] = {
    {0x005E, 0x0060}, {0x007E, 0x007E}, {0x00A8, 0x00A9}, {0x00AE, 0x00B0}, {0x00B4, 0x00B4},
    {0x00B8, 0x00B8}, {0x00BC, 0x00BE}, {0x02B9, 0x02DF}, {0x02E5, 0x02FF}, {0x0300, 0x036F},
    {0x1AB0, 0x1ABE}, {0x1DC0, 0x1DFF}, {0x2017, 0x2017}, {0x203E, 0x203E}, {0xA788, 0xA788},
    {0xA7F8, 0xA7FA}};

// The blue strings of the Latin style (afblue.dat) and their properties.
struct BlueString { const char* chars; int flags; };
const BlueString LATIN_BLUES[] = {
    {"THEZOCQS", BL_TOP},
    {"HEZLOCUS", 0},
    {"fijkdbh", BL_TOP},
    {"uvxzoesc", BL_TOP | BL_ADJUSTMENT},
    {"nrxzoesc", 0},
    {"pqgjy", 0},
};

}  // namespace af

int Face::load_unscaled(int gid, Glyph& out) {
    Long xs = x_scale, ys = y_scale;
    x_scale = y_scale = 0x10000;
    ZoneStore zs;
    Vec pp[4];
    bool have = false;
    int err = load_recursive(gid, false, 0, zs, pp, have);
    x_scale = xs;
    y_scale = ys;
    if (err) return err;
    out.pts = zs.cur;
    out.tags.resize(zs.tags.size());
    for (size_t i = 0; i < zs.tags.size(); i++) out.tags[i] = zs.tags[i] & 1;
    out.ends = zs.contours;
    if (pp[0].x)
        for (auto& v : out.pts) v.x -= pp[0].x;
    out.advance = pp[1].x - pp[0].x;
    int aw, lsb;
    hmetrics(gid, aw, lsb);
    out.linear = aw;
    return 0;
}

namespace af {

// af_latin_metrics_init_widths
void init_widths(Face& f, Metrics& m) {
    for (int d = 0; d < 2; d++) m.axis[d].widths.clear();
    int gid = 0;
    for (uint32_t c : {(uint32_t)'o', (uint32_t)'O', (uint32_t)'0'}) {
        gid = (int)f.char_index(c);
        if (gid) break;
    }
    Glyph g;
    if (gid && !f.load_unscaled(gid, g) && !g.pts.empty()) {
        Hints h;
        h.upem = m.upem;
        reload(h, g.pts, g.tags, g.ends);
        for (int d = 0; d < 2; d++) {
            compute_segments(h, d);
            link_segments(h, 0, d);
            std::vector<Segment>& S = h.axis[d].segments;
            for (int s = 0; s < (int)S.size(); s++) {
                int l = S[s].link;
                if (l >= 0 && S[l].link == s && l > s) {
                    Width w;
                    w.org = ab(S[s].pos - S[l].pos);
                    if (m.axis[d].widths.size() < 16) m.axis[d].widths.push_back(w);
                }
            }
            sort_and_quantize_widths(m.axis[d].widths, m.upem / 100);
        }
    }
    for (int d = 0; d < 2; d++) {
        Axis& a = m.axis[d];
        Long stdw = !a.widths.empty() ? a.widths[0].org : 50 * (Long)m.upem / 2048;
        a.edge_distance_threshold = stdw / 5;
        a.standard_width = stdw;
        a.extra_light = false;
    }
}

// af_latin_metrics_init_blues
void init_blues(Face& f, Metrics& m) {
    Axis& axis = m.axis[1];
    axis.blues.clear();
    Long flat_threshold = 33 * (Long)m.upem / 2048;
    for (const BlueString& bs : LATIN_BLUES) {
        bool top = (bs.flags & BL_TOP) != 0;
        std::vector<Long> flats, rounds;
        Long ascender = 0, descender = 0;
        for (const char* p = bs.chars; *p; p++) {
            int gid = (int)f.char_index((uint8_t)*p);
            if (!gid) continue;
            Glyph g;
            if (f.load_unscaled(gid, g) || g.pts.size() <= 2) continue;
            const std::vector<Vec>& pts = g.pts;
            int best_point = -1, best_first = -1, best_last = -1;
            Long best_y = 0;
            int first = 0, last = -1;
            for (size_t nn = 0; nn < g.ends.size(); first = last + 1, nn++) {
                int old_best = best_point;
                last = g.ends[nn];
                if (last <= first) continue;
                if (top) {
                    for (int pp = first; pp <= last; pp++) {
                        if (best_point < 0 || pts[pp].y > best_y) {
                            best_point = pp;
                            best_y = pts[pp].y;
                            ascender = std::max(ascender, best_y);
                        } else {
                            descender = std::min(descender, pts[pp].y);
                        }
                    }
                } else {
                    for (int pp = first; pp <= last; pp++) {
                        if (best_point < 0 || pts[pp].y < best_y) {
                            best_point = pp;
                            best_y = pts[pp].y;
                            descender = std::min(descender, best_y);
                        } else {
                            ascender = std::max(ascender, pts[pp].y);
                        }
                    }
                }
                if (best_point != old_best) { best_first = first; best_last = last; }
            }
            if (best_point < 0) continue;
            bool round = false;
            {
                Long best_x = pts[best_point].x;
                int on_first = -1, on_last = -1;
                if (g.tags[best_point] & 1) { on_first = best_point; on_last = best_point; }
                int prev = best_point, next = prev;
                do {
                    if (prev > best_first) prev--;
                    else prev = best_last;
                    Long dist = ab(pts[prev].y - best_y);
                    if (dist > 5 && ab(pts[prev].x - best_x) <= 20 * dist) break;
                    if (g.tags[prev] & 1) {
                        on_first = prev;
                        if (on_last < 0) on_last = prev;
                    }
                } while (prev != best_point);
                do {
                    if (next < best_last) next++;
                    else next = best_first;
                    Long dist = ab(pts[next].y - best_y);
                    if (dist > 5 && ab(pts[next].x - best_x) <= 20 * dist) break;
                    if (g.tags[next] & 1) {
                        on_last = next;
                        if (on_first < 0) on_first = next;
                    }
                } while (next != best_point);
                if (on_first >= 0 && on_last >= 0 &&
                    ab(pts[on_last].x - pts[on_first].x) > flat_threshold)
                    round = false;
                else
                    round = !(g.tags[prev] & 1) || !(g.tags[next] & 1);
            }
            if (round) rounds.push_back(best_y);
            else flats.push_back(best_y);
        }
        if (flats.empty() && rounds.empty()) continue;
        std::sort(rounds.begin(), rounds.end());
        std::sort(flats.begin(), flats.end());
        Blue blue;
        if (flats.empty()) blue.ref.org = blue.shoot.org = rounds[rounds.size() / 2];
        else if (rounds.empty()) blue.ref.org = blue.shoot.org = flats[flats.size() / 2];
        else { blue.ref.org = flats[flats.size() / 2]; blue.shoot.org = rounds[rounds.size() / 2]; }
        if (blue.shoot.org != blue.ref.org) {
            Long ref = blue.ref.org, shoot = blue.shoot.org;
            bool over_ref = shoot > ref;
            if (top ^ over_ref) blue.ref.org = blue.shoot.org = (shoot + ref) / 2;
        }
        blue.ascender = ascender;
        blue.descender = descender;
        blue.flags = bs.flags;
        axis.blues.push_back(blue);
    }
    // blue zones must not overlap: sort them by their bottoms, then clip
    // each one's top to the next one's
    int nb = (int)axis.blues.size();
    if (nb) {
        std::vector<Blue*> sorted;
        for (auto& bl : axis.blues) sorted.push_back(&bl);
        auto bottom = [](const Blue* bl) { return (bl->flags & BL_TOP) ? bl->ref.org : bl->shoot.org; };
        for (int i = 1; i < nb; i++)
            for (int j = i; j > 0; j--) {
                if (bottom(sorted[j]) >= bottom(sorted[j - 1])) break;
                std::swap(sorted[j], sorted[j - 1]);
            }
        for (int i = 0; i < nb - 1; i++) {
            Long* a = (sorted[i]->flags & BL_TOP) ? &sorted[i]->shoot.org : &sorted[i]->ref.org;
            Long* b2 = (sorted[i + 1]->flags & BL_TOP) ? &sorted[i + 1]->shoot.org : &sorted[i + 1]->ref.org;
            if (*a > *b2) *a = *b2;
        }
    }
}

// af_latin_metrics_check_digits: the digits' advances in font units
void check_digits(Face& f, Metrics& m) {
    bool started = false, same = true;
    int old_advance = 0;
    for (uint32_t c = '0'; c <= '9'; c++) {
        int gid = (int)f.char_index(c);
        if (!gid) continue;
        int aw, lsb;
        f.hmetrics(gid, aw, lsb);
        if (started) {
            if (aw != old_advance) { same = false; break; }
        } else {
            old_advance = aw;
            started = true;
        }
    }
    m.digits_have_same_width = same;
}

// The face's glyph styles and Latin metrics, computed once.
void init_face(Face& f) {
    if (!f.af_styles.empty()) return;
    f.af_styles.assign((size_t)std::max(f.num_glyphs, 1), STYLE_NONE);
    for (auto& r : LATIN_RANGES)
        for (uint32_t c = r[0]; c <= r[1]; c++) {
            uint32_t g = f.char_index(c);
            if (g && (int)g < f.num_glyphs) f.af_styles[g] = STYLE_LATIN;
        }
    for (auto& r : LATIN_NONBASE)
        for (uint32_t c = r[0]; c <= r[1]; c++) {
            uint32_t g = f.char_index(c);
            if (g && (int)g < f.num_glyphs && (f.af_styles[g] & 0xFF) == STYLE_LATIN)
                f.af_styles[g] |= STYLE_NONBASE;
        }
    for (uint32_t c = '0'; c <= '9'; c++) {
        uint32_t g = f.char_index(c);
        if (g && (int)g < f.num_glyphs) f.af_styles[g] |= STYLE_DIGIT;
    }
    for (uint32_t c : {(uint32_t)'i', (uint32_t)'j'}) {  // the adjustment database's dotted letters
        uint32_t g = f.char_index(c);
        if (g && (int)g < f.num_glyphs) f.af_styles[g] |= STYLE_ADJUST_UP;
    }
    Metrics& m = f.af_metrics;
    m.upem = f.upem;
    init_widths(f, m);
    init_blues(f, m);
    check_digits(f, m);
    f.af_x_scale = f.af_y_scale = 0;
}

// af_latin_metrics_scale: the widths, the x-height scale and the blue zones at the face's size
void scale_metrics(Face& f) {
    Metrics& m = f.af_metrics;
    if (f.af_x_scale == f.x_scale) return;
    for (int dim = 0; dim < 2; dim++) {
        Axis& axis = m.axis[dim];
        Long scale = dim == 0 ? f.x_scale : f.y_scale, delta = 0;
        if (dim == 1) {
            const Blue* blue = nullptr;
            for (auto& bl : axis.blues)
                if (bl.flags & BL_ADJUSTMENT) { blue = &bl; break; }
            if (blue) {
                Long scaled = mul_fix(blue->shoot.org, scale);
                Long fitted = (scaled + 40) & ~63;
                if (scaled != fitted) {
                    Long new_scale = mul_div(scale, fitted, scaled);
                    Long max_height = m.upem;
                    for (auto& bl : axis.blues) {
                        max_height = std::max(max_height, bl.ascender);
                        max_height = std::max(max_height, -bl.descender);
                    }
                    Long dist = mul_fix(max_height, new_scale - scale);
                    if (-128 < dist && dist < 128) scale = new_scale;
                }
            }
        }
        axis.scale = scale;
        axis.delta = delta;
        for (auto& w : axis.widths) { w.cur = mul_fix(w.org, scale); w.fit = w.cur; }
        axis.extra_light = mul_fix(axis.standard_width, scale) < 32 + 8;
        if (dim == 1) {
            for (auto& bl : axis.blues) {
                bl.ref.cur = mul_fix(bl.ref.org, scale) + delta;
                bl.ref.fit = bl.ref.cur;
                bl.shoot.cur = mul_fix(bl.shoot.org, scale) + delta;
                bl.shoot.fit = bl.shoot.cur;
                bl.flags &= ~BL_ACTIVE;
                Long dist = mul_fix(bl.ref.org - bl.shoot.org, scale);
                if (dist <= 48 && dist >= -48) {
                    Long d2 = ab(dist);
                    if (d2 < 32) d2 = 0;
                    else if (d2 < 48) d2 = 32;
                    else d2 = 64;
                    if (dist < 0) d2 = -d2;
                    bl.ref.fit = pix_round(bl.ref.cur);
                    bl.shoot.fit = bl.ref.fit - d2;
                    bl.flags |= BL_ACTIVE;
                }
            }
        }
    }
    f.af_x_scale = f.x_scale;
}

}  // namespace af

// af_loader_load_glyph in the normal render mode: → the hinted outline
// moved by the hinted left side bearing, and the hinted advance.
int autohint_glyph(Face& f, int gid, Glyph& out) {
    af::init_face(f);
    af::scale_metrics(f);
    const af::Metrics& m = f.af_metrics;
    Glyph g;
    int err = f.load_unscaled(gid, g);
    if (err) return err;
    int style = gid < (int)f.af_styles.size() ? f.af_styles[gid] : af::STYLE_NONE;
    bool latin = (style & 0xFF) == af::STYLE_LATIN;
    af::Hints h;
    h.upem = f.upem;
    h.x_scale = latin ? m.axis[0].scale : f.x_scale;
    h.y_scale = latin ? m.axis[1].scale : f.y_scale;
    Long pp1x = 0, pp2x = mul_fix(g.advance, h.x_scale);
    if (!g.pts.empty()) {
        af::reload(h, g.pts, g.tags, g.ends);
        bool horizontal = !f.italic();
        if (latin) {
            if (horizontal) {
                af::compute_segments(h, 0);
                af::link_segments(h, m.axis[0].widths.empty() ? 0 : m.axis[0].widths.back().org, 0);
                af::compute_edges(h, m.axis[0], 0);
            }
            af::compute_segments(h, 1);
            af::link_segments(h, m.axis[1].widths.empty() ? 0 : m.axis[1].widths.back().org, 1);
            af::compute_edges(h, m.axis[1], 1);
            if (!(style & af::STYLE_NONBASE)) af::compute_blue_edges(h, m);
            for (int dim = 0; dim < 2; dim++) {
                if (dim == 0 && !horizontal) continue;
                af::hint_edges(h, m, dim, f.ppem);
                af::align_edge_points(h, dim);
                af::align_strong_points(h, dim);
                af::align_weak_points(h, dim);
            }
            if (style & af::STYLE_ADJUST_UP) af::separate_top_contour(h);
        }
        for (size_t i = 0; i < g.pts.size(); i++) { g.pts[i].x = h.pts[i].x; g.pts[i].y = h.pts[i].y; }
        const std::vector<af::Edge>& E = h.axis[0].edges;
        if (latin && horizontal && E.size() > 1) {
            const af::Edge& e1 = E.front();
            const af::Edge& e2 = E.back();
            Long old_rsb = pp2x - e2.opos, old_lsb = e1.opos, new_lsb = e1.pos;
            Long pp1x_uh = new_lsb - old_lsb, pp2x_uh = e2.pos + old_rsb;
            if (old_lsb < 24) pp1x_uh -= 8;
            if (old_rsb < 24) pp2x_uh += 8;
            pp1x = pix_round(pp1x_uh);
            pp2x = pix_round(pp2x_uh);
            if (pp1x >= new_lsb && old_lsb > 0) pp1x -= 64;
            if (pp2x <= e2.pos && old_rsb > 0) pp2x += 64;
        } else {
            pp1x = pix_round(pp1x);
            pp2x = pix_round(pp2x);
        }
    } else {
        pp1x = pix_round(pp1x);
        pp2x = pix_round(pp2x);
    }
    if (pp1x)
        for (auto& v : g.pts) v.x -= pp1x;
    Long adv;
    if (f.fixed_pitch() || ((style & af::STYLE_DIGIT) && latin && m.digits_have_same_width))
        adv = mul_fix(g.advance, latin ? m.axis[0].scale : f.x_scale);
    else
        adv = g.advance ? pp2x - pp1x : 0;
    out.pts = g.pts;
    out.tags = g.tags;
    out.ends = g.ends;
    out.advance = pix_round(adv);
    out.linear = g.linear;
    return 0;
}

// ----------------------------------------------------- gray rasteriser

struct Raster {
    int w = 0, h = 0;
    std::vector<Long> area;
    std::vector<int> cover;
    Long x = 0, y = 0;  // 24.8
    int ex = 0, ey = 0;
    Long c_area = 0;
    int c_cover = 0;
    bool invalid = true;
    static const int PB = 8, ONE = 256;

    void init(int w_, int h_) {
        w = w_; h = h_;
        area.assign((size_t)(w + 1) * h, 0);
        cover.assign((size_t)(w + 1) * h, 0);
        invalid = true;
        c_area = 0; c_cover = 0;
    }
    void record() {
        if (!invalid && (c_area || c_cover)) {
            size_t i = (size_t)ey * (w + 1) + (ex + 1);
            area[i] += c_area;
            cover[i] += c_cover;
        }
    }
    void set_cell(int nex, int ney) {
        record();
        c_area = 0; c_cover = 0;
        ex = std::max(nex, -1);
        ey = ney;
        invalid = ney >= h || ney < 0 || nex >= w;
    }
    static int TRUNC(Long v) { return (int)(v >> PB); }
    static int FRACT(Long v) { return (int)(v & (ONE - 1)); }

    void render_line(Long to_x, Long to_y) {
        int ey1 = TRUNC(y), ey2 = TRUNC(to_y);
        if ((ey1 >= h && ey2 >= h) || (ey1 < 0 && ey2 < 0)) { x = to_x; y = to_y; return; }
        int ex1 = TRUNC(x), ex2 = TRUNC(to_x);
        int fx1 = FRACT(x), fy1 = FRACT(y), fx2, fy2;
        Long dx = to_x - x, dy = to_y - y;
        if (ex1 == ex2 && ey1 == ey2) {
        } else if (dy == 0) {
            set_cell(ex2, ey2);
            x = to_x; y = to_y;
            return;
        } else if (dx == 0) {
            if (dy > 0) {
                do {
                    fy2 = ONE;
                    c_cover += fy2 - fy1;
                    c_area += (Long)(fy2 - fy1) * fx1 * 2;
                    fy1 = 0;
                    ey1++;
                    set_cell(ex1, ey1);
                } while (ey1 != ey2);
            } else {
                do {
                    fy2 = 0;
                    c_cover += fy2 - fy1;
                    c_area += (Long)(fy2 - fy1) * fx1 * 2;
                    fy1 = ONE;
                    ey1--;
                    set_cell(ex1, ey1);
                } while (ey1 != ey2);
            }
        } else {
            Long prod = dx * (Long)fy1 - dy * (Long)fx1;
            Long dx_r = ex1 != ex2 ? (Long)(UINT64_MAX >> PB) / dx : 0;
            Long dy_r = ey1 != ey2 ? (Long)(UINT64_MAX >> PB) / dy : 0;
            auto udiv = [](Long a, Long r) -> int {
                return (int)(((uint64_t)a * (uint64_t)r) >> (64 - PB));
            };
            do {
                if (prod - dx * ONE > 0 && prod <= 0) {  // left
                    fx2 = 0;
                    fy2 = udiv(-prod, -dx_r);
                    prod -= dy * ONE;
                    c_cover += fy2 - fy1;
                    c_area += (Long)(fy2 - fy1) * (fx1 + fx2);
                    fx1 = ONE;
                    fy1 = fy2;
                    ex1--;
                } else if (prod - dx * ONE + dy * ONE > 0 && prod - dx * ONE <= 0) {  // up
                    prod -= dx * ONE;
                    fx2 = udiv(-prod, dy_r);
                    fy2 = ONE;
                    c_cover += fy2 - fy1;
                    c_area += (Long)(fy2 - fy1) * (fx1 + fx2);
                    fx1 = fx2;
                    fy1 = 0;
                    ey1++;
                } else if (prod + dy * ONE >= 0 && prod - dx * ONE + dy * ONE <= 0) {  // right
                    prod += dy * ONE;
                    fx2 = ONE;
                    fy2 = udiv(prod, dx_r);
                    c_cover += fy2 - fy1;
                    c_area += (Long)(fy2 - fy1) * (fx1 + fx2);
                    fx1 = 0;
                    fy1 = fy2;
                    ex1++;
                } else {  // down
                    fx2 = udiv(prod, -dy_r);
                    fy2 = 0;
                    prod += dx * ONE;
                    c_cover += fy2 - fy1;
                    c_area += (Long)(fy2 - fy1) * (fx1 + fx2);
                    fx1 = fx2;
                    fy1 = ONE;
                    ey1--;
                }
                set_cell(ex1, ey1);
            } while (ex1 != ex2 || ey1 != ey2);
        }
        fx2 = FRACT(to_x);
        fy2 = FRACT(to_y);
        c_cover += fy2 - fy1;
        c_area += (Long)(fy2 - fy1) * (fx1 + fx2);
        x = to_x; y = to_y;
    }

    void render_conic(Long cx, Long cy, Long tx, Long ty) {
        Vec p0{x, y}, p1{cx << 2, cy << 2}, p2{tx << 2, ty << 2};
        if ((TRUNC(p0.y) >= h && TRUNC(p1.y) >= h && TRUNC(p2.y) >= h) ||
            (TRUNC(p0.y) < 0 && TRUNC(p1.y) < 0 && TRUNC(p2.y) < 0)) {
            x = p2.x; y = p2.y;
            return;
        }
        Long bx = p1.x - p0.x, by = p1.y - p0.y;
        Long ax = p2.x - p1.x - bx, ay = p2.y - p1.y - by;
        Long dx = std::labs(ax), dy = std::labs(ay);
        if (dx < dy) dx = dy;
        if (dx <= ONE / 4) { render_line(p2.x, p2.y); return; }
        int shift = 0;
        do { dx >>= 2; shift += 1; } while (dx > ONE / 4);
        int64_t rx = (int64_t)((uint64_t)ax << (33 - 2 * shift));
        int64_t ry = (int64_t)((uint64_t)ay << (33 - 2 * shift));
        int64_t qx = (int64_t)(((uint64_t)bx << (33 - shift)) + ((uint64_t)ax << (32 - 2 * shift)));
        int64_t qy = (int64_t)(((uint64_t)by << (33 - shift)) + ((uint64_t)ay << (32 - 2 * shift)));
        int64_t px = (int64_t)((uint64_t)p0.x << 32), py = (int64_t)((uint64_t)p0.y << 32);
        for (unsigned count = 1u << shift; count > 0; count--) {
            px += qx; py += qy;
            qx += rx; qy += ry;
            render_line((Long)(px >> 32), (Long)(py >> 32));
        }
    }

    void move_to(Long tx, Long ty) {
        Long vx = tx << 2, vy = ty << 2;
        set_cell(TRUNC(vx), TRUNC(vy));
        x = vx; y = vy;
    }

    // Decompose the outline as FT_Outline_Decompose does.
    void outline(const std::vector<Vec>& pts, const std::vector<uint8_t>& tags,
                 const std::vector<uint16_t>& ends) {
        int first = 0;
        for (size_t c = 0; c < ends.size(); c++) {
            int last = ends[c];
            if (last < first) { first = last + 1; continue; }
            Vec v_start = pts[first], v_last = pts[last];
            int point = first, limit = last;
            if ((tags[first] & 1) == 0) {
                if (tags[last] & 1) { v_start = v_last; limit--; }
                else { v_start.x = (v_start.x + v_last.x) / 2; v_start.y = (v_start.y + v_last.y) / 2; }
                point--;
            }
            move_to(v_start.x, v_start.y);
            bool closed = false;
            while (point < limit) {
                point++;
                if (tags[point] & 1) { render_line(pts[point].x << 2, pts[point].y << 2); continue; }
                Vec ctrl = pts[point];
                while (true) {
                    if (point < limit) {
                        point++;
                        Vec v = pts[point];
                        if (tags[point] & 1) { render_conic(ctrl.x, ctrl.y, v.x, v.y); break; }
                        Vec mid{(ctrl.x + v.x) / 2, (ctrl.y + v.y) / 2};
                        render_conic(ctrl.x, ctrl.y, mid.x, mid.y);
                        ctrl = v;
                        continue;
                    }
                    render_conic(ctrl.x, ctrl.y, v_start.x, v_start.y);
                    closed = true;
                    break;
                }
                if (closed) break;
            }
            if (!closed) render_line(v_start.x << 2, v_start.y << 2);
            first = last + 1;
        }
        set_cell(0, h);  // flush the last cell
    }

    // The sweep: rows bottom-up into a top-down bitmap.
    void sweep(uint8_t* dst) {
        for (int yy = 0; yy < h; yy++) {
            uint8_t* row = dst + (size_t)(h - 1 - yy) * w;
            Long run = 0;
            const Long* ar = &area[(size_t)yy * (w + 1)];
            const int* cv = &cover[(size_t)yy * (w + 1)];
            for (int xx = -1; xx < w; xx++) {
                run += (Long)cv[xx + 1] * (ONE * 2);
                Long a = run - ar[xx + 1];
                if (xx >= 0 && a != 0) {
                    int c = (int)(a >> (PB * 2 + 1 - 8));
                    if (c & INT32_MIN) c = ~c;
                    if (c > 255) c = 255;
                    row[xx] = (uint8_t)c;
                }
            }
        }
    }
};

struct Bitmap { int w = 0, h = 0, left = 0, top = 0; std::vector<uint8_t> buf; };

void cbox(const std::vector<Vec>& pts, Long& xmin, Long& ymin, Long& xmax, Long& ymax) {
    if (pts.empty()) { xmin = ymin = xmax = ymax = 0; return; }
    xmin = xmax = pts[0].x; ymin = ymax = pts[0].y;
    for (auto& v : pts) {
        xmin = std::min(xmin, v.x); xmax = std::max(xmax, v.x);
        ymin = std::min(ymin, v.y); ymax = std::max(ymax, v.y);
    }
}

// FT_Glyph_To_Bitmap(FT_RENDER_MODE_NORMAL) of the glyph moved by (dx, dy).
void render_glyph(const Glyph& g, Long dx, Long dy, Bitmap& out) {
    std::vector<Vec> pts = g.pts;
    for (auto& v : pts) { v.x += dx; v.y += dy; }
    Long x0, y0, x1, y1;
    cbox(pts, x0, y0, x1, y1);
    Long l = x0 >> 6, bt = y0 >> 6, r = (x1 + 63) >> 6, t = (y1 + 63) >> 6;
    if (pts.empty()) { l = bt = r = t = 0; }
    out.left = (int)l;
    out.top = (int)t;
    out.w = (int)(r - l);
    out.h = (int)(t - bt);
    out.buf.assign((size_t)out.w * out.h, 0);
    if (!out.w || !out.h || g.ends.empty()) return;
    for (auto& v : pts) { v.x -= l * 64; v.y -= bt * 64; }
    Raster ras;
    ras.init(out.w, out.h);
    ras.outline(pts, g.tags, g.ends);
    ras.sweep(out.buf.data());
}

// ------------------------------------------------------------- layout

struct Shaped { int gid; Long x_advance, x_offset, y_offset; };

// Coverage index of ``gid`` in the Coverage table at ``off``, else -1.
int coverage_index(const Bytes& b, size_t off, int gid) {
    int fmt = b.u16(off);
    if (fmt == 1) {
        int n = b.u16(off + 2);
        int lo = 0, hi = n - 1;
        while (lo <= hi) {
            int m = (lo + hi) / 2, g = b.u16(off + 4 + 2 * m);
            if (g == gid) return m;
            if (g < gid) lo = m + 1; else hi = m - 1;
        }
        return -1;
    }
    if (fmt == 2) {
        int n = b.u16(off + 2);
        for (int i = 0; i < n; i++) {
            size_t r = off + 4 + 6 * i;
            int s = b.u16(r), e = b.u16(r + 2);
            if (gid >= s && gid <= e) return b.u16(r + 4) + gid - s;
        }
    }
    return -1;
}

int class_of(const Bytes& b, size_t off, int gid) {
    int fmt = b.u16(off);
    if (fmt == 1) {
        int start = b.u16(off + 2), n = b.u16(off + 4);
        if (gid >= start && gid < start + n) return b.u16(off + 6 + 2 * (gid - start));
        return 0;
    }
    if (fmt == 2) {
        int n = b.u16(off + 2);
        for (int i = 0; i < n; i++) {
            size_t r = off + 4 + 6 * i;
            if (gid >= b.u16(r) && gid <= b.u16(r + 2)) return b.u16(r + 4);
        }
    }
    return 0;
}

int value_size(int fmt) { int n = 0; for (int i = 0; i < 8; i++) n += (fmt >> i) & 1; return 2 * n; }

// The x-advance adjustment of a ValueRecord (device and variation tables
// are zero at the default instance and at these sizes).
int value_x_advance(const Bytes& b, size_t rec, int fmt) {
    size_t o = rec;
    if (fmt & 1) o += 2;
    if (fmt & 2) o += 2;
    if (fmt & 4) return b.s16(o);
    return 0;
}

int value_x_placement(const Bytes& b, size_t rec, int fmt) {
    return (fmt & 1) ? b.s16(rec) : 0;
}

// One PairPos subtable on (g1, g2): → true if it matched, with the
// first glyph's x-advance / x-placement and the second's, in font units.
bool pair_pos(const Bytes& b, size_t st, int g1, int g2, int& adv1, int& pl1, int& adv2, int& pl2,
              int& vf2_out) {
    int fmt = b.u16(st);
    size_t cov = st + b.u16(st + 2);
    int vf1 = b.u16(st + 4), vf2 = b.u16(st + 6);
    vf2_out = vf2;
    int ci = coverage_index(b, cov, g1);
    if (ci < 0) return false;
    int s1 = value_size(vf1), s2 = value_size(vf2);
    if (fmt == 1) {
        int nsets = b.u16(st + 8);
        if (ci >= nsets) return false;
        size_t ps = st + b.u16(st + 10 + 2 * ci);
        int n = b.u16(ps);
        int rec = 2 + s1 + s2;
        int lo = 0, hi = n - 1;
        while (lo <= hi) {
            int m = (lo + hi) / 2;
            size_t r = ps + 2 + (size_t)rec * m;
            int g = b.u16(r);
            if (g == g2) {
                adv1 = value_x_advance(b, r + 2, vf1); pl1 = value_x_placement(b, r + 2, vf1);
                adv2 = value_x_advance(b, r + 2 + s1, vf2); pl2 = value_x_placement(b, r + 2 + s1, vf2);
                return true;
            }
            if (g < g2) lo = m + 1; else hi = m - 1;
        }
        return false;
    }
    if (fmt == 2) {
        size_t cd1 = st + b.u16(st + 8), cd2 = st + b.u16(st + 10);
        int n1 = b.u16(st + 12), n2 = b.u16(st + 14);
        int c1 = class_of(b, cd1, g1), c2 = class_of(b, cd2, g2);
        if (c1 >= n1 || c2 >= n2) return false;
        size_t r = st + 16 + ((size_t)c1 * n2 + c2) * (s1 + s2);
        adv1 = value_x_advance(b, r, vf1); pl1 = value_x_placement(b, r, vf1);
        adv2 = value_x_advance(b, r + s1, vf2); pl2 = value_x_placement(b, r + s1, vf2);
        return true;
    }
    return false;
}

void find_kern_lookups(Face& f) {
    if (!f.gpos) return;
    const Bytes& b = f.b;
    size_t sl = f.gpos + b.u16(f.gpos + 4), fl = f.gpos + b.u16(f.gpos + 6),
           ll = f.gpos + b.u16(f.gpos + 8);
    auto collect = [&](size_t langsys, std::vector<size_t>& out, std::vector<int>& flags) {
        std::vector<int> idx;
        int nf = b.u16(langsys + 4);
        int req = b.u16(langsys + 2);
        std::vector<int> feats;
        if (req != 0xFFFF) feats.push_back(req);
        for (int i = 0; i < nf; i++) feats.push_back(b.u16(langsys + 6 + 2 * i));
        int nfl = b.u16(fl);
        for (int fi : feats) {
            if (fi >= nfl) continue;
            size_t fr = fl + 2 + 6 * fi;
            char tag[5] = {(char)b.u8(fr), (char)b.u8(fr + 1), (char)b.u8(fr + 2), (char)b.u8(fr + 3), 0};
            // of HarfBuzz's default features only kern's pair adjustments
            // fire on these renderers' glyphs (tests/test_torch_truetype.py)
            if (std::strcmp(tag, "kern")) continue;
            size_t feat = fl + b.u16(fr + 4);
            int nl = b.u16(feat + 2);
            for (int i = 0; i < nl; i++) idx.push_back(b.u16(feat + 4 + 2 * i));
        }
        std::sort(idx.begin(), idx.end());
        idx.erase(std::unique(idx.begin(), idx.end()), idx.end());
        int nll = b.u16(ll);
        for (int li : idx) {
            if (li >= nll) continue;
            size_t lk = ll + b.u16(ll + 2 + 2 * li);
            int type = b.u16(lk), flag = b.u16(lk + 2), nsub = b.u16(lk + 4);
            for (int s = 0; s < nsub; s++) {
                size_t st = lk + b.u16(lk + 6 + 2 * s);
                int t = type;
                if (t == 9) { t = b.u16(st + 2); st = st + b.u32(st + 4); }
                if (t == 2) { out.push_back(st); flags.push_back(flag); }
            }
            out.push_back(0);  // lookup boundary
            flags.push_back(-1);
        }
    };
    int ns = b.u16(sl);
    size_t dflt = 0, latn = 0;
    for (int i = 0; i < ns; i++) {
        size_t r = sl + 2 + 6 * i;
        uint32_t tag = b.u32(r);
        size_t script = sl + b.u16(r + 4);
        size_t dl = b.u16(script) ? script + b.u16(script) : 0;
        if (tag == 0x44464C54) dflt = dl;         // DFLT
        else if (tag == 0x6C61746E) latn = dl;    // latn
    }
    if (latn) collect(latn, f.kern_latn, f.kern_latn_flags);
    else if (dflt) collect(dflt, f.kern_latn, f.kern_latn_flags);
    if (dflt) collect(dflt, f.kern_dflt, f.kern_dflt_flags);
    else if (latn) collect(latn, f.kern_dflt, f.kern_dflt_flags);
}

bool is_mark(const Face& f, int gid) {
    if (!f.gdef) return false;
    size_t cd = f.b.u16(f.gdef + 4);
    if (!cd) return false;
    return class_of(f.b, f.gdef + cd, gid) == 3;
}

// HarfBuzz through raqm on a single-script run: FreeType's unhinted
// advances, then the default-feature GPOS pair positioning.
void shape(Face& f, const uint32_t* text, int n, std::vector<Shaped>& out) {
    out.clear();
    if (f.basic_layout) {  // Pillow's text_layout_fallback: hinted advances, no kern table
        for (int i = 0; i < n; i++) {
            Shaped s;
            s.gid = (int)f.char_index(text[i]);
            Glyph g;
            s.x_advance = f.load_glyph(s.gid, true, g) ? 0 : g.advance;
            s.x_offset = 0;
            s.y_offset = 0;
            out.push_back(s);
        }
        return;
    }
    bool latin = false;
    for (int i = 0; i < n; i++) {
        uint32_t c = text[i];
        if ((c >= 'A' && c <= 'Z') || (c >= 'a' && c <= 'z') || (c >= 0xC0 && c <= 0x24F && c != 0xD7 && c != 0xF7))
            latin = true;
    }
    for (int i = 0; i < n; i++) {
        Shaped s;
        s.gid = (int)f.char_index(text[i]);
        int aw, lsb;
        f.hmetrics(s.gid, aw, lsb);
        Long v = mul_div(aw, f.x_scale, 64);  // 16.16 (FT_Get_Advance, no hinting)
        s.x_advance = (v + (1 << 9)) >> 10;
        s.x_offset = 0;
        s.y_offset = 0;
        out.push_back(s);
    }
    const std::vector<size_t>& subs = latin ? f.kern_latn : f.kern_dflt;
    const std::vector<int>& flags = latin ? f.kern_latn_flags : f.kern_dflt_flags;
    if (subs.empty() || n < 2) return;
    Long hb_scale = (Long)(((uint64_t)f.x_scale * (uint64_t)f.upem + (1u << 15)) >> 16);
    int64_t x_mult = ((int64_t)hb_scale << 16) / f.upem;
    auto em = [&](int v) -> Long { return (Long)(((int64_t)v * x_mult + 32768) >> 16); };
    // apply lookup by lookup, each across the buffer
    size_t i0 = 0;
    while (i0 < subs.size()) {
        size_t i1 = i0;
        while (subs[i1] != 0) i1++;
        int flag = i1 > i0 ? flags[i0] : 0;
        int i = 0;
        while (i < n) {
            if ((flag & 8) && is_mark(f, out[i].gid)) { i++; continue; }
            int j = i + 1;
            while (j < n && (flag & 8) && is_mark(f, out[j].gid)) j++;
            if (j >= n) break;
            bool matched = false;
            for (size_t k = i0; k < i1 && !matched; k++) {
                int a1 = 0, p1 = 0, a2 = 0, p2 = 0, vf2 = 0;
                if (pair_pos(f.b, subs[k], out[i].gid, out[j].gid, a1, p1, a2, p2, vf2)) {
                    matched = true;
                    out[i].x_advance += em(a1);
                    out[i].x_offset += em(p1);
                    out[j].x_advance += em(a2);
                    out[j].x_offset += em(p2);
                    i = vf2 ? j + 1 : j;
                }
            }
            if (!matched) i++;
        }
        i0 = i1 + 1;
    }
}

inline int PIXEL(Long x) { return (int)((x + 32) >> 6); }

struct Rendered { int w = 0, h = 0, x_offset = 0, y_offset = 0; std::vector<uint8_t> mask; };

// Pillow's font_render for mode "L" with anchor "la" and no stroke.
int render_text(Face& f, const uint32_t* text, int n, double x_start, double y_start, Rendered& out) {
    std::vector<Shaped> run;
    shape(f, text, n, run);
    int count = (int)run.size();
    std::vector<Glyph> glyphs(count);
    Long position = 0;
    int x_min = 0, x_max = 0, y_min = 0, y_max = 0;
    for (int i = 0; i < count; i++) {
        int px = PIXEL(position + run[i].x_offset);
        int py = PIXEL(run[i].y_offset);
        position += run[i].x_advance;
        int advanced = PIXEL(position);
        if (advanced > x_max) x_max = advanced;
        int err = f.load_glyph(run[i].gid, true, glyphs[i]);
        if (err) return err;
        Long cx0, cy0, cx1, cy1;
        cbox(glyphs[i].pts, cx0, cy0, cx1, cy1);
        int bx0 = (int)(pix_floor(cx0) >> 6), by0 = (int)(pix_floor(cy0) >> 6);
        int bx1 = (int)(pix_ceil(cx1) >> 6), by1 = (int)(pix_ceil(cy1) >> 6);
        if (bx1 + px > x_max) x_max = bx1 + px;
        if (bx0 + px < x_min) x_min = bx0 + px;
        if (by1 + py > y_max) y_max = by1 + py;
        if (by0 + py < y_min) y_min = by0 + py;
    }
    int x_anchor = 0, y_anchor = count ? PIXEL(f.size_ascender) : 0;
    int width = x_max - x_min, height = y_max - y_min;
    int x_offset = -x_anchor + x_min;
    int y_offset = -(-y_anchor + y_max);
    width += (int)std::ceil(x_start);
    height += (int)std::ceil(y_start);
    out.w = width;
    out.h = height;
    out.x_offset = x_offset;
    out.y_offset = y_offset;
    out.mask.assign((size_t)std::max(0, width) * std::max(0, height), 0);
    if (count == 0 || width == 0 || height == 0) return 0;
    // the pen starts at the text box's origin moved by the start, rounded
    // to 26.6; each glyph is drawn at its pen position's nearest pixel
    Long sx = (Long)std::lround(x_start * 64), sy = (Long)std::lround(y_start * 64);
    Long pen_x = -(Long)x_min * 64 + sx;
    Long pen_y = -(Long)y_max * 64 - sy;
    for (int i = 0; i < count; i++) {
        int px = PIXEL(pen_x + run[i].x_offset);
        int py = PIXEL(pen_y + run[i].y_offset);
        Bitmap bm;
        render_glyph(glyphs[i], 0, 0, bm);
        int xx = px + bm.left;
        int yy = -(py + bm.top);
        int x0 = 0, x1 = bm.w;
        if (xx < 0) x0 = -xx;
        if (xx + x1 > width) x1 = width - xx;
        for (int r = 0; r < bm.h; r++, yy++) {
            if (yy < 0 || yy >= height) continue;
            uint8_t* t = out.mask.data() + (size_t)yy * width + xx;
            const uint8_t* s = bm.buf.data() + (size_t)r * bm.w;
            for (int k = x0; k < x1; k++) {  // alpha over: t + s - t * s / 255
                unsigned tv = t[k], sv = s[k], tmp = tv * sv + 128;
                t[k] = (uint8_t)(tv + sv - (((tmp >> 8) + tmp) >> 8));
            }
        }
        pen_x += run[i].x_advance;
    }
    return 0;
}

}  // namespace

// ------------------------------------------------------------- C API

extern "C" {

void* tt_open(const uint8_t* data, int64_t len) {
    Face* f = new Face();
    if (!f->load(data, (size_t)len)) { delete f; return nullptr; }
    find_kern_lookups(*f);
    return f;
}

void tt_close(void* h) { delete (Face*)h; }

int tt_set_size(void* h, int size) {
    Face* f = (Face*)h;
    f->set_size(size);
    return f->fpgm_error * 2 + f->prep_error;
}

int tt_autohinted(void* h) { return ((Face*)h)->autohinted() ? 1 : 0; }

// Pillow's BASIC layout (``basic`` != 0) or raqm's: → 0, or 1 where the
// BASIC layout would kern from a 'kern' table, which is not ported.
int tt_set_layout(void* h, int basic) {
    Face* f = (Face*)h;
    if (basic && f->kern) return 1;
    f->basic_layout = basic != 0;
    return 0;
}

int tt_char_index(void* h, uint32_t c) { return (int)((Face*)h)->char_index(c); }

// The outline of glyph ``gid`` (26.6): → its point count (or -1 on error,
// or the needed count if more than ``cap``).
int tt_glyph_outline(void* h, int gid, int hinted, int64_t* xy, uint8_t* tags, int cap,
                     int* ends, int cap_c, int* n_contours, int64_t* advance) {
    Face* f = (Face*)h;
    Glyph g;
    if (f->load_glyph(gid, hinted != 0, g)) return -1;
    int n = (int)g.pts.size();
    if (n > cap || (int)g.ends.size() > cap_c) return n;
    for (int i = 0; i < n; i++) { xy[2 * i] = g.pts[i].x; xy[2 * i + 1] = g.pts[i].y; tags[i] = g.tags[i]; }
    for (size_t i = 0; i < g.ends.size(); i++) ends[i] = g.ends[i];
    *n_contours = (int)g.ends.size();
    *advance = g.advance;
    return n;
}

// The glyph's bitmap, moved by (dx, dy) in 26.6: fills ``box`` with
// (width, rows, left, top) and ``buf`` if it holds width * rows bytes.
int tt_glyph_bitmap(void* h, int gid, int64_t dx, int64_t dy, uint8_t* buf, int64_t cap, int* box) {
    Face* f = (Face*)h;
    Glyph g;
    if (f->load_glyph(gid, true, g)) return -1;
    Bitmap bm;
    render_glyph(g, dx, dy, bm);
    box[0] = bm.w; box[1] = bm.h; box[2] = bm.left; box[3] = bm.top;
    if ((int64_t)bm.buf.size() <= cap && !bm.buf.empty()) std::memcpy(buf, bm.buf.data(), bm.buf.size());
    return 0;
}

// Shape ``text``: → glyph count; fills gids, x advances and offsets (26.6).
int tt_shape(void* h, const uint32_t* text, int n, int* gids, int64_t* adv, int64_t* xoff) {
    Face* f = (Face*)h;
    std::vector<Shaped> run;
    shape(*f, text, n, run);
    for (size_t i = 0; i < run.size(); i++) { gids[i] = run[i].gid; adv[i] = run[i].x_advance; xoff[i] = run[i].x_offset; }
    return (int)run.size();
}

int64_t tt_text_length(void* h, const uint32_t* text, int n) {
    Face* f = (Face*)h;
    std::vector<Shaped> run;
    shape(*f, text, n, run);
    int64_t s = 0;
    for (auto& r : run) s += r.x_advance;
    return s;
}

// Pillow's getmask2: → 0, and (width, height, x_offset, y_offset) in
// ``box``; the mask is kept for tt_take_mask.
int tt_render_text(void* h, const uint32_t* text, int n, double x_start, double y_start, int* box) {
    Face* f = (Face*)h;
    Rendered r;
    int err = render_text(*f, text, n, x_start, y_start, r);
    if (err) return err;
    box[0] = r.w; box[1] = r.h; box[2] = r.x_offset; box[3] = r.y_offset;
    f->last_mask.swap(r.mask);
    return 0;
}

// Copy the last tt_render_text mask (width * height bytes) into ``mask``.
int tt_take_mask(void* h, uint8_t* mask, int64_t cap) {
    Face* f = (Face*)h;
    if ((int64_t)f->last_mask.size() > cap) return 1;
    if (!f->last_mask.empty()) std::memcpy(mask, f->last_mask.data(), f->last_mask.size());
    return 0;
}

}  // extern "C"
