// Baseline JPEG decoder with libjpeg-turbo's arithmetic, behind a plain C
// interface (bound with ctypes by ddgan_torch/data/jpeg.py).
//
// It gives the pixels that PIL's `Image.open(f)` gives (libjpeg-turbo with
// its defaults: the ISLOW integer IDCT and fancy upsampling) for the files
// it reads:
//   * SOF0 / SOF1 with 8-bit samples, Huffman-coded, in one interleaved
//     scan (what libjpeg and PIL write) or one scan per component (the
//     grey files' case; a 3-component file split into scans follows the
//     same rule but no file of that kind is tested);
//   * DQT tables of 8 or 16 bits, DHT tables, DRI with RST markers;
//   * 1 component (grey), or 3 components in YCbCr with the luma at 1x1,
//     2x1 or 2x2 and the chroma at 1x1 (4:4:4, 4:2:2, 4:2:0);
//   * any width and height, multiples of the MCU or not.
// Progressive, lossless, hierarchical and arithmetic-coded files, 12-bit
// samples, other component counts, RGB-coded 3-component files and other
// sampling layouts are refused (return code 1); malformed files return 2.
//
// The arithmetic is libjpeg-turbo's, step for step:
//   * jidctint.c's jpeg_idct_islow: CONST_BITS 13, PASS1_BITS 2, int64
//     products, the post-IDCT range-limit table indexed with RANGE_MASK.
//     (libjpeg-turbo's SIMD IDCT saturates where the table wraps; the two
//     agree while a sample stays within -512..511 of the center, which
//     every output of a real image does.)
//   * jdsample.c's h2v1 / h2v2 fancy upsampling (the triangle filter with
//     its alternating rounding bias, the first and last sample rows
//     replicated at the component's real height), used when the
//     component's width is above 2 samples; otherwise box replication.
//   * jdcolor.c's YCbCr -> RGB tables (SCALEBITS 16).
//
// Build: c++ -O2 -std=c++17 -shared -fPIC (ddgan_torch/ops/_cxx.py).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

constexpr int kUnsupported = 1;
constexpr int kMalformed = 2;

struct Failure {
    int code;
    std::string what;
};

[[noreturn]] void unsupported(const std::string& what) { throw Failure{kUnsupported, what}; }
[[noreturn]] void malformed(const std::string& what) { throw Failure{kMalformed, what}; }

// zigzag position -> natural (row-major) position; 16 extra entries catch a
// corrupt run that steps past 63, as libjpeg's table does
const int kNaturalOrder[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct Huffman {
    bool defined = false;
    int32_t maxcode[18];   // largest code of each length, -1 if none
    int32_t valoffset[18];
    uint8_t huffval[256];
};

struct Component {
    int id = 0, h = 1, v = 1, tq = 0;
    int dc_table = 0, ac_table = 0;
    int width = 0, height = 0;         // real (downsampled) samples
    int blocks_w = 0, blocks_h = 0;    // blocks held in the plane
    std::vector<uint8_t> plane;        // blocks_h*8 rows of blocks_w*8 samples
    bool seen = false;
};

struct Decoder {
    const uint8_t* data;
    size_t size;
    size_t pos = 0;

    uint16_t qt[4][64];  // natural order
    bool qt_defined[4] = {false, false, false, false};
    Huffman dc[4], ac[4];
    int restart_interval = 0;
    bool saw_jfif = false, saw_adobe = false;
    int adobe_transform = -1;

    int width = 0, height = 0, ncomp = 0, hmax = 1, vmax = 1;
    int mcux = 0, mcuy = 0;
    Component comp[4];
    bool frame = false;

    Decoder(const uint8_t* d, size_t n) : data(d), size(n) {}

    uint8_t byte() {
        if (pos >= size) malformed("the file ends inside a marker segment");
        return data[pos++];
    }
    int u16() {
        int hi = byte();
        return (hi << 8) | byte();
    }

    // the next marker code after skipping fill bytes
    int next_marker() {
        if (pos + 1 >= size) malformed("the file ends before its EOI marker");
        if (data[pos] != 0xFF) malformed("expected a marker");
        while (pos < size && data[pos] == 0xFF) ++pos;
        if (pos >= size) malformed("the file ends before its EOI marker");
        return data[pos++];
    }

    void read_dqt(size_t end) {
        while (pos < end) {
            int pq_tq = byte();
            int pq = pq_tq >> 4, tq = pq_tq & 15;
            if (tq > 3 || pq > 1) malformed("bad DQT table");
            for (int k = 0; k < 64; ++k)
                qt[tq][kNaturalOrder[k]] = static_cast<uint16_t>(pq ? u16() : byte());
            qt_defined[tq] = true;
        }
    }

    void read_dht(size_t end) {
        while (pos < end) {
            int tc_th = byte();
            int tc = tc_th >> 4, th = tc_th & 15;
            if (tc > 1 || th > 3) malformed("bad DHT table");
            uint8_t bits[17] = {0};
            int count = 0;
            for (int l = 1; l <= 16; ++l) {
                bits[l] = byte();
                count += bits[l];
            }
            if (count > 256) malformed("a DHT table with more than 256 codes");
            Huffman& t = tc == 0 ? dc[th] : ac[th];
            for (int i = 0; i < count; ++i) t.huffval[i] = byte();
            // canonical codes (jdhuff.c jpeg_make_d_derived_tbl)
            int code = 0, p = 0;
            for (int l = 1; l <= 16; ++l) {
                if (bits[l]) {
                    t.valoffset[l] = p - code;
                    code += bits[l];
                    p += bits[l];
                    t.maxcode[l] = code - 1;
                } else {
                    t.maxcode[l] = -1;
                }
                if (code > (1 << l)) malformed("a DHT table whose codes overflow");
                code <<= 1;
            }
            t.maxcode[17] = 0x7FFFFFFF;
            t.defined = true;
        }
    }

    void read_sof(int marker) {
        if (frame) malformed("two frames in one file");
        int precision = byte();
        height = u16();
        width = u16();
        ncomp = byte();
        if (marker == 0xC3) unsupported("a lossless JPEG");
        if (marker >= 0xC5 && marker <= 0xC7) unsupported("a hierarchical JPEG");
        if (marker >= 0xC8) unsupported("an arithmetic-coded JPEG");
        if (precision != 8) unsupported(std::to_string(precision) + "-bit samples");
        if (height == 0) unsupported("a height given by a DNL marker");
        if (width == 0) malformed("width 0");
        if (ncomp != 1 && ncomp != 3) unsupported(std::to_string(ncomp) + " components");
        for (int i = 0; i < ncomp; ++i) {
            Component& c = comp[i];
            c.id = byte();
            int hv = byte();
            c.h = hv >> 4;
            c.v = hv & 15;
            c.tq = byte();
            if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3) malformed("bad component");
            hmax = c.h > hmax ? c.h : hmax;
            vmax = c.v > vmax ? c.v : vmax;
        }
        mcux = (width + 8 * hmax - 1) / (8 * hmax);
        mcuy = (height + 8 * vmax - 1) / (8 * vmax);
        for (int i = 0; i < ncomp; ++i) {
            Component& c = comp[i];
            c.width = (width * c.h + hmax - 1) / hmax;
            c.height = (height * c.v + vmax - 1) / vmax;
            c.blocks_w = mcux * c.h;
            c.blocks_h = mcuy * c.v;
            c.plane.assign(static_cast<size_t>(c.blocks_w) * 8 * c.blocks_h * 8, 0);
        }
        frame = true;
    }

    // ------------------------------------------------------------ entropy
    uint64_t bitbuf = 0;
    int bitcount = 0;
    bool hit_marker = false;

    void fill() {
        while (bitcount <= 56) {
            uint64_t b = 0;
            if (!hit_marker) {
                if (pos >= size) malformed("the file ends inside its entropy-coded data");
                b = data[pos];
                if (b == 0xFF) {
                    if (pos + 1 >= size) malformed("the file ends inside its entropy-coded data");
                    if (data[pos + 1] == 0x00) {
                        pos += 2;
                    } else {  // a marker: libjpeg feeds zeros from here on
                        hit_marker = true;
                        b = 0;
                    }
                } else {
                    ++pos;
                }
            }
            bitbuf |= b << (56 - bitcount);
            bitcount += 8;
        }
    }

    int get_bits(int n) {
        if (n == 0) return 0;
        if (bitcount < n) fill();
        int v = static_cast<int>(bitbuf >> (64 - n));
        bitbuf <<= n;
        bitcount -= n;
        return v;
    }

    int decode(const Huffman& t) {
        if (bitcount < 16) fill();
        int32_t peek = static_cast<int32_t>(bitbuf >> 48);
        for (int l = 1; l <= 16; ++l) {
            int32_t code = peek >> (16 - l);
            if (code <= t.maxcode[l]) {
                bitbuf <<= l;
                bitcount -= l;
                return t.huffval[(code + t.valoffset[l]) & 0xFF];
            }
        }
        malformed("a Huffman code that is in no table");
    }

    static int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

    void restart() {
        bitbuf = 0;
        bitcount = 0;
        hit_marker = false;
        while (pos + 1 < size && !(data[pos] == 0xFF && data[pos + 1] != 0x00)) ++pos;
        int m = next_marker();
        if (m < 0xD0 || m > 0xD7) malformed("expected an RST marker");
    }

    // -------------------------------------------------------------- IDCT
    // jidctint.c jpeg_idct_islow; `out` is row-major with `stride`
    static uint8_t range_limit(int64_t x) {
        // the post-IDCT table: x is centered on 0, indexed with RANGE_MASK 1023
        int i = static_cast<int>(x) & 1023;
        if (i < 128) return static_cast<uint8_t>(i + 128);
        if (i < 512) return 255;
        if (i < 896) return 0;
        return static_cast<uint8_t>(i - 896);
    }

    static void idct_islow(const int16_t* coef, const uint16_t* q, uint8_t* out, int stride) {
        constexpr int CONST_BITS = 13, PASS1_BITS = 2;
        constexpr int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270,
                          F0899 = 7373, F1175 = 9633, F1501 = 12299, F1847 = 15137,
                          F1961 = 16069, F2053 = 16819, F2562 = 20995, F3072 = 25172;
        auto descale = [](int64_t x, int n) { return (x + (int64_t(1) << (n - 1))) >> n; };
        int ws[64];
        for (int c = 0; c < 8; ++c) {
            const int16_t* in = coef + c;
            const uint16_t* qp = q + c;
            int* w = ws + c;
            auto dq = [&](int r) { return int64_t(in[8 * r]) * int64_t(qp[8 * r]); };
            if (in[8] == 0 && in[16] == 0 && in[24] == 0 && in[32] == 0 && in[40] == 0 &&
                in[48] == 0 && in[56] == 0) {
                int dcval = static_cast<int>(dq(0) * (1 << PASS1_BITS));
                for (int r = 0; r < 8; ++r) w[8 * r] = dcval;
                continue;
            }
            int64_t z2 = dq(2), z3 = dq(6);
            int64_t z1 = (z2 + z3) * F0541;
            int64_t tmp2 = z1 + z3 * -F1847;
            int64_t tmp3 = z1 + z2 * F0765;
            z2 = dq(0);
            z3 = dq(4);
            int64_t tmp0 = (z2 + z3) * (int64_t(1) << CONST_BITS);
            int64_t tmp1 = (z2 - z3) * (int64_t(1) << CONST_BITS);
            int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
            int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
            tmp0 = dq(7);
            tmp1 = dq(5);
            tmp2 = dq(3);
            tmp3 = dq(1);
            z1 = tmp0 + tmp3;
            z2 = tmp1 + tmp2;
            z3 = tmp0 + tmp2;
            int64_t z4 = tmp1 + tmp3;
            int64_t z5 = (z3 + z4) * F1175;
            tmp0 *= F0298;
            tmp1 *= F2053;
            tmp2 *= F3072;
            tmp3 *= F1501;
            z1 *= -F0899;
            z2 *= -F2562;
            z3 *= -F1961;
            z4 *= -F0390;
            z3 += z5;
            z4 += z5;
            tmp0 += z1 + z3;
            tmp1 += z2 + z4;
            tmp2 += z2 + z3;
            tmp3 += z1 + z4;
            constexpr int n = CONST_BITS - PASS1_BITS;
            w[0] = static_cast<int>(descale(tmp10 + tmp3, n));
            w[56] = static_cast<int>(descale(tmp10 - tmp3, n));
            w[8] = static_cast<int>(descale(tmp11 + tmp2, n));
            w[48] = static_cast<int>(descale(tmp11 - tmp2, n));
            w[16] = static_cast<int>(descale(tmp12 + tmp1, n));
            w[40] = static_cast<int>(descale(tmp12 - tmp1, n));
            w[24] = static_cast<int>(descale(tmp13 + tmp0, n));
            w[32] = static_cast<int>(descale(tmp13 - tmp0, n));
        }
        for (int r = 0; r < 8; ++r) {
            const int* w = ws + 8 * r;
            uint8_t* o = out + r * stride;
            constexpr int n = CONST_BITS + PASS1_BITS + 3;
            if (w[1] == 0 && w[2] == 0 && w[3] == 0 && w[4] == 0 && w[5] == 0 && w[6] == 0 &&
                w[7] == 0) {
                uint8_t dcval = range_limit(descale(w[0], PASS1_BITS + 3));
                for (int c = 0; c < 8; ++c) o[c] = dcval;
                continue;
            }
            int64_t z2 = w[2], z3 = w[6];
            int64_t z1 = (z2 + z3) * F0541;
            int64_t tmp2 = z1 + z3 * -F1847;
            int64_t tmp3 = z1 + z2 * F0765;
            int64_t tmp0 = (int64_t(w[0]) + w[4]) * (int64_t(1) << CONST_BITS);
            int64_t tmp1 = (int64_t(w[0]) - w[4]) * (int64_t(1) << CONST_BITS);
            int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
            int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
            tmp0 = w[7];
            tmp1 = w[5];
            tmp2 = w[3];
            tmp3 = w[1];
            z1 = tmp0 + tmp3;
            z2 = tmp1 + tmp2;
            z3 = tmp0 + tmp2;
            int64_t z4 = tmp1 + tmp3;
            int64_t z5 = (z3 + z4) * F1175;
            tmp0 *= F0298;
            tmp1 *= F2053;
            tmp2 *= F3072;
            tmp3 *= F1501;
            z1 *= -F0899;
            z2 *= -F2562;
            z3 *= -F1961;
            z4 *= -F0390;
            z3 += z5;
            z4 += z5;
            tmp0 += z1 + z3;
            tmp1 += z2 + z4;
            tmp2 += z2 + z3;
            tmp3 += z1 + z4;
            o[0] = range_limit(descale(tmp10 + tmp3, n));
            o[7] = range_limit(descale(tmp10 - tmp3, n));
            o[1] = range_limit(descale(tmp11 + tmp2, n));
            o[6] = range_limit(descale(tmp11 - tmp2, n));
            o[2] = range_limit(descale(tmp12 + tmp1, n));
            o[5] = range_limit(descale(tmp12 - tmp1, n));
            o[3] = range_limit(descale(tmp13 + tmp0, n));
            o[4] = range_limit(descale(tmp13 - tmp0, n));
        }
    }

    // ------------------------------------------------------------- scans
    int last_dc[4] = {0, 0, 0, 0};

    void decode_block(Component& c, int bx, int by, int ci) {
        int16_t coef[64];
        std::memset(coef, 0, sizeof(coef));
        int s = decode(dc[c.dc_table]);
        if (s > 16) malformed("a DC difference of more than 16 bits");
        int diff = s ? extend(get_bits(s), s) : 0;
        last_dc[ci] += diff;
        coef[0] = static_cast<int16_t>(last_dc[ci]);
        const Huffman& t = ac[c.ac_table];
        for (int k = 1; k < 64; ++k) {
            int rs = decode(t);
            int r = rs >> 4;
            s = rs & 15;
            if (s) {
                k += r;  // at most 78: kNaturalOrder's padding takes a corrupt run
                coef[kNaturalOrder[k]] = static_cast<int16_t>(extend(get_bits(s), s));
            } else {
                if (r != 15) break;
                k += 15;
            }
        }
        const size_t stride = static_cast<size_t>(c.blocks_w) * 8;
        idct_islow(coef, qt[c.tq], c.plane.data() + static_cast<size_t>(by) * 8 * stride + bx * 8,
                   static_cast<int>(stride));
    }

    void read_scan() {
        if (!frame) malformed("a scan before its frame header");
        int ns = byte();
        if (ns < 1 || ns > ncomp) malformed("bad scan component count");
        int idx[4];
        for (int i = 0; i < ns; ++i) {
            int id = byte();
            int tables = byte();
            int found = -1;
            for (int j = 0; j < ncomp; ++j)
                if (comp[j].id == id) found = j;
            if (found < 0) malformed("a scan names an unknown component");
            idx[i] = found;
            Component& c = comp[found];
            c.dc_table = tables >> 4;
            c.ac_table = tables & 15;
            if (c.dc_table > 3 || c.ac_table > 3 || !dc[c.dc_table].defined ||
                !ac[c.ac_table].defined)
                malformed("a scan uses an undefined Huffman table");
            if (!qt_defined[c.tq]) malformed("a component uses an undefined DQT table");
            c.seen = true;
        }
        int ss = byte(), se = byte(), ahal = byte();
        if (ss != 0 || se != 63 || ahal != 0) malformed("bad spectral selection for a sequential scan");
        for (int i = 0; i < 4; ++i) last_dc[i] = 0;
        bitbuf = 0;
        bitcount = 0;
        hit_marker = false;

        long units, units_x;
        if (ns == 1) {  // non-interleaved: one block an MCU, over the real samples only
            Component& c = comp[idx[0]];
            units_x = (c.width + 7) / 8;
            units = units_x * ((c.height + 7) / 8);
        } else {
            units_x = mcux;
            units = static_cast<long>(mcux) * mcuy;
        }
        int togo = restart_interval;
        for (long u = 0; u < units; ++u) {
            if (restart_interval) {
                if (togo == 0) {
                    restart();
                    for (int i = 0; i < 4; ++i) last_dc[i] = 0;
                    togo = restart_interval;
                }
                --togo;
            }
            int ux = static_cast<int>(u % units_x), uy = static_cast<int>(u / units_x);
            if (ns == 1) {
                decode_block(comp[idx[0]], ux, uy, idx[0]);
            } else {
                for (int i = 0; i < ns; ++i) {
                    Component& c = comp[idx[i]];
                    for (int v = 0; v < c.v; ++v)
                        for (int h = 0; h < c.h; ++h)
                            decode_block(c, ux * c.h + h, uy * c.v + v, idx[i]);
                }
            }
        }
        // drop the rest of the entropy-coded segment up to the next marker
        while (pos + 1 < size && !(data[pos] == 0xFF && data[pos + 1] != 0x00 &&
                                   !(data[pos + 1] >= 0xD0 && data[pos + 1] <= 0xD7)))
            ++pos;
    }

    // the headers, then (unless headers_only) every scan
    void parse(bool headers_only) {
        if (size < 4 || data[0] != 0xFF || data[1] != 0xD8) malformed("not a JPEG file (no SOI)");
        pos = 2;
        bool scanned = false;
        for (;;) {
            int m = next_marker();
            if (m == 0xD9) break;  // EOI
            if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7) || m == 0x01) continue;
            int len = u16();
            if (len < 2 || pos + len - 2 > size) malformed("a marker segment runs past the file");
            size_t end = pos + len - 2;
            if (m == 0xDB) {
                read_dqt(end);
            } else if (m == 0xC4) {
                read_dht(end);
            } else if (m == 0xDD) {
                restart_interval = u16();
            } else if (m == 0xCC) {
                unsupported("arithmetic coding (DAC)");
            } else if (m >= 0xC0 && m <= 0xCF) {
                if (m == 0xC2 || m == 0xC6 || m == 0xCA || m == 0xCE)
                    unsupported("a progressive JPEG");
                read_sof(m);
                if (headers_only) {
                    check_colour_space();
                    return;
                }
            } else if (m == 0xDA) {
                read_scan();
                scanned = true;
                continue;  // read_scan leaves pos at the next marker
            } else if (m == 0xE0 && len >= 7 && std::memcmp(data + pos, "JFIF\0", 5) == 0) {
                saw_jfif = true;
            } else if (m == 0xEE && len >= 14 && std::memcmp(data + pos, "Adobe", 5) == 0) {
                saw_adobe = true;
                adobe_transform = data[pos + 11];
            }
            pos = end;
            if (pos > size) malformed("a marker segment runs past the file");
        }
        if (!scanned) malformed("no scan before EOI");
        for (int i = 0; i < ncomp; ++i)
            if (!comp[i].seen) malformed("a component that no scan codes");
        check_colour_space();
    }

    void check_colour_space() const {
        if (ncomp == 3) {
            // jdapimin.c default_decompress_parms: which colour space the file is in
            bool rgb;
            if (saw_jfif) rgb = false;
            else if (saw_adobe) rgb = adobe_transform == 0;
            else rgb = comp[0].id == 'R' && comp[1].id == 'G' && comp[2].id == 'B';
            if (rgb) unsupported("an RGB-coded 3-component JPEG");
        }
    }

    // ------------------------------------------------- upsample and colour
    // the component at full size, rows of `width` samples (jdsample.c)
    std::vector<uint8_t> full_size(const Component& c) const {
        std::vector<uint8_t> out(static_cast<size_t>(width) * height);
        const size_t stride = static_cast<size_t>(c.blocks_w) * 8;
        const uint8_t* p = c.plane.data();
        if (c.h == hmax && c.v == vmax) {
            for (int y = 0; y < height; ++y)
                std::memcpy(&out[static_cast<size_t>(y) * width], p + y * stride, width);
            return out;
        }
        const bool h2 = 2 * c.h == hmax;
        const bool v1 = c.v == vmax, v2 = 2 * c.v == vmax;
        if (!h2 || !(v1 || v2)) unsupported("a sampling layout other than 4:4:4, 4:2:2 or 4:2:0");
        const int dw = c.width, dh = c.height;
        std::vector<int> row(2 * dw);
        std::vector<int> colsum(dw);
        for (int y = 0; y < height; ++y) {
            int* o = row.data();
            if (dw <= 2) {  // box replication (h2v1_upsample / h2v2_upsample)
                const uint8_t* in = p + (v2 ? y / 2 : y) * stride;
                for (int x = 0; x < dw; ++x) o[2 * x] = o[2 * x + 1] = in[x];
            } else if (v1) {  // h2v1_fancy_upsample
                const uint8_t* in = p + y * stride;
                for (int x = 0; x < dw; ++x) {
                    int cur = in[x] * 3;
                    int left = in[x > 0 ? x - 1 : 0], right = in[x < dw - 1 ? x + 1 : dw - 1];
                    o[2 * x] = (cur + left + 1) >> 2;
                    o[2 * x + 1] = (cur + right + 2) >> 2;
                }
            } else {  // h2v2_fancy_upsample: 3/4 nearer row + 1/4 further row, then columns
                int i = y / 2;
                int nb = (y & 1) ? (i + 1 < dh ? i + 1 : dh - 1) : (i > 0 ? i - 1 : 0);
                const uint8_t* in0 = p + i * stride;
                const uint8_t* in1 = p + nb * stride;
                for (int x = 0; x < dw; ++x) colsum[x] = in0[x] * 3 + in1[x];
                for (int x = 0; x < dw; ++x) {
                    int cur = colsum[x] * 3;
                    int left = colsum[x > 0 ? x - 1 : 0];
                    int right = colsum[x < dw - 1 ? x + 1 : dw - 1];
                    o[2 * x] = (cur + left + 8) >> 4;
                    o[2 * x + 1] = (cur + right + 7) >> 4;
                }
            }
            uint8_t* dst = &out[static_cast<size_t>(y) * width];
            for (int x = 0; x < width; ++x) dst[x] = static_cast<uint8_t>(o[x]);
        }
        return out;
    }

    void output(uint8_t* out) const {
        if (ncomp == 1) {
            std::vector<uint8_t> g = full_size(comp[0]);
            std::memcpy(out, g.data(), g.size());
            return;
        }
        std::vector<uint8_t> yy = full_size(comp[0]), cb = full_size(comp[1]),
                             cr = full_size(comp[2]);
        // jdcolor.c build_ycc_rgb_table
        constexpr int SCALEBITS = 16;
        constexpr int64_t ONE_HALF = int64_t(1) << (SCALEBITS - 1);
        auto fix = [](double x) { return static_cast<int64_t>(x * (1L << SCALEBITS) + 0.5); };
        int cr_r[256], cb_b[256];
        int64_t cr_g[256], cb_g[256];
        for (int i = 0, x = -128; i < 256; ++i, ++x) {
            cr_r[i] = static_cast<int>((fix(1.40200) * x + ONE_HALF) >> SCALEBITS);
            cb_b[i] = static_cast<int>((fix(1.77200) * x + ONE_HALF) >> SCALEBITS);
            cr_g[i] = -fix(0.71414) * x;
            cb_g[i] = -fix(0.34414) * x + ONE_HALF;
        }
        auto clamp = [](int v) { return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v)); };
        const size_t n = static_cast<size_t>(width) * height;
        for (size_t i = 0; i < n; ++i) {
            int y = yy[i], b = cb[i], r = cr[i];
            out[3 * i] = clamp(y + cr_r[r]);
            out[3 * i + 1] = clamp(y + static_cast<int>((cb_g[b] + cr_g[r]) >> SCALEBITS));
            out[3 * i + 2] = clamp(y + cb_b[b]);
        }
    }
};

void set_error(char* err, size_t cap, const std::string& what) {
    if (err && cap) std::snprintf(err, cap, "%s", what.c_str());
}

}  // namespace

extern "C" {

// Decode the JPEG in data[0:size]. dims[0..2] receive height, width and
// channels (1 grey, 3 RGB). With out == NULL only the headers up to the
// frame header are read and the call returns 3 (sizes known, nothing
// written); otherwise out must hold height*width*channels bytes, and the
// call returns 0 when the pixels are written (row-major, channels last).
// A file it does not read returns 1, a malformed file 2 (or an out_cap
// too small); err receives a message.
int ddgan_jpeg_decode(const uint8_t* data, size_t size, uint8_t* out, size_t out_cap,
                      int64_t* dims, char* err, size_t err_cap) {
    try {
        Decoder d(data, size);
        d.parse(out == nullptr);
        dims[0] = d.height;
        dims[1] = d.width;
        dims[2] = d.ncomp;
        if (out == nullptr) return 3;
        if (out_cap < static_cast<size_t>(d.height) * d.width * d.ncomp)
            malformed("the output buffer is smaller than the image");
        d.output(out);
        return 0;
    } catch (const Failure& f) {
        set_error(err, err_cap, f.what);
        return f.code;
    } catch (const std::exception& e) {
        set_error(err, err_cap, e.what());
        return kMalformed;
    }
}

}  // extern "C"
