// JPEG decoder with libjpeg-turbo's arithmetic, behind a plain C interface
// (bound with ctypes by ddgan_torch/data/jpeg.py).
//
// It gives the pixels that PIL's `Image.open(f)` gives (libjpeg-turbo with
// its defaults: the ISLOW integer IDCT and fancy upsampling) for the files
// it reads:
//   * 8-bit samples, in sequential Huffman (SOF0 / SOF1), progressive
//     Huffman (SOF2), sequential arithmetic (SOF9) or progressive
//     arithmetic (SOF10) coding: one interleaved scan, one scan per
//     component, or any progressive scan script (DC first and refine, AC
//     first and refine with EOB runs, successive approximation), the
//     coefficients gathered over every scan before the IDCT;
//   * DQT tables of 8 or 16 bits, DHT tables, DAC conditioning, DRI with
//     RST markers (the arithmetic statistics reset at each);
//   * 1 component (grey); 3 in YCbCr, or RGB-coded (an Adobe marker with
//     transform 0, or component IDs 'R', 'G', 'B', as jdapimin.c decides),
//     which take no colour transform; 4 in CMYK or YCCK (Adobe transform
//     0 or 2), returned inverted as PIL's "CMYK;I" raw mode returns them;
//     or, as libtiff asks for a JPEG-in-TIFF strip, its components as they
//     are (JCS_UNKNOWN) or YCbCr converted to RGB whatever the markers say;
//   * each component at any integral fraction of the largest sampling
//     across and down, as jdsample.c upsamples it: 4:4:4, 4:2:2, 4:2:0,
//     4:4:0 (h1v2), true 4:1:1 (h4v1), 4:1:0, 3x1 and the rest;
//   * any width and height, multiples of the MCU or not;
//   * lossless files (SOF3, Huffman-coded) at 8 bits with every component
//     at 1x1: predictors 1-7, any point transform, restart intervals of
//     whole rows, as jdlhuff.c, jdpred.c and jdlossls.c decode them (each
//     scan's first row, and the first after each restart, predicted from
//     the left, its first sample from 2^(7 - Pt); the samples shifted back
//     left by Pt into 8 bits); with no colour conversion, which
//     libjpeg-turbo refuses in lossless mode (a JFIF or YCbCr Adobe marker
//     on three components is refused here too).
// Arithmetic-coded lossless (SOF11), hierarchical (SOF5-7, SOF13-15) and
// 12-bit files, subsampled lossless components, other
// component counts, non-integral sampling ratios (libjpeg refuses them
// too), and a progressive file whose scans
// leave one of its first ten coefficients short of bit 0 (libjpeg-turbo
// smooths such blocks, jdcoefct.c decompress_smooth_data) are refused
// (return code 1); malformed files return 2.
//
// The arithmetic is libjpeg-turbo's, step for step:
//   * jdhuff.c / jdphuff.c for Huffman, jdarith.c for arithmetic decoding
//     (with T.81 Table D.2's Qe table, jaricom.c's jpeg_aritab);
//   * jidctint.c's jpeg_idct_islow: CONST_BITS 13, PASS1_BITS 2, int64
//     products, the post-IDCT range-limit table indexed with RANGE_MASK.
//     (libjpeg-turbo's SIMD IDCT saturates where the table wraps; the two
//     agree while a sample stays within -512..511 of the center, which
//     every output of a real image does.)
//   * jdsample.c's h2v1 / h2v2 fancy upsampling (the triangle filter with
//     its alternating rounding bias, the first and last sample rows
//     replicated at the component's real height), used when the
//     component's width is above 2 samples, otherwise box replication;
//     h1v2_fancy_upsample (3/4 of the nearer row and 1/4 of the further,
//     biases 1 and 2) at any width; int_upsample's box replication for
//     every other integral ratio.
//   * jdcolor.c's YCbCr -> RGB tables (SCALEBITS 16), and its YCCK -> CMYK
//     (255 minus the RGB of Y, Cb, Cr, clamped; K as it is).
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
// the colour space: as the file's markers say (jdapimin.c), the components
// as they are (JCS_UNKNOWN), YCbCr to RGB (libtiff's JPEGCOLORMODE_RGB), or
// the components as they are, each replicated to full size (libjpeg's raw
// data, as libtiff's old-style JPEG codec hands it to TIFFRGBAImage)
constexpr int kAsFile = 0, kRaw = 1, kYCbCr = 2, kBox = 3;

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

// T.81 Table D.2 as jaricom.c packs it: Qe << 16 | Next_Index_MPS << 8 |
// Switch_MPS << 7 | Next_Index_LPS; entry 113 is the fixed bin (Qe 0x5a1d)
const int64_t kAritab[114] = {
    0x5a1d0181, 0x2586020e, 0x11140310, 0x080b0412, 0x03d80514, 0x01da0617, 0x00e50719,
    0x006f081c, 0x0036091e, 0x001a0a21, 0x000d0b23, 0x00060c09, 0x00030d0a, 0x00010d0c,
    0x5a7f0f8f, 0x3f251024, 0x2cf21126, 0x207c1227, 0x17b91328, 0x1182142a, 0x0cef152b,
    0x09a1162d, 0x072f172e, 0x055c1830, 0x04061931, 0x03031a33, 0x02401b34, 0x01b11c36,
    0x01441d38, 0x00f51e39, 0x00b71f3b, 0x008a203c, 0x0068213e, 0x004e223f, 0x003b2320,
    0x002c0921, 0x5ae125a5, 0x484c2640, 0x3a0d2741, 0x2ef12843, 0x261f2944, 0x1f332a45,
    0x19a82b46, 0x15182c48, 0x11772d49, 0x0e742e4a, 0x0bfb2f4b, 0x09f8304d, 0x0861314e,
    0x0706324f, 0x05cd3330, 0x04de3432, 0x040f3532, 0x03633633, 0x02d43734, 0x025c3835,
    0x01f83936, 0x01a43a37, 0x01603b38, 0x01253c39, 0x00f63d3a, 0x00cb3e3b, 0x00ab3f3d,
    0x008f203d, 0x5b1241c1, 0x4d044250, 0x412c4351, 0x37d84452, 0x2fe84553, 0x293c4654,
    0x23794756, 0x1edf4857, 0x1aa94957, 0x174e4a48, 0x14244b48, 0x119c4c4a, 0x0f6b4d4a,
    0x0d514e4b, 0x0bb64f4d, 0x0a40304d, 0x583251d0, 0x4d1c5258, 0x438e5359, 0x3bdd545a,
    0x34ee555b, 0x2eae565c, 0x299a575d, 0x25164756, 0x557059d8, 0x4ca95a5f, 0x44d95b60,
    0x3e225c61, 0x38245d63, 0x32b45e63, 0x2e17565d, 0x56a860df, 0x4f466165, 0x47e56266,
    0x41cf6367, 0x3c3d6468, 0x375e5d63, 0x52316669, 0x4c0f676a, 0x4639686b, 0x415e6367,
    0x56276ae9, 0x50e76b6c, 0x4b85676d, 0x55976d6e, 0x504f6b6f, 0x5a106fee, 0x55226d70,
    0x59eb6ff0, 0x5a1d7171};

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
    std::vector<int16_t> coef;         // progressive: every block's 64 coefficients
    uint16_t q[64];                    // the DQT table latched at its first scan
    int coef_bits[64];                 // progressive: the last Al of each coefficient
    bool seen = false;
};

struct Decoder {
    const uint8_t* data;
    size_t size;
    size_t pos = 0;

    uint16_t qt[4][64];  // natural order
    bool qt_defined[4] = {false, false, false, false};
    Huffman dc[4], ac[4];
    uint8_t arith_dc_L[16], arith_dc_U[16], arith_ac_K[16];
    int restart_interval = 0;
    bool saw_jfif = false, saw_adobe = false;
    int adobe_transform = -1;

    int width = 0, height = 0, ncomp = 0, hmax = 1, vmax = 1;
    int mcux = 0, mcuy = 0;
    bool progressive = false, arithmetic = false, lossless = false;
    Component comp[4];
    bool frame = false;

    Decoder(const uint8_t* d, size_t n) : data(d), size(n) {
        for (int i = 0; i < 16; ++i) {  // jdarith.c / jdmaster.c defaults
            arith_dc_L[i] = 0;
            arith_dc_U[i] = 1;
            arith_ac_K[i] = 5;
        }
    }

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

    // jdmarker.c get_dac
    void read_dac(size_t end) {
        while (pos < end) {
            int index = byte(), val = byte();
            if (index >= 32) malformed("a DAC table index past 31");
            if (index >= 16) {
                arith_ac_K[index - 16] = static_cast<uint8_t>(val);
            } else {
                arith_dc_L[index] = static_cast<uint8_t>(val & 15);
                arith_dc_U[index] = static_cast<uint8_t>(val >> 4);
                if (arith_dc_L[index] > arith_dc_U[index]) malformed("a DAC DC value with L > U");
            }
        }
    }

    void read_sof(int marker) {
        if (frame) malformed("two frames in one file");
        int precision = byte();
        height = u16();
        width = u16();
        ncomp = byte();
        if (marker == 0xCB) unsupported("an arithmetic-coded lossless JPEG");
        lossless = marker == 0xC3;
        if ((marker >= 0xC5 && marker <= 0xC7) || marker >= 0xCD)
            unsupported("a hierarchical JPEG");
        progressive = marker == 0xC2 || marker == 0xCA;
        arithmetic = marker >= 0xC9;
        if (precision != 8) unsupported(std::to_string(precision) + "-bit samples");
        if (height == 0) unsupported("a height given by a DNL marker");
        if (width == 0) malformed("width 0");
        if (static_cast<int64_t>(width) * height > (int64_t(1) << 28))
            malformed("an image of more than 2^28 pixels");
        if (ncomp != 1 && ncomp != 3 && ncomp != 4)
            unsupported(std::to_string(ncomp) + " components");
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
        if (lossless && (hmax != 1 || vmax != 1))
            unsupported("a lossless JPEG with subsampled components");
        mcux = (width + 8 * hmax - 1) / (8 * hmax);
        mcuy = (height + 8 * vmax - 1) / (8 * vmax);
        for (int i = 0; i < ncomp; ++i) {
            Component& c = comp[i];
            c.width = (width * c.h + hmax - 1) / hmax;
            c.height = (height * c.v + vmax - 1) / vmax;
            c.blocks_w = mcux * c.h;
            c.blocks_h = mcuy * c.v;
            for (int k = 0; k < 64; ++k) c.coef_bits[k] = -1;
        }
        frame = true;
    }

    // planes (and, for a progressive file, coefficients) once the frame
    // header has passed the checks of a headers-only call
    void allocate() {
        for (int i = 0; i < ncomp; ++i) {
            Component& c = comp[i];
            const size_t blocks = static_cast<size_t>(c.blocks_w) * c.blocks_h;
            c.plane.assign(blocks * 64, 0);
            if (progressive) c.coef.assign(blocks * 64, 0);
        }
    }

    // ------------------------------------------------- Huffman bit reader
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

    // --------------------------------------------- arithmetic decoder
    // jdarith.c: the C and A registers, the bit shift counter, a marker met
    int64_t ac_c = 0, ac_a = 0;
    int ac_ct = -16;
    int unread_marker = 0;
    size_t marker_pos = 0;  // where the 0xFF of the unread marker is
    uint8_t dc_stats[16][64], ac_stats[16][256];
    uint8_t fixed_bin[4] = {113, 0, 0, 0};
    int dc_context[4] = {0, 0, 0, 0};

    int arith_byte() {
        if (unread_marker) return 0;
        if (pos >= size) malformed("the file ends inside its entropy-coded data");
        int d = data[pos++];
        if (d == 0xFF) {
            size_t ff = pos - 1;
            do {
                if (pos >= size) malformed("the file ends inside its entropy-coded data");
                d = data[pos++];
                if (d == 0xFF) ff = pos - 1;
            } while (d == 0xFF);
            if (d == 0) return 0xFF;  // a stuffed zero
            unread_marker = d;  // a marker: zeros from here on
            marker_pos = ff;
            return 0;
        }
        return d;
    }

    int arith_decode(uint8_t* st) {
        while (ac_a < 0x8000) {  // renormalisation and input, section D.2.6
            if (--ac_ct < 0) {
                ac_c = (ac_c << 8) | arith_byte();
                if ((ac_ct += 8) < 0) {
                    if (++ac_ct == 0) ac_a = 0x8000;  // the two initial bytes are in
                }
            }
            ac_a <<= 1;
        }
        int sv = *st;
        int64_t qe = kAritab[sv & 0x7F];
        int nl = static_cast<int>(qe & 0xFF);
        qe >>= 8;
        int nm = static_cast<int>(qe & 0xFF);
        qe >>= 8;
        int64_t temp = ac_a - qe;
        ac_a = temp;
        temp <<= ac_ct;
        if (ac_c >= temp) {
            ac_c -= temp;
            if (ac_a < qe) {
                ac_a = qe;
                *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
            } else {
                ac_a = qe;
                *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
                sv ^= 0x80;
            }
        } else if (ac_a < 0x8000) {
            if (ac_a < qe) {
                *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
                sv ^= 0x80;
            } else {
                *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
            }
        }
        return sv >> 7;
    }

    // a DC difference (figures F.19-F.24); updates the component's context
    int arith_dc_diff(int tbl, int ci) {
        uint8_t* st = dc_stats[tbl] + dc_context[ci];
        if (arith_decode(st) == 0) {
            dc_context[ci] = 0;
            return 0;
        }
        int sign = arith_decode(st + 1);
        st += 2 + sign;
        int m = arith_decode(st);
        if (m != 0) {
            st = dc_stats[tbl] + 20;
            while (arith_decode(st)) {
                if ((m <<= 1) == 0x8000) malformed("an arithmetic-coded magnitude overflows");
                st += 1;
            }
        }
        if (m < static_cast<int>((1L << arith_dc_L[tbl]) >> 1))
            dc_context[ci] = 0;
        else if (m > static_cast<int>((1L << arith_dc_U[tbl]) >> 1))
            dc_context[ci] = 12 + sign * 4;
        else
            dc_context[ci] = 4 + sign * 4;
        int v = m;
        st += 14;
        while (m >>= 1)
            if (arith_decode(st)) v |= m;
        v += 1;
        return sign ? -v : v;
    }

    // an AC value's sign, category and magnitude from bin S0 + 2 (st) on
    int arith_ac_value(int tbl, int k, uint8_t* st) {
        int sign = arith_decode(fixed_bin);
        st += 2;
        int m = arith_decode(st);
        if (m != 0) {
            if (arith_decode(st)) {
                m <<= 1;
                st = ac_stats[tbl] + (k <= arith_ac_K[tbl] ? 189 : 217);
                while (arith_decode(st)) {
                    if ((m <<= 1) == 0x8000) malformed("an arithmetic-coded magnitude overflows");
                    st += 1;
                }
            }
        }
        int v = m;
        st += 14;
        while (m >>= 1)
            if (arith_decode(st)) v |= m;
        v += 1;
        return sign ? -v : v;
    }

    void arith_reset() {
        ac_c = 0;
        ac_a = 0;
        ac_ct = -16;
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
    int eobrun = 0;
    int scan_ns = 0, scan_idx[4] = {0, 0, 0, 0};
    int ss = 0, se = 63, ah = 0, al = 0;

    int16_t* coef_at(Component& c, int bx, int by) {
        return c.coef.data() + (static_cast<size_t>(by) * c.blocks_w + bx) * 64;
    }

    void idct_block(Component& c, const int16_t* coef, int bx, int by) {
        const size_t stride = static_cast<size_t>(c.blocks_w) * 8;
        idct_islow(coef, c.q, c.plane.data() + static_cast<size_t>(by) * 8 * stride + bx * 8,
                   static_cast<int>(stride));
    }

    // a sequential block, Huffman-coded (jdhuff.c decode_mcu), then its IDCT
    void huff_block(Component& c, int bx, int by, int ci) {
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
        idct_block(c, coef, bx, by);
    }

    // a sequential block, arithmetic-coded (jdarith.c decode_mcu)
    void arith_block(Component& c, int bx, int by, int ci) {
        int16_t coef[64];
        std::memset(coef, 0, sizeof(coef));
        last_dc[ci] = (last_dc[ci] + arith_dc_diff(c.dc_table, ci)) & 0xFFFF;
        coef[0] = static_cast<int16_t>(last_dc[ci]);
        const int tbl = c.ac_table;
        int k = 0;
        do {
            uint8_t* st = ac_stats[tbl] + 3 * k;
            if (arith_decode(st)) break;  // EOB
            for (;;) {
                k++;
                if (arith_decode(st + 1)) break;
                st += 3;
                if (k >= 63) malformed("an arithmetic-coded block runs past 63 coefficients");
            }
            coef[kNaturalOrder[k]] = static_cast<int16_t>(arith_ac_value(tbl, k, st));
        } while (k < 63);
        idct_block(c, coef, bx, by);
    }

    // progressive Huffman, jdphuff.c: the four kinds of scan
    void huff_dc_first(Component& c, int bx, int by, int ci) {
        int s = decode(dc[c.dc_table]);
        if (s > 16) malformed("a DC difference of more than 16 bits");
        int diff = s ? extend(get_bits(s), s) : 0;
        last_dc[ci] += diff;
        coef_at(c, bx, by)[0] = static_cast<int16_t>(static_cast<unsigned>(last_dc[ci]) << al);
    }

    void huff_dc_refine(Component& c, int bx, int by) {
        if (get_bits(1)) coef_at(c, bx, by)[0] |= static_cast<int16_t>(1 << al);
    }

    void huff_ac_first(Component& c, int bx, int by) {
        if (eobrun > 0) {
            --eobrun;
            return;
        }
        int16_t* coef = coef_at(c, bx, by);
        const Huffman& t = ac[c.ac_table];
        for (int k = ss; k <= se; ++k) {
            int rs = decode(t);
            int r = rs >> 4, s = rs & 15;
            if (s) {
                k += r;
                coef[kNaturalOrder[k]] =
                    static_cast<int16_t>(static_cast<unsigned>(extend(get_bits(s), s)) << al);
            } else if (r == 15) {
                k += 15;
            } else {
                eobrun = 1 << r;
                if (r) eobrun += get_bits(r);
                --eobrun;
                break;
            }
        }
    }

    void huff_ac_refine(Component& c, int bx, int by) {
        int16_t* coef = coef_at(c, bx, by);
        const int p1 = 1 << al, m1 = -1 * (1 << al);
        const Huffman& t = ac[c.ac_table];
        int k = ss;
        if (eobrun == 0) {
            for (; k <= se; ++k) {
                int rs = decode(t);
                int r = rs >> 4, s = rs & 15;
                if (s) {
                    s = get_bits(1) ? p1 : m1;  // a size other than 1 is corrupt: libjpeg warns
                } else if (r != 15) {
                    eobrun = 1 << r;
                    if (r) eobrun += get_bits(r);
                    break;
                }
                do {
                    int16_t* tc = coef + kNaturalOrder[k];
                    if (*tc != 0) {
                        if (get_bits(1) && (*tc & p1) == 0)
                            *tc = static_cast<int16_t>(*tc >= 0 ? *tc + p1 : *tc + m1);
                    } else {
                        if (--r < 0) break;
                    }
                    ++k;
                } while (k <= se);
                if (s) coef[kNaturalOrder[k]] = static_cast<int16_t>(s);
            }
        }
        if (eobrun > 0) {
            for (; k <= se; ++k) {
                int16_t* tc = coef + kNaturalOrder[k];
                if (*tc != 0 && get_bits(1) && (*tc & p1) == 0)
                    *tc = static_cast<int16_t>(*tc >= 0 ? *tc + p1 : *tc + m1);
            }
            --eobrun;
        }
    }

    // progressive arithmetic, jdarith.c: the four kinds of scan
    void arith_dc_first(Component& c, int bx, int by, int ci) {
        last_dc[ci] += arith_dc_diff(c.dc_table, ci);
        coef_at(c, bx, by)[0] = static_cast<int16_t>(static_cast<unsigned>(last_dc[ci]) << al);
    }

    void arith_dc_refine(Component& c, int bx, int by) {
        if (arith_decode(fixed_bin)) coef_at(c, bx, by)[0] |= static_cast<int16_t>(1 << al);
    }

    void arith_ac_first(Component& c, int bx, int by) {
        int16_t* coef = coef_at(c, bx, by);
        const int tbl = c.ac_table;
        for (int k = ss; k <= se; ++k) {
            uint8_t* st = ac_stats[tbl] + 3 * (k - 1);
            if (arith_decode(st)) break;  // EOB
            while (arith_decode(st + 1) == 0) {
                st += 3;
                if (++k > se) malformed("an arithmetic-coded band runs past its end");
            }
            int v = arith_ac_value(tbl, k, st);
            coef[kNaturalOrder[k]] = static_cast<int16_t>(static_cast<unsigned>(v) << al);
        }
    }

    void arith_ac_refine(Component& c, int bx, int by) {
        int16_t* coef = coef_at(c, bx, by);
        const int tbl = c.ac_table;
        const int p1 = 1 << al, m1 = -1 * (1 << al);
        int kex = se;
        for (; kex > 0; --kex)
            if (coef[kNaturalOrder[kex]]) break;
        for (int k = ss; k <= se; ++k) {
            uint8_t* st = ac_stats[tbl] + 3 * (k - 1);
            if (k > kex && arith_decode(st)) break;  // EOB
            for (;;) {
                int16_t* tc = coef + kNaturalOrder[k];
                if (*tc) {
                    if (arith_decode(st + 2))
                        *tc = static_cast<int16_t>(*tc < 0 ? *tc + m1 : *tc + p1);
                    break;
                }
                if (arith_decode(st + 1)) {
                    *tc = static_cast<int16_t>(arith_decode(fixed_bin) ? m1 : p1);
                    break;
                }
                st += 3;
                if (++k > se) malformed("an arithmetic-coded band runs past its end");
            }
        }
    }

    void decode_unit(Component& c, int bx, int by, int ci) {
        if (!progressive) {
            if (arithmetic) arith_block(c, bx, by, ci);
            else huff_block(c, bx, by, ci);
        } else if (ss == 0) {
            if (ah == 0) {
                if (arithmetic) arith_dc_first(c, bx, by, ci);
                else huff_dc_first(c, bx, by, ci);
            } else if (arithmetic) {
                arith_dc_refine(c, bx, by);
            } else {
                huff_dc_refine(c, bx, by);
            }
        } else if (ah == 0) {
            if (arithmetic) arith_ac_first(c, bx, by);
            else huff_ac_first(c, bx, by);
        } else if (arithmetic) {
            arith_ac_refine(c, bx, by);
        } else {
            huff_ac_refine(c, bx, by);
        }
    }

    // the statistics (and DC predictions) a scan starts with and resets at
    // each restart marker (jdarith.c start_pass / process_restart)
    void reset_scan_state() {
        for (int i = 0; i < 4; ++i) {
            last_dc[i] = 0;
            dc_context[i] = 0;
        }
        eobrun = 0;
        if (arithmetic) {
            for (int i = 0; i < scan_ns; ++i) {
                const Component& c = comp[scan_idx[i]];
                if (!progressive || (ss == 0 && ah == 0)) std::memset(dc_stats[c.dc_table], 0, 64);
                if (!progressive || ss) std::memset(ac_stats[c.ac_table], 0, 256);
            }
            arith_reset();
        }
        bitbuf = 0;
        bitcount = 0;
        hit_marker = false;
    }

    void restart() {
        if (arithmetic && unread_marker) {
            int m = unread_marker;
            unread_marker = 0;
            if (m < 0xD0 || m > 0xD7) malformed("expected an RST marker");
        } else {
            while (pos + 1 < size && !(data[pos] == 0xFF && data[pos + 1] != 0x00)) ++pos;
            int m = next_marker();
            if (m < 0xD0 || m > 0xD7) malformed("expected an RST marker");
        }
        reset_scan_state();
    }

    void read_scan() {
        if (!frame) malformed("a scan before its frame header");
        int ns = byte();
        if (ns < 1 || ns > ncomp) malformed("bad scan component count");
        scan_ns = ns;
        for (int i = 0; i < ns; ++i) {
            int id = byte();
            int tables = byte();
            int found = -1;
            for (int j = 0; j < ncomp; ++j)
                if (comp[j].id == id) found = j;
            if (found < 0) malformed("a scan names an unknown component");
            scan_idx[i] = found;
            Component& c = comp[found];
            c.dc_table = tables >> 4;
            c.ac_table = tables & 15;
        }
        if (ns > 1) {  // jdinput.c per_scan_setup: D_MAX_BLOCKS_IN_MCU
            int blocks = 0;
            for (int i = 0; i < ns; ++i) blocks += comp[scan_idx[i]].h * comp[scan_idx[i]].v;
            if (blocks > 10) malformed("sampling factors too large for an interleaved scan");
        }
        ss = byte();
        se = byte();
        int ahal = byte();
        ah = ahal >> 4;
        al = ahal & 15;
        if (lossless) {
            lossless_scan(ns);
            return;
        }
        if (progressive) {
            // jdphuff.c / jdarith.c start_pass: a legal progression step
            bool bad = false;
            if (ss == 0) bad = se != 0;
            else bad = ss > se || se > 63 || ns != 1;
            if (ah != 0 && al != ah - 1) bad = true;
            if (al > 13) bad = true;
            if (bad) malformed("bad progression parameters in a scan");
        } else if (ss != 0 || se != 63 || ahal != 0) {
            malformed("bad spectral selection for a sequential scan");
        }
        for (int i = 0; i < ns; ++i) {
            Component& c = comp[scan_idx[i]];
            const bool dc_needed = !progressive || (ss == 0 && ah == 0);
            const bool ac_needed = !progressive || ss != 0;
            if (arithmetic) {
                if (c.dc_table > 15 || c.ac_table > 15) malformed("an arithmetic table past 15");
            } else if ((dc_needed && (c.dc_table > 3 || !dc[c.dc_table].defined)) ||
                       (ac_needed && (c.ac_table > 3 || !ac[c.ac_table].defined))) {
                malformed("a scan uses an undefined Huffman table");
            }
            if (!c.seen) {  // jdinput.c latch_quant_tables
                if (!qt_defined[c.tq]) malformed("a component uses an undefined DQT table");
                std::memcpy(c.q, qt[c.tq], sizeof(c.q));
            }
            c.seen = true;
            if (progressive)
                for (int k = ss; k <= se; ++k) c.coef_bits[k] = al;
        }
        unread_marker = 0;
        reset_scan_state();

        long units, units_x;
        if (ns == 1) {  // non-interleaved: one block an MCU, over the real samples only
            Component& c = comp[scan_idx[0]];
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
                    togo = restart_interval;
                }
                --togo;
            }
            int ux = static_cast<int>(u % units_x), uy = static_cast<int>(u / units_x);
            if (ns == 1) {
                decode_unit(comp[scan_idx[0]], ux, uy, 0);
            } else {
                for (int i = 0; i < ns; ++i) {
                    Component& c = comp[scan_idx[i]];
                    for (int v = 0; v < c.v; ++v)
                        for (int h = 0; h < c.h; ++h)
                            decode_unit(c, ux * c.h + h, uy * c.v + v, i);
                }
            }
        }
        if (arithmetic && unread_marker) {
            pos = marker_pos;  // the marker the decoder met is the next one
            unread_marker = 0;
            return;
        }
        skip_to_marker();  // drop the rest of the entropy-coded segment
    }

    // the rest of the entropy-coded segment, up to the next marker
    void skip_to_marker() {
        while (pos + 1 < size && !(data[pos] == 0xFF && data[pos + 1] != 0x00 &&
                                   !(data[pos + 1] >= 0xD0 && data[pos + 1] <= 0xD7)))
            ++pos;
    }

    // a lossless scan (jdlhuff.c decode_mcus, jdpred.c, jdlossls.c): each
    // row's differences (SSSS 16 is 32768 with no bits), undifferenced
    // modulo 2^16 against predictor Ss, shifted left by Al into 8 bits
    void lossless_scan(int ns) {
        if (ss < 1 || ss > 7 || se != 0 || ah != 0 || al >= 8)
            malformed("bad lossless scan parameters");
        for (int i = 0; i < ns; ++i) {
            Component& c = comp[scan_idx[i]];
            if (c.dc_table > 3 || !dc[c.dc_table].defined)
                malformed("a scan uses an undefined Huffman table");
            c.seen = true;
        }
        if (restart_interval % width != 0)  // jdpred.c predict_start_pass
            malformed("a lossless restart interval that is not a whole number of rows");
        reset_scan_state();
        std::vector<std::vector<int32_t>> diff(ns, std::vector<int32_t>(width));
        std::vector<std::vector<int32_t>> cur(ns, std::vector<int32_t>(width));
        std::vector<std::vector<int32_t>> prev(ns, std::vector<int32_t>(width));
        const int initial = 1 << (7 - al);
        const int rows_between = restart_interval / width;
        int togo = rows_between;
        bool first = true;
        for (int y = 0; y < height; ++y) {
            if (rows_between) {
                if (togo == 0) {
                    restart();
                    togo = rows_between;
                    first = true;
                }
                --togo;
            }
            for (int x = 0; x < width; ++x)
                for (int i = 0; i < ns; ++i) {
                    int s = decode(dc[comp[scan_idx[i]].dc_table]);
                    if (s > 16) malformed("a lossless difference of more than 16 bits");
                    diff[i][x] = s == 16 ? 32768 : (s ? extend(get_bits(s), s) : 0);
                }
            for (int i = 0; i < ns; ++i) {
                const int32_t* d = diff[i].data();
                const int32_t* up = prev[i].data();
                int32_t* o = cur[i].data();
                if (first) {  // UNDIFFERENCE_1D(INITIAL_PREDICTOR)
                    int ra = (d[0] + initial) & 0xFFFF;
                    o[0] = ra;
                    for (int x = 1; x < width; ++x) o[x] = ra = (d[x] + ra) & 0xFFFF;
                } else {  // UNDIFFERENCE_2D(PREDICTORn), the first column from above
                    int ra = (d[0] + up[0]) & 0xFFFF;
                    o[0] = ra;
                    for (int x = 1; x < width; ++x) {
                        const int rb = up[x], rc = up[x - 1];
                        int p;
                        switch (ss) {
                            case 1: p = ra; break;
                            case 2: p = rb; break;
                            case 3: p = rc; break;
                            case 4: p = ra + rb - rc; break;
                            case 5: p = ra + ((rb - rc) >> 1); break;
                            case 6: p = rb + ((ra - rc) >> 1); break;
                            default: p = (ra + rb) >> 1; break;
                        }
                        o[x] = ra = (d[x] + p) & 0xFFFF;
                    }
                }
                Component& c = comp[scan_idx[i]];
                uint8_t* row = c.plane.data() + static_cast<size_t>(y) * c.blocks_w * 8;
                for (int x = 0; x < width; ++x) row[x] = static_cast<uint8_t>(o[x] << al);
                std::swap(cur[i], prev[i]);
            }
            first = false;
        }
        skip_to_marker();
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
                read_dac(end);
            } else if (m >= 0xC0 && m <= 0xCF) {
                read_sof(m);
                check_colour_space();
                if (headers_only) return;
                allocate();
            } else if (m == 0xDA) {
                read_scan();
                scanned = true;
                continue;  // read_scan leaves pos at the next marker
            } else if (m == 0xE0 && len >= 16 && std::memcmp(data + pos, "JFIF\0", 5) == 0) {
                saw_jfif = true;  // jdmarker.c examine_app0: 14 bytes of data at least
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
        if (progressive) {
            check_no_smoothing();
            for (int i = 0; i < ncomp; ++i) {
                Component& c = comp[i];
                for (int by = 0; by < c.blocks_h; ++by)
                    for (int bx = 0; bx < c.blocks_w; ++bx) idct_block(c, coef_at(c, bx, by), bx, by);
            }
        }
    }

    // jdcoefct.c smoothing_ok: libjpeg-turbo smooths the blocks of a
    // progressive file (decompress_smooth_data) when a component's DC is
    // known, its first ten quantizers are nonzero, and one of its AC
    // coefficients 1-9 is not refined to bit 0; the port does not
    void check_no_smoothing() const {
        static const int kFirstTen[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};
        bool useful = false;
        for (int i = 0; i < ncomp; ++i) {
            const Component& c = comp[i];
            for (int k : kFirstTen)
                if (c.q[k] == 0) return;
            if (c.coef_bits[0] < 0) return;
            for (int k = 1; k < 10; ++k)
                if (c.coef_bits[k] != 0) useful = true;
        }
        if (useful)
            unsupported("a progressive JPEG whose scans leave a low AC coefficient unrefined "
                        "(libjpeg-turbo smooths its blocks)");
    }

    // jdapimin.c default_decompress_parms: the file's colour space
    bool rgb_coded() const {
        if (saw_jfif) return false;
        if (saw_adobe) return adobe_transform == 0;
        return comp[0].id == 'R' && comp[1].id == 'G' && comp[2].id == 'B';
    }

    bool ycck() const { return saw_adobe && adobe_transform != 0; }

    int colour = kAsFile;

    // jdsample.c jinit_upsampler: integral ratios only
    void check_colour_space() const {
        for (int i = 0; i < ncomp; ++i) {
            const Component& c = comp[i];
            if (hmax % c.h != 0 || vmax % c.v != 0)
                unsupported("a sampling layout of non-integral ratios (libjpeg refuses it too)");
        }
        if (colour == kYCbCr && ncomp != 3)
            malformed("YCbCr asked of a JPEG of " + std::to_string(ncomp) + " components");
        // jdmaster.c: no colour conversion in lossless mode
        if (lossless && colour == kAsFile &&
            ((ncomp == 3 && (saw_jfif || (saw_adobe && adobe_transform != 0))) ||
             (ncomp == 4 && ycck())))
            unsupported("a lossless JPEG whose markers ask for a colour conversion "
                        "(libjpeg-turbo refuses it)");
        if (lossless && colour == kYCbCr) malformed("YCbCr asked of a lossless JPEG");
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
        const int dw = c.width, dh = c.height;
        if (colour != kBox && c.h == hmax && 2 * c.v == vmax) {  // h1v2_fancy_upsample
            for (int y = 0; y < height; ++y) {
                int i = y / 2;
                int nb = (y & 1) ? (i + 1 < dh ? i + 1 : dh - 1) : (i > 0 ? i - 1 : 0);
                const uint8_t* in0 = p + i * stride;
                const uint8_t* in1 = p + nb * stride;
                const int bias = (y & 1) ? 2 : 1;
                uint8_t* dst = &out[static_cast<size_t>(y) * width];
                for (int x = 0; x < width; ++x)
                    dst[x] = static_cast<uint8_t>((in0[x] * 3 + in1[x] + bias) >> 2);
            }
            return out;
        }
        // int_upsample: box replication
        if (colour == kBox || hmax != 2 * c.h || (c.v != vmax && vmax != 2 * c.v)) {
            const int he = hmax / c.h, ve = vmax / c.v;
            for (int y = 0; y < height; ++y) {
                const uint8_t* in = p + (y / ve) * stride;
                uint8_t* dst = &out[static_cast<size_t>(y) * width];
                for (int x = 0; x < width; ++x) dst[x] = in[x / he];
            }
            return out;
        }
        const bool v1 = c.v == vmax, v2 = 2 * c.v == vmax;
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
        std::vector<uint8_t> p0 = full_size(comp[0]), p1 = full_size(comp[1]),
                             p2 = full_size(comp[2]);
        std::vector<uint8_t> p3 = ncomp == 4 ? full_size(comp[3]) : std::vector<uint8_t>();
        const size_t n = static_cast<size_t>(width) * height;
        if (colour == kRaw || colour == kBox) {  // JCS_UNKNOWN: the components as they are
            const std::vector<uint8_t>* planes[4] = {&p0, &p1, &p2, &p3};
            for (size_t i = 0; i < n; ++i)
                for (int k = 0; k < ncomp; ++k) out[ncomp * i + k] = (*planes[k])[i];
            return;
        }
        if (ncomp == 3 && colour == kAsFile && (lossless || rgb_coded())) {  // no transform
            for (size_t i = 0; i < n; ++i) {
                out[3 * i] = p0[i];
                out[3 * i + 1] = p1[i];
                out[3 * i + 2] = p2[i];
            }
            return;
        }
        if (ncomp == 4 && !ycck()) {  // CMYK, inverted as PIL's "CMYK;I"
            for (size_t i = 0; i < n; ++i) {
                out[4 * i] = static_cast<uint8_t>(255 - p0[i]);
                out[4 * i + 1] = static_cast<uint8_t>(255 - p1[i]);
                out[4 * i + 2] = static_cast<uint8_t>(255 - p2[i]);
                out[4 * i + 3] = static_cast<uint8_t>(255 - p3[i]);
            }
            return;
        }
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
        for (size_t i = 0; i < n; ++i) {
            int y = p0[i], b = p1[i], r = p2[i];
            int R = y + cr_r[r];
            int G = y + static_cast<int>((cb_g[b] + cr_g[r]) >> SCALEBITS);
            int B = y + cb_b[b];
            if (ncomp == 3) {
                out[3 * i] = clamp(R);
                out[3 * i + 1] = clamp(G);
                out[3 * i + 2] = clamp(B);
            } else {  // YCCK -> CMYK (jdcolor.c ycck_cmyk_convert), then PIL's inversion
                out[4 * i] = static_cast<uint8_t>(255 - clamp(255 - R));
                out[4 * i + 1] = static_cast<uint8_t>(255 - clamp(255 - G));
                out[4 * i + 2] = static_cast<uint8_t>(255 - clamp(255 - B));
                out[4 * i + 3] = static_cast<uint8_t>(255 - p3[i]);
            }
        }
    }
};

void set_error(char* err, size_t cap, const std::string& what) {
    if (err && cap) std::snprintf(err, cap, "%s", what.c_str());
}

}  // namespace

extern "C" {

// Decode the JPEG in data[0:size] in colour space `colour` (0 as the file
// says, 1 its components as they are, 2 YCbCr to RGB, 3 the components as
// they are, box-replicated to full size). dims[0..2] receive
// height, width and channels (1 grey, 3 RGB, 4 CMYK as PIL's "CMYK" mode
// holds it). With
// out == NULL only the headers up to the frame header are read and the
// call returns 3 (sizes known, nothing written); otherwise out must hold
// height*width*channels bytes, and the call returns 0 when the pixels are
// written (row-major, channels last). A file it does not read returns 1,
// a malformed file 2 (or an out_cap too small); err receives a message.
int ddgan_jpeg_decode(const uint8_t* data, size_t size, uint8_t* out, size_t out_cap,
                      int64_t* dims, int colour, char* err, size_t err_cap) {
    try {
        if (colour < kAsFile || colour > kBox) malformed("an unknown colour space");
        Decoder d(data, size);
        d.colour = colour;
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

// Copy the decoder's T.81 Table D.2 (jpeg_aritab's 114 entries) into out;
// returns the number of entries.
size_t ddgan_jpeg_aritab(int64_t* out, size_t n) {
    size_t k = n < 114 ? n : 114;
    for (size_t i = 0; i < k; ++i) out[i] = kAritab[i];
    return 114;
}

}  // extern "C"
