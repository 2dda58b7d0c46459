// TIFF strip and tile codecs behind a plain C interface (bound with ctypes
// by ddgan_torch/data/tiff.py, which parses the tags and lays out the
// samples): LZW (compression 5) as libtiff's tif_lzw.c decodes it, in the
// TIFF 6.0 form (MSB-first codes, each width step one entry early) and the
// pre-6.0 form libtiff still reads (LSB-first codes, told by the first two
// bytes); PackBits (32773) as tif_packbits.c; and predictor 2, the
// horizontal differencing of tif_predict.c, on 8- or 16-bit samples in the
// machine's order; 32-bit samples too. Deflate (8, 32946) and LZMA (34925)
// are inflated by Python's zlib and lzma.
//
// The CCITT codecs, as libtiff's tif_fax3.c decodes them for PIL: Modified
// Huffman (compression 2, each row's code byte-aligned), T.4 (3: EOLs, fill
// bits, 1-D rows or, with T4Options bit 0, 1-D and 2-D rows each flagged
// after its EOL) and T.6 (4: 2-D rows against the row above, the first
// against a white row). Each strip starts afresh. A run of 1-bits is black
// in the code: photometric 0 or 1 is applied by the caller. A row whose
// runs do not add up to its width is cut or padded with white, as
// tif_fax3.h CLEANUP_RUNS does; a code the tables do not hold, an
// uncompressed-mode extension or data that ends before the last row is an
// error (libtiff warns and PIL fails on most of them).
//
// Each call fills `out` with exactly `out_cap` bytes or fails: a strip that
// ends early is an error, as in libtiff ("Not enough data"); bytes past
// out_cap are dropped, as libtiff drops them. Return codes: 0 done,
// 2 malformed (err receives a message).
//
// Build: c++ -O2 -std=c++17 -shared -fPIC (ddgan_torch/ops/_cxx.py).

#include <cstdint>
#include <cstdio>
#include <algorithm>
#include <cstring>
#include <string>
#include <vector>

namespace {

constexpr int kMalformed = 2;

struct Failure {
    std::string what;
};

[[noreturn]] void malformed(const std::string& what) { throw Failure{what}; }

constexpr int kClear = 256, kEoi = 257, kFirst = 258, kBitsMax = 12;
constexpr int kTable = (1 << kBitsMax) + 1024;  // libtiff's CSIZE: room past 4095

void lzw(const uint8_t* in, size_t n, uint8_t* out, size_t cap) {
    // the pre-6.0 form starts with Clear in LSB-first order (tif_lzw.c LZWPreDecode)
    const bool old = n >= 2 && in[0] == 0 && (in[1] & 1);
    std::vector<int32_t> prefix(kTable), length(kTable);
    std::vector<uint8_t> suffix(kTable), first(kTable);
    for (int c = 0; c < 256; ++c) {
        prefix[c] = -1;
        length[c] = 1;
        suffix[c] = first[c] = static_cast<uint8_t>(c);
    }
    size_t pos = 0, done = 0;
    uint64_t acc = 0;
    int have = 0, nbits = 9, next = kFirst, prev = -1;
    auto widen_at = [&]() { return old ? (1 << nbits) : (1 << nbits) - 1; };
    auto read_code = [&]() -> int {
        while (have < nbits) {
            if (pos >= n) return kEoi;  // libtiff: a strip not terminated with EOI ends here
            if (old) acc |= static_cast<uint64_t>(in[pos++]) << have;
            else acc = (acc << 8) | in[pos++];
            have += 8;
        }
        int code;
        if (old) {
            code = static_cast<int>(acc & ((1u << nbits) - 1));
            acc >>= nbits;
        } else {
            code = static_cast<int>((acc >> (have - nbits)) & ((1u << nbits) - 1));
        }
        have -= nbits;
        return code;
    };
    auto emit = [&](int code) {
        // the string of `code`, written backwards from its end; cut at cap
        size_t len = static_cast<size_t>(length[code]);
        size_t end = done + len;
        for (int c = code; c >= 0; c = prefix[c]) {
            --end;
            if (end < cap) out[end] = suffix[c];
        }
        done += len;
    };
    while (done < cap) {
        int code = read_code();
        if (code == kEoi) break;
        if (code == kClear) {
            nbits = 9;
            next = kFirst;
            code = read_code();
            if (code == kEoi) break;
            if (code > 255) malformed("an LZW code after Clear that is not a byte");
            emit(code);
            prev = code;
            continue;
        }
        if (prev < 0) malformed("LZW data that does not start with Clear");
        if (code > next || code == kClear || code == kEoi)
            malformed("an LZW code past the table");
        if (next >= kTable) malformed("an LZW table that overflows");
        uint8_t head = code < next ? first[code] : first[prev];
        prefix[next] = prev;
        suffix[next] = head;
        first[next] = first[prev];
        length[next] = length[prev] + 1;
        emit(code == next ? next : code);
        prev = code;
        if (++next >= widen_at() && nbits < kBitsMax) ++nbits;
    }
    if (done < cap) malformed("the LZW data ends before the strip is full");
}

void packbits(const uint8_t* in, size_t n, uint8_t* out, size_t cap) {
    size_t pos = 0, done = 0;
    while (done < cap && pos < n) {
        int c = static_cast<int8_t>(in[pos++]);
        if (c < 0) {
            if (c == -128) continue;  // a no-op
            if (pos >= n) break;
            size_t run = static_cast<size_t>(-c + 1);
            if (run > cap - done) run = cap - done;
            std::memset(out + done, in[pos++], run);
            done += run;
        } else {
            size_t run = static_cast<size_t>(c + 1);
            if (run > n - pos) malformed("a PackBits literal run past the strip's data");
            size_t keep = run > cap - done ? cap - done : run;
            std::memcpy(out + done, in + pos, keep);
            pos += run;
            done += keep;
        }
    }
    if (done < cap) malformed("the PackBits data ends before the strip is full");
}

// ------------------------------------------------------------------ CCITT
// T.4's code tables: {bits, code, run}; run -1 is EOL
struct Code {
    int bits, code, run;
};

const Code kWhite[] = {
    {8, 0x35, 0}, {6, 0x7, 1}, {4, 0x7, 2}, {4, 0x8, 3}, {4, 0xB, 4}, {4, 0xC, 5},
    {4, 0xE, 6}, {4, 0xF, 7}, {5, 0x13, 8}, {5, 0x14, 9}, {5, 0x7, 10}, {5, 0x8, 11},
    {6, 0x8, 12}, {6, 0x3, 13}, {6, 0x34, 14}, {6, 0x35, 15}, {6, 0x2A, 16}, {6, 0x2B, 17},
    {7, 0x27, 18}, {7, 0xC, 19}, {7, 0x8, 20}, {7, 0x17, 21}, {7, 0x3, 22}, {7, 0x4, 23},
    {7, 0x28, 24}, {7, 0x2B, 25}, {7, 0x13, 26}, {7, 0x24, 27}, {7, 0x18, 28}, {8, 0x2, 29},
    {8, 0x3, 30}, {8, 0x1A, 31}, {8, 0x1B, 32}, {8, 0x12, 33}, {8, 0x13, 34}, {8, 0x14, 35},
    {8, 0x15, 36}, {8, 0x16, 37}, {8, 0x17, 38}, {8, 0x28, 39}, {8, 0x29, 40}, {8, 0x2A, 41},
    {8, 0x2B, 42}, {8, 0x2C, 43}, {8, 0x2D, 44}, {8, 0x4, 45}, {8, 0x5, 46}, {8, 0xA, 47},
    {8, 0xB, 48}, {8, 0x52, 49}, {8, 0x53, 50}, {8, 0x54, 51}, {8, 0x55, 52}, {8, 0x24, 53},
    {8, 0x25, 54}, {8, 0x58, 55}, {8, 0x59, 56}, {8, 0x5A, 57}, {8, 0x5B, 58}, {8, 0x4A, 59},
    {8, 0x4B, 60}, {8, 0x32, 61}, {8, 0x33, 62}, {8, 0x34, 63},
    {5, 0x1B, 64}, {5, 0x12, 128}, {6, 0x17, 192}, {7, 0x37, 256}, {8, 0x36, 320},
    {8, 0x37, 384}, {8, 0x64, 448}, {8, 0x65, 512}, {8, 0x68, 576}, {8, 0x67, 640},
    {9, 0xCC, 704}, {9, 0xCD, 768}, {9, 0xD2, 832}, {9, 0xD3, 896}, {9, 0xD4, 960},
    {9, 0xD5, 1024}, {9, 0xD6, 1088}, {9, 0xD7, 1152}, {9, 0xD8, 1216}, {9, 0xD9, 1280},
    {9, 0xDA, 1344}, {9, 0xDB, 1408}, {9, 0x98, 1472}, {9, 0x99, 1536}, {9, 0x9A, 1600},
    {6, 0x18, 1664}, {9, 0x9B, 1728}};

const Code kBlack[] = {
    {10, 0x37, 0}, {3, 0x2, 1}, {2, 0x3, 2}, {2, 0x2, 3}, {3, 0x3, 4}, {4, 0x3, 5},
    {4, 0x2, 6}, {5, 0x3, 7}, {6, 0x5, 8}, {6, 0x4, 9}, {7, 0x4, 10}, {7, 0x5, 11},
    {7, 0x7, 12}, {8, 0x4, 13}, {8, 0x7, 14}, {9, 0x18, 15}, {10, 0x17, 16}, {10, 0x18, 17},
    {10, 0x8, 18}, {11, 0x67, 19}, {11, 0x68, 20}, {11, 0x6C, 21}, {11, 0x37, 22},
    {11, 0x28, 23}, {11, 0x17, 24}, {11, 0x18, 25}, {12, 0xCA, 26}, {12, 0xCB, 27},
    {12, 0xCC, 28}, {12, 0xCD, 29}, {12, 0x68, 30}, {12, 0x69, 31}, {12, 0x6A, 32},
    {12, 0x6B, 33}, {12, 0xD2, 34}, {12, 0xD3, 35}, {12, 0xD4, 36}, {12, 0xD5, 37},
    {12, 0xD6, 38}, {12, 0xD7, 39}, {12, 0x6C, 40}, {12, 0x6D, 41}, {12, 0xDA, 42},
    {12, 0xDB, 43}, {12, 0x54, 44}, {12, 0x55, 45}, {12, 0x56, 46}, {12, 0x57, 47},
    {12, 0x64, 48}, {12, 0x65, 49}, {12, 0x52, 50}, {12, 0x53, 51}, {12, 0x24, 52},
    {12, 0x37, 53}, {12, 0x38, 54}, {12, 0x27, 55}, {12, 0x28, 56}, {12, 0x58, 57},
    {12, 0x59, 58}, {12, 0x2B, 59}, {12, 0x2C, 60}, {12, 0x5A, 61}, {12, 0x66, 62},
    {12, 0x67, 63},
    {10, 0xF, 64}, {12, 0xC8, 128}, {12, 0xC9, 192}, {12, 0x5B, 256}, {12, 0x33, 320},
    {12, 0x34, 384}, {12, 0x35, 448}, {13, 0x6C, 512}, {13, 0x6D, 576}, {13, 0x4A, 640},
    {13, 0x4B, 704}, {13, 0x4C, 768}, {13, 0x4D, 832}, {13, 0x72, 896}, {13, 0x73, 960},
    {13, 0x74, 1024}, {13, 0x75, 1088}, {13, 0x76, 1152}, {13, 0x77, 1216}, {13, 0x52, 1280},
    {13, 0x53, 1344}, {13, 0x54, 1408}, {13, 0x55, 1472}, {13, 0x5A, 1536}, {13, 0x5B, 1600},
    {13, 0x64, 1664}, {13, 0x65, 1728}};

// the extended make-up codes of both colours, and EOL
const Code kShared[] = {
    {11, 0x8, 1792}, {11, 0xC, 1856}, {11, 0xD, 1920}, {12, 0x12, 1984}, {12, 0x13, 2048},
    {12, 0x14, 2112}, {12, 0x15, 2176}, {12, 0x16, 2240}, {12, 0x17, 2304}, {12, 0x1C, 2368},
    {12, 0x1D, 2432}, {12, 0x1E, 2496}, {12, 0x1F, 2560}, {12, 0x1, -1}};

constexpr int kMaxBits = 13;
constexpr int kEol = -1, kInvalid = -2;

// run of each (bits, code), kInvalid where no code is
struct RunTable {
    std::vector<int> run[kMaxBits + 1];
    RunTable(const Code* own, size_t n) {
        for (int b = 1; b <= kMaxBits; ++b) run[b].assign(size_t(1) << b, kInvalid);
        for (size_t i = 0; i < n; ++i) run[own[i].bits][own[i].code] = own[i].run;
        for (const Code& c : kShared) run[c.bits][c.code] = c.run;
    }
};

// the 2-D mode codes (tif_fax3.c's main table, 7 bits deep)
enum Mode { kPass, kHoriz, kV0, kVR1, kVR2, kVR3, kVL1, kVL2, kVL3, kExt, kModeEol, kNone };

// tif_fax3.h's bit reader, exactly: bytes loaded into BitAcc first bit
// lowest; NeedBits8 / NeedBits16 load one or two bytes when fewer than n
// bits are held and, at the end of the data, pad with zero bits up to n
// (a premature end only when no bit is held), so that the byte alignment
// of a Modified Huffman row (ClrBits of BitsAvail mod 8) counts the padding
// as libtiff does.
struct Bits {
    const uint8_t* cp;
    const uint8_t* ep;
    uint32_t acc = 0;  // BitAcc
    int avail = 0;     // BitsAvail
    bool eof = false;  // a NeedBits found no bit left

    static uint32_t reversed(uint8_t b) {
        static const struct Table {
            uint8_t r[256];
            Table() {
                for (int v = 0; v < 256; ++v) {
                    r[v] = 0;
                    for (int i = 0; i < 8; ++i)
                        r[v] |= static_cast<uint8_t>(((v >> i) & 1) << (7 - i));
                }
            }
        } table;
        return table.r[b];
    }
    bool need8(int n) {
        if (avail < n) {
            if (cp == ep) {
                if (avail == 0) return !(eof = true);
                avail = n;
            } else {
                acc |= reversed(*cp++) << avail;
                avail += 8;
            }
        }
        return true;
    }
    bool need16(int n) {
        if (avail < n) {
            if (cp == ep) {
                if (avail == 0) return !(eof = true);
                avail = n;
            } else {
                acc |= reversed(*cp++) << avail;
                if ((avail += 8) < n) {
                    if (cp == ep) {
                        avail = n;
                    } else {
                        acc |= reversed(*cp++) << avail;
                        avail += 8;
                    }
                }
            }
        }
        return true;
    }
    uint32_t get(int n) const { return acc & ((1u << n) - 1); }
    void clr(int n) {
        avail -= n;
        acc >>= n;
    }
    // the first k held bits as a number, the first bit highest
    int peek(int k) const {
        int v = 0;
        for (int i = 0; i < k; ++i) v = (v << 1) | static_cast<int>((acc >> i) & 1);
        return v;
    }
};

struct Fax {
    Bits bits;
    int64_t lastx;
    std::vector<int64_t> cur, ref;  // runs, white first, alternating
    size_t pa = 0;                  // next run of cur
    int64_t a0 = 0, run_length = 0;
    bool eol_seen = false;

    Fax(const uint8_t* in, size_t n, int64_t width)
        : bits{in, in + n}, lastx(width), cur(2 * width + 64), ref(2 * width + 64) {}

    [[noreturn]] void premature() { malformed("the CCITT data ends before the strip is full"); }

    void set_value(int64_t x) {  // tif_fax3.h SETVALUE
        if (pa >= cur.size()) malformed("a CCITT row with more runs than it has pixels");
        cur[pa++] = run_length + x;
        a0 += x;
        run_length = 0;
    }

    // one code of a colour's table (LOOKUP16 of 12 bits for white, 13 for
    // black); kEol, or a run (make-up or terminating)
    int lookup(const RunTable& t, int width) {
        if (!bits.need16(width)) premature();
        const int v = bits.peek(width);
        for (int b = 1; b <= width; ++b) {
            int r = t.run[b][v >> (width - b)];
            if (r != kInvalid) {
                bits.clr(b);
                return r;
            }
        }
        malformed("a CCITT code that neither run table holds");
    }

    Mode mode() {  // LOOKUP8 of 7 bits
        if (!bits.need8(7)) premature();
        int v = bits.peek(7);
        static const struct { int bits, code; Mode m; } kModes[] = {
            {1, 1, kV0}, {3, 3, kVR1}, {3, 2, kVL1}, {3, 1, kHoriz}, {4, 1, kPass},
            {6, 3, kVR2}, {6, 2, kVL2}, {7, 3, kVR3}, {7, 2, kVL3}, {7, 1, kExt}, {7, 0, kModeEol}};
        for (const auto& m : kModes)
            if ((v >> (7 - m.bits)) == m.code) {
                bits.clr(m.bits);
                return m.m;
            }
        return kNone;
    }

    // tif_fax3.h CLEANUP_RUNS: the row's runs made to add up to lastx
    void cleanup() {
        if (run_length) set_value(0);
        if (a0 != lastx) {
            while (a0 > lastx && pa > 0) a0 -= cur[--pa];
            if (a0 < lastx) {
                if (a0 < 0) a0 = 0;
                if (pa & 1) set_value(0);
                set_value(lastx - a0);
            } else if (a0 > lastx) {
                set_value(lastx);
                set_value(0);
            }
        }
    }

    // a run of one colour: make-up codes, then a terminating code
    bool colour_run(const RunTable& t, bool is_black) {
        for (;;) {
            int r = lookup(t, is_black ? 13 : 12);
            if (r == kEol) return false;
            if (r < 64) {
                set_value(r);
                return true;
            }
            a0 += r;
            run_length += r;
        }
    }

    // tif_fax3.h EXPAND1D
    void expand_1d(const RunTable& white, const RunTable& black) {
        for (;;) {
            if (!colour_run(white, false)) {
                eol_seen = true;
                break;
            }
            if (a0 >= lastx) break;
            if (!colour_run(black, true)) {
                eol_seen = true;
                break;
            }
            if (a0 >= lastx) break;
            if (pa >= 2 && cur[pa - 1] == 0 && cur[pa - 2] == 0) pa -= 2;
        }
        cleanup();
    }

    // tif_fax3.h EXPAND2D against the reference runs `ref`
    void expand_2d(const RunTable& white, const RunTable& black) {
        size_t pb = 0;
        int64_t b1 = ref[pb++];
        auto need_ref = [&](size_t k) {
            if (pb + k > ref.size()) malformed("a CCITT row that reads past its reference row");
        };
        auto check_b1 = [&]() {
            if (pa != 0)
                while (b1 <= a0 && b1 < lastx) {
                    need_ref(2);
                    b1 += ref[pb] + ref[pb + 1];
                    pb += 2;
                }
        };
        while (a0 < lastx) {
            if (pa >= cur.size()) malformed("a CCITT row with more runs than it has pixels");
            Mode m = mode();
            switch (m) {
                case kPass:
                    check_b1();
                    need_ref(2);
                    b1 += ref[pb++];
                    run_length += b1 - a0;
                    a0 = b1;
                    b1 += ref[pb++];
                    break;
                case kHoriz: {
                    const bool black_first = pa & 1;
                    if (!colour_run(black_first ? black : white, black_first) ||
                        !colour_run(black_first ? white : black, !black_first))
                        malformed("an EOL inside a CCITT horizontal-mode pair");
                    check_b1();
                    break;
                }
                case kV0: case kVR1: case kVR2: case kVR3: {
                    check_b1();
                    set_value(b1 - a0 + (m == kV0 ? 0 : m == kVR1 ? 1 : m == kVR2 ? 2 : 3));
                    need_ref(1);
                    b1 += ref[pb++];
                    break;
                }
                case kVL1: case kVL2: case kVL3: {
                    const int d = m == kVL1 ? 1 : m == kVL2 ? 2 : 3;
                    check_b1();
                    if (b1 < a0 + d) malformed("a CCITT vertical code left of the row's position");
                    set_value(b1 - a0 - d);
                    if (pb == 0) malformed("a CCITT row that reads before its reference row");
                    b1 -= ref[--pb];
                    break;
                }
                case kExt:
                    malformed("a CCITT uncompressed-mode extension (libtiff does not decode it)");
                case kModeEol:
                    if (pa >= cur.size()) malformed("a CCITT row with more runs than pixels");
                    cur[pa++] = lastx - a0;
                    if (!bits.need8(4)) premature();
                    if (bits.get(4)) malformed("a CCITT EOL with a bad code");
                    bits.clr(4);
                    eol_seen = true;
                    cleanup();
                    return;
                default:
                    malformed("a CCITT 2-D code the mode table does not hold");
            }
        }
        if (run_length) {
            if (run_length + a0 < lastx) {
                if (!bits.need8(1)) premature();
                if (!bits.get(1)) malformed("a CCITT row that does not end with V0");
                bits.clr(1);
            }
            set_value(0);
        }
        cleanup();
    }

    // tif_fax3.h SYNC_EOL: to the bit after the next EOL
    void sync_eol() {
        if (!eol_seen) {
            for (;;) {
                if (!bits.need16(11)) premature();
                if (bits.get(11) == 0) break;
                bits.clr(1);
            }
        }
        for (;;) {
            if (!bits.need8(8)) premature();
            if (bits.get(8)) break;
            bits.clr(8);
        }
        while (bits.get(1) == 0) bits.clr(1);
        bits.clr(1);
        eol_seen = false;
    }

    void start_row() {
        a0 = 0;
        run_length = 0;
        pa = 0;
    }

    // _TIFFFax3fillruns: black runs as 1-bits, MSB first
    void fill(uint8_t* row) {
        std::memset(row, 0, static_cast<size_t>((lastx + 7) / 8));
        int64_t x = 0;
        for (size_t i = 0; i < pa; i += 2) {
            int64_t w = cur[i];
            if (x + w > lastx || w > lastx) w = lastx - x;
            x += w;
            if (i + 1 >= pa) break;
            int64_t b = cur[i + 1];
            if (x + b > lastx || b > lastx) b = lastx - x;
            int64_t k = x;
            const int64_t end = x + b;
            for (; k < end && (k & 7); ++k) row[k >> 3] |= static_cast<uint8_t>(0x80 >> (k & 7));
            if (k + 8 <= end) {
                std::memset(row + (k >> 3), 0xFF, static_cast<size_t>((end - k) >> 3));
                k += (end - k) & ~int64_t(7);
            }
            for (; k < end; ++k) row[k >> 3] |= static_cast<uint8_t>(0x80 >> (k & 7));
            x += b;
        }
    }

    void end_row_as_reference() {
        if (pa < cur.size()) cur[pa++] = 0;  // the imaginary change that ends the reference
        std::fill(cur.begin() + pa, cur.end(), 0);
        std::swap(cur, ref);
    }
};

void fax(int scheme, const uint8_t* in, size_t n, uint8_t* out, size_t cap, int64_t width,
         int64_t rows, int64_t options) {
    if (width <= 0 || rows <= 0) malformed("a CCITT strip without pixels");
    const size_t stride = static_cast<size_t>((width + 7) / 8);
    if (cap < stride * static_cast<size_t>(rows)) malformed("a CCITT strip larger than its buffer");
    static const RunTable white(kWhite, sizeof(kWhite) / sizeof(Code));
    static const RunTable black(kBlack, sizeof(kBlack) / sizeof(Code));
    Fax f(in, n, width);
    f.ref[0] = width;  // Fax3PreDecode: an all-white row above the first
    const bool two_d = scheme == 3 && (options & 1);
    for (int64_t y = 0; y < rows; ++y) {
        f.start_row();
        if (scheme == 2) {  // Fax3DecodeRLE, each row byte-aligned
            f.expand_1d(white, black);
            f.bits.clr(f.bits.avail % 8);  // FAXMODE_BYTEALIGN
            f.eol_seen = false;
        } else if (scheme == 3) {
            f.sync_eol();
            bool one_d = true;
            if (two_d) {
                if (!f.bits.need8(1)) f.premature();
                one_d = f.bits.get(1);
                f.bits.clr(1);
            }
            if (one_d) f.expand_1d(white, black);
            else f.expand_2d(white, black);
        } else {  // Fax4Decode
            f.expand_2d(white, black);
            if (f.eol_seen) malformed("a CCITT Group 4 strip that ends before its last row");
        }
        f.fill(out + stride * static_cast<size_t>(y));
        f.end_row_as_reference();
    }
}

template <typename T>
void accumulate(T* p, int64_t rows, int64_t row_samples, int64_t spp) {
    for (int64_t r = 0; r < rows; ++r) {
        T* row = p + r * row_samples;
        for (int64_t i = spp; i < row_samples; ++i) row[i] = static_cast<T>(row[i] + row[i - spp]);
    }
}

void set_error(char* err, size_t cap, const std::string& what) {
    if (err && cap) std::snprintf(err, cap, "%s", what.c_str());
}

}  // namespace

extern "C" {

// Decode one strip or tile of compression `scheme` (5 LZW, 32773 PackBits)
// from in[0:n] into out[0:out_cap].
int ddgan_tiff_decode(int scheme, const uint8_t* in, size_t n, uint8_t* out, size_t out_cap,
                      char* err, size_t err_cap) {
    try {
        if (scheme == 5) lzw(in, n, out, out_cap);
        else if (scheme == 32773) packbits(in, n, out, out_cap);
        else malformed("compression " + std::to_string(scheme) + " is not decoded here");
        return 0;
    } catch (const Failure& f) {
        set_error(err, err_cap, f.what);
        return kMalformed;
    } catch (const std::exception& e) {
        set_error(err, err_cap, e.what());
        return kMalformed;
    }
}

// Decode one strip or tile of CCITT compression `scheme` (2, 3 or 4) of
// `rows` rows of `width` pixels into out[0:out_cap], each row packed MSB
// first with 1 for black; `options` is T4Options (bit 0: 2-D coding).
int ddgan_tiff_fax(int scheme, const uint8_t* in, size_t n, uint8_t* out, size_t out_cap,
                   int64_t width, int64_t rows, int64_t options, char* err, size_t err_cap) {
    try {
        if (scheme < 2 || scheme > 4)
            malformed("compression " + std::to_string(scheme) + " is not CCITT");
        fax(scheme, in, n, out, out_cap, width, rows, options);
        return 0;
    } catch (const Failure& f) {
        set_error(err, err_cap, f.what);
        return kMalformed;
    } catch (const std::exception& e) {
        set_error(err, err_cap, e.what());
        return kMalformed;
    }
}

// Undo predictor 2 in place: `rows` rows of `row_samples` samples of
// `bits` (8, 16 or 32, machine order), each sample adding the one `spp`
// samples before it in its row.
int ddgan_tiff_unpredict(void* data, int bits, int64_t rows, int64_t row_samples, int64_t spp) {
    if (spp < 1 || rows < 0 || row_samples < 0) return kMalformed;
    if (bits == 8) accumulate(static_cast<uint8_t*>(data), rows, row_samples, spp);
    else if (bits == 16) accumulate(static_cast<uint16_t*>(data), rows, row_samples, spp);
    else if (bits == 32) accumulate(static_cast<uint32_t*>(data), rows, row_samples, spp);
    else return kMalformed;
    return 0;
}

}  // extern "C"
