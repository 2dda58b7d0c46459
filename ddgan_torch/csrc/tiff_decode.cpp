// TIFF strip and tile codecs behind a plain C interface (bound with ctypes
// by ddgan_torch/data/tiff.py, which parses the tags and lays out the
// samples): LZW (compression 5) as libtiff's tif_lzw.c decodes it, in the
// TIFF 6.0 form (MSB-first codes, each width step one entry early) and the
// pre-6.0 form libtiff still reads (LSB-first codes, told by the first two
// bytes); PackBits (32773) as tif_packbits.c; and predictor 2, the
// horizontal differencing of tif_predict.c, on 8- or 16-bit samples in the
// machine's order. Deflate (8, 32946) is inflated by Python's zlib.
//
// Each call fills `out` with exactly `out_cap` bytes or fails: a strip that
// ends early is an error, as in libtiff ("Not enough data"); bytes past
// out_cap are dropped, as libtiff drops them. Return codes: 0 done,
// 2 malformed (err receives a message).
//
// Build: c++ -O2 -std=c++17 -shared -fPIC (ddgan_torch/ops/_cxx.py).

#include <cstdint>
#include <cstdio>
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

// Undo predictor 2 in place: `rows` rows of `row_samples` samples of
// `bits` (8 or 16, machine order), each sample adding the one `spp`
// samples before it in its row.
int ddgan_tiff_unpredict(void* data, int bits, int64_t rows, int64_t row_samples, int64_t spp) {
    if (spp < 1 || rows < 0 || row_samples < 0) return kMalformed;
    if (bits == 8) accumulate(static_cast<uint8_t*>(data), rows, row_samples, spp);
    else if (bits == 16) accumulate(static_cast<uint16_t*>(data), rows, row_samples, spp);
    else return kMalformed;
    return 0;
}

}  // extern "C"
