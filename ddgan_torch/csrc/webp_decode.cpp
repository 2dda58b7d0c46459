// WebP decoder: the RIFF container, lossy VP8 key frames and lossless VP8L,
// behind a plain C interface (bound with ctypes by ddgan_torch/data/webp.py).
//
// It gives the RGB that PIL's `Image.open(f).convert("RGB")` gives, bit for
// bit. PIL decodes every WebP file through libwebp's WebPAnimDecoder into
// non-premultiplied RGBA (or RGBX) and `convert("RGB")` drops the alpha, so:
//   * the container (RFC 9649 section 2): simple `VP8 ` and `VP8L` files, and
//     `VP8X` files whose ICCP, EXIF, XMP, ALPH and unknown chunks are skipped
//     (the RGB does not depend on the alpha plane); an animation (ANIM, ANMF)
//     gives its frame 0 as WebPAnimDecoder gives its first key frame: the
//     canvas cleared to transparent black and the frame decoded at its
//     offset, with no blending;
//   * lossy key frames (RFC 6386, normative for the Y/U/V planes): the
//     boolean decoder, segmentation, 1-8 token partitions, the token coding
//     with its probability updates, the 16x16, 4x4 and chroma intra
//     predictions, the inverse DCT and WHT, the normal and simple loop
//     filters and the crop of the 16x16-aligned frame; then libwebp's output
//     stage, its "fancy" chroma upsampling and 14-bit YUV -> RGB (dithering is
//     off by default in libwebp);
//   * lossless bitstreams (RFC 9649 section 3): the four transforms, the
//     colour cache, the meta prefix codes, simple and normal prefix codes and
//     LZ77 references with the 120-entry distance map.
// Where the RFCs leave a choice to the decoder (the end of a partition, a
// predictor mode of 14 or 15, the loop filter when the frame's level is 0)
// the decoder does what libwebp does. Malformed or truncated files return 2
// with a message naming the chunk.
//
// Build: c++ -O2 -std=c++17 -shared -fPIC (ddgan_torch/ops/_cxx.py).

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

constexpr int kMalformed = 2;

struct Failure {
    int code;
    std::string what;
};

[[noreturn]] void malformed(const std::string& what) { throw Failure{kMalformed, what}; }

void set_error(char* err, size_t cap, const std::string& what) {
    if (err == nullptr || cap == 0) return;
    const size_t n = std::min(cap - 1, what.size());
    std::memcpy(err, what.data(), n);
    err[n] = '\0';
}

inline uint32_t le16(const uint8_t* p) { return p[0] | (p[1] << 8); }
inline uint32_t le24(const uint8_t* p) { return p[0] | (p[1] << 8) | (uint32_t(p[2]) << 16); }
inline uint32_t le32(const uint8_t* p) { return le24(p) | (uint32_t(p[3]) << 24); }

constexpr uint32_t fourcc(const char (&s)[5]) {
    return uint32_t(uint8_t(s[0])) | (uint32_t(uint8_t(s[1])) << 8) |
           (uint32_t(uint8_t(s[2])) << 16) | (uint32_t(uint8_t(s[3])) << 24);
}

std::string tag_name(uint32_t tag) {
    std::string s = "'";
    for (int i = 0; i < 4; ++i) {
        const char c = char((tag >> (8 * i)) & 0xff);
        s += (c >= 32 && c < 127) ? c : '?';
    }
    return s + "'";
}

// ---------------------------------------------------------------------------
// VP8 tables, from RFC 6386 (its reference decoder is BSD-licensed): the
// default coefficient probabilities (section 13.5), their update
// probabilities (13.4), the key-frame subblock mode probabilities (11.5),
// the dequantisation tables (14.1), the zigzag and band maps (13) and the
// DCT extra-bit probabilities (13.2). kBModesProba is indexed
// [above mode][left mode] in the order of BMode below, which lists RD, VR
// and LD where the RFC lists LD, RD and VR. The coefficient tables are
// [type][band][context][node], type 0 the luma AC after a Y2 block, 1 the
// Y2 block, 2 chroma, 3 luma with its DC.

const uint8_t kCoeffsProba0[4][8][3][11] = {
    {
        {
            {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
            {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
            {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
        },
        {
            {253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128},
            {189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128},
            {106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128},
        },
        {
            {  1,  98, 248, 255, 236, 226, 255, 255, 128, 128, 128},
            {181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128},
            { 78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128},
        },
        {
            {  1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128},
            {184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128},
            { 77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128},
        },
        {
            {  1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128},
            {170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128},
            { 37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128},
        },
        {
            {  1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128},
            {207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128},
            {102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128},
        },
        {
            {  1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128},
            {177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128},
            { 80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128},
        },
        {
            {  1,   1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
            {246,   1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
            {255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
        },
    },
    {
        {
            {198,  35, 237, 223, 193, 187, 162, 160, 145, 155,  62},
            {131,  45, 198, 221, 172, 176, 220, 157, 252, 221,   1},
            { 68,  47, 146, 208, 149, 167, 221, 162, 255, 223, 128},
        },
        {
            {  1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128},
            {184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128},
            { 81,  99, 181, 242, 176, 190, 249, 202, 255, 255, 128},
        },
        {
            {  1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128},
            { 99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128},
            { 23,  91, 163, 242, 170, 187, 247, 210, 255, 255, 128},
        },
        {
            {  1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128},
            {109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128},
            { 44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128},
        },
        {
            {  1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128},
            { 94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128},
            { 22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128},
        },
        {
            {  1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128},
            {124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128},
            { 35,  77, 181, 251, 193, 211, 255, 205, 128, 128, 128},
        },
        {
            {  1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128},
            {121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128},
            { 45,  99, 188, 251, 195, 217, 255, 224, 128, 128, 128},
        },
        {
            {  1,   1, 251, 255, 213, 255, 128, 128, 128, 128, 128},
            {203,   1, 248, 255, 255, 128, 128, 128, 128, 128, 128},
            {137,   1, 177, 255, 224, 255, 128, 128, 128, 128, 128},
        },
    },
    {
        {
            {253,   9, 248, 251, 207, 208, 255, 192, 128, 128, 128},
            {175,  13, 224, 243, 193, 185, 249, 198, 255, 255, 128},
            { 73,  17, 171, 221, 161, 179, 236, 167, 255, 234, 128},
        },
        {
            {  1,  95, 247, 253, 212, 183, 255, 255, 128, 128, 128},
            {239,  90, 244, 250, 211, 209, 255, 255, 128, 128, 128},
            {155,  77, 195, 248, 188, 195, 255, 255, 128, 128, 128},
        },
        {
            {  1,  24, 239, 251, 218, 219, 255, 205, 128, 128, 128},
            {201,  51, 219, 255, 196, 186, 128, 128, 128, 128, 128},
            { 69,  46, 190, 239, 201, 218, 255, 228, 128, 128, 128},
        },
        {
            {  1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128},
            {223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128},
            {141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128},
        },
        {
            {  1,  16, 248, 255, 255, 128, 128, 128, 128, 128, 128},
            {190,  36, 230, 255, 236, 255, 128, 128, 128, 128, 128},
            {149,   1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
        },
        {
            {  1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128},
            {247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128},
            {240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128},
        },
        {
            {  1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128},
            {213,  62, 250, 255, 255, 128, 128, 128, 128, 128, 128},
            { 55,  93, 255, 128, 128, 128, 128, 128, 128, 128, 128},
        },
        {
            {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
            {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
            {128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128},
        },
    },
    {
        {
            {202,  24, 213, 235, 186, 191, 220, 160, 240, 175, 255},
            {126,  38, 182, 232, 169, 184, 228, 174, 255, 187, 128},
            { 61,  46, 138, 219, 151, 178, 240, 170, 255, 216, 128},
        },
        {
            {  1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128},
            {166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128},
            { 39,  77, 162, 232, 172, 180, 245, 178, 255, 255, 128},
        },
        {
            {  1,  52, 220, 246, 198, 199, 249, 220, 255, 255, 128},
            {124,  74, 191, 243, 183, 193, 250, 221, 255, 255, 128},
            { 24,  71, 130, 219, 154, 170, 243, 182, 255, 255, 128},
        },
        {
            {  1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128},
            {149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128},
            { 28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128},
        },
        {
            {  1,  81, 230, 252, 204, 203, 255, 192, 128, 128, 128},
            {123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128},
            { 20,  95, 153, 243, 164, 173, 255, 203, 128, 128, 128},
        },
        {
            {  1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128},
            {168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128},
            { 47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128},
        },
        {
            {  1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128},
            {141,  84, 213, 252, 201, 202, 255, 219, 128, 128, 128},
            { 42,  80, 160, 240, 162, 185, 255, 205, 128, 128, 128},
        },
        {
            {  1,   1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
            {244,   1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
            {238,   1, 255, 128, 128, 128, 128, 128, 128, 128, 128},
        },
    },
};
const uint8_t kCoeffsUpdateProba[4][8][3][11] = {
    {
        {
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
        },
        {
            {176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255},
            {249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255},
        },
        {
            {255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255},
            {234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
            {253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
        },
        {
            {255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255},
            {239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
            {254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255},
        },
        {
            {255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255},
            {251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
        },
        {
            {255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
            {251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
            {254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255},
        },
        {
            {255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255},
            {250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255},
            {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
        },
        {
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
        },
    },
    {
        {
            {217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255},
            {234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255},
        },
        {
            {255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
            {238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255},
        },
        {
            {255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255},
            {249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
        },
        {
            {255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
        },
        {
            {255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
            {252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
        },
        {
            {255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
            {253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
        },
        {
            {255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255},
            {250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
        },
        {
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
        },
    },
    {
        {
            {186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255},
            {234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255},
            {251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255},
        },
        {
            {255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
            {236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
            {251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255},
        },
        {
            {255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
            {254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
        },
        {
            {255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
        },
        {
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
        },
        {
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
        },
        {
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
        },
        {
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
        },
    },
    {
        {
            {248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255},
            {248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255},
        },
        {
            {255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255},
            {246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255},
            {252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255},
        },
        {
            {255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255},
            {248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255},
            {253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255},
        },
        {
            {255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255},
            {245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255},
            {253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
        },
        {
            {255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255},
            {252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255},
        },
        {
            {255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255},
        },
        {
            {255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255},
            {250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
        },
        {
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
            {255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255},
        },
    },
};
const uint8_t kBModesProba[10][10][9] = {
    {
        {231, 120,  48,  89, 115, 113, 120, 152, 112},
        {152, 179,  64, 126, 170, 118,  46,  70,  95},
        {175,  69, 143,  80,  85,  82,  72, 155, 103},
        { 56,  58,  10, 171, 218, 189,  17,  13, 152},
        {114,  26,  17, 163,  44, 195,  21,  10, 173},
        {121,  24,  80, 195,  26,  62,  44,  64,  85},
        {144,  71,  10,  38, 171, 213, 144,  34,  26},
        {170,  46,  55,  19, 136, 160,  33, 206,  71},
        { 63,  20,   8, 114, 114, 208,  12,   9, 226},
        { 81,  40,  11,  96, 182,  84,  29,  16,  36},
    },
    {
        {134, 183,  89, 137,  98, 101, 106, 165, 148},
        { 72, 187, 100, 130, 157, 111,  32,  75,  80},
        { 66, 102, 167,  99,  74,  62,  40, 234, 128},
        { 41,  53,   9, 178, 241, 141,  26,   8, 107},
        { 74,  43,  26, 146,  73, 166,  49,  23, 157},
        { 65,  38, 105, 160,  51,  52,  31, 115, 128},
        {104,  79,  12,  27, 217, 255,  87,  17,   7},
        { 87,  68,  71,  44, 114,  51,  15, 186,  23},
        { 47,  41,  14, 110, 182, 183,  21,  17, 194},
        { 66,  45,  25, 102, 197, 189,  23,  18,  22},
    },
    {
        { 88,  88, 147, 150,  42,  46,  45, 196, 205},
        { 43,  97, 183, 117,  85,  38,  35, 179,  61},
        { 39,  53, 200,  87,  26,  21,  43, 232, 171},
        { 56,  34,  51, 104, 114, 102,  29,  93,  77},
        { 39,  28,  85, 171,  58, 165,  90,  98,  64},
        { 34,  22, 116, 206,  23,  34,  43, 166,  73},
        {107,  54,  32,  26,  51,   1,  81,  43,  31},
        { 68,  25, 106,  22,  64, 171,  36, 225, 114},
        { 34,  19,  21, 102, 132, 188,  16,  76, 124},
        { 62,  18,  78,  95,  85,  57,  50,  48,  51},
    },
    {
        {193, 101,  35, 159, 215, 111,  89,  46, 111},
        { 60, 148,  31, 172, 219, 228,  21,  18, 111},
        {112, 113,  77,  85, 179, 255,  38, 120, 114},
        { 40,  42,   1, 196, 245, 209,  10,  25, 109},
        { 88,  43,  29, 140, 166, 213,  37,  43, 154},
        { 61,  63,  30, 155,  67,  45,  68,   1, 209},
        {100,  80,   8,  43, 154,   1,  51,  26,  71},
        {142,  78,  78,  16, 255, 128,  34, 197, 171},
        { 41,  40,   5, 102, 211, 183,   4,   1, 221},
        { 51,  50,  17, 168, 209, 192,  23,  25,  82},
    },
    {
        {138,  31,  36, 171,  27, 166,  38,  44, 229},
        { 67,  87,  58, 169,  82, 115,  26,  59, 179},
        { 63,  59,  90, 180,  59, 166,  93,  73, 154},
        { 40,  40,  21, 116, 143, 209,  34,  39, 175},
        { 47,  15,  16, 183,  34, 223,  49,  45, 183},
        { 46,  17,  33, 183,   6,  98,  15,  32, 183},
        { 57,  46,  22,  24, 128,   1,  54,  17,  37},
        { 65,  32,  73, 115,  28, 128,  23, 128, 205},
        { 40,   3,   9, 115,  51, 192,  18,   6, 223},
        { 87,  37,   9, 115,  59,  77,  64,  21,  47},
    },
    {
        {104,  55,  44, 218,   9,  54,  53, 130, 226},
        { 64,  90,  70, 205,  40,  41,  23,  26,  57},
        { 54,  57, 112, 184,   5,  41,  38, 166, 213},
        { 30,  34,  26, 133, 152, 116,  10,  32, 134},
        { 39,  19,  53, 221,  26, 114,  32,  73, 255},
        { 31,   9,  65, 234,   2,  15,   1, 118,  73},
        { 75,  32,  12,  51, 192, 255, 160,  43,  51},
        { 88,  31,  35,  67, 102,  85,  55, 186,  85},
        { 56,  21,  23, 111,  59, 205,  45,  37, 192},
        { 55,  38,  70, 124,  73, 102,   1,  34,  98},
    },
    {
        {125,  98,  42,  88, 104,  85, 117, 175,  82},
        { 95,  84,  53,  89, 128, 100, 113, 101,  45},
        { 75,  79, 123,  47,  51, 128,  81, 171,   1},
        { 57,  17,   5,  71, 102,  57,  53,  41,  49},
        { 38,  33,  13, 121,  57,  73,  26,   1,  85},
        { 41,  10,  67, 138,  77, 110,  90,  47, 114},
        {115,  21,   2,  10, 102, 255, 166,  23,   6},
        {101,  29,  16,  10,  85, 128, 101, 196,  26},
        { 57,  18,  10, 102, 102, 213,  34,  20,  43},
        {117,  20,  15,  36, 163, 128,  68,   1,  26},
    },
    {
        {102,  61,  71,  37,  34,  53,  31, 243, 192},
        { 69,  60,  71,  38,  73, 119,  28, 222,  37},
        { 68,  45, 128,  34,   1,  47,  11, 245, 171},
        { 62,  17,  19,  70, 146,  85,  55,  62,  70},
        { 37,  43,  37, 154, 100, 163,  85, 160,   1},
        { 63,   9,  92, 136,  28,  64,  32, 201,  85},
        { 75,  15,   9,   9,  64, 255, 184, 119,  16},
        { 86,   6,  28,   5,  64, 255,  25, 248,   1},
        { 56,   8,  17, 132, 137, 255,  55, 116, 128},
        { 58,  15,  20,  82, 135,  57,  26, 121,  40},
    },
    {
        {164,  50,  31, 137, 154, 133,  25,  35, 218},
        { 51, 103,  44, 131, 131, 123,  31,   6, 158},
        { 86,  40,  64, 135, 148, 224,  45, 183, 128},
        { 22,  26,  17, 131, 240, 154,  14,   1, 209},
        { 45,  16,  21,  91,  64, 222,   7,   1, 197},
        { 56,  21,  39, 155,  60, 138,  23, 102, 213},
        { 83,  12,  13,  54, 192, 255,  68,  47,  28},
        { 85,  26,  85,  85, 128, 128,  32, 146, 171},
        { 18,  11,   7,  63, 144, 171,   4,   4, 246},
        { 35,  27,  10, 146, 174, 171,  12,  26, 128},
    },
    {
        {190,  80,  35,  99, 180,  80, 126,  54,  45},
        { 85, 126,  47,  87, 176,  51,  41,  20,  32},
        {101,  75, 128, 139, 118, 146, 116, 128,  85},
        { 56,  41,  15, 176, 236,  85,  37,   9,  62},
        { 71,  30,  17, 119, 118, 255,  17,  18, 138},
        {101,  38,  60, 138,  55,  70,  43,  26, 142},
        {146,  36,  19,  30, 171, 255,  97,  27,  20},
        {138,  45,  61,  62, 219,   1,  81, 188,  64},
        { 32,  41,  20, 117, 151, 142,  20,  21, 163},
        {112,  19,  12,  61, 195, 128,  48,   4,  24},
    },
};
const uint8_t kDcTable[128] = {
      4,   5,   6,   7,   8,   9,  10,  10,  11,  12,  13,  14,  15,  16,  17,  17,
     18,  19,  20,  20,  21,  21,  22,  22,  23,  23,  24,  25,  25,  26,  27,  28,
     29,  30,  31,  32,  33,  34,  35,  36,  37,  37,  38,  39,  40,  41,  42,  43,
     44,  45,  46,  46,  47,  48,  49,  50,  51,  52,  53,  54,  55,  56,  57,  58,
     59,  60,  61,  62,  63,  64,  65,  66,  67,  68,  69,  70,  71,  72,  73,  74,
     75,  76,  76,  77,  78,  79,  80,  81,  82,  83,  84,  85,  86,  87,  88,  89,
     91,  93,  95,  96,  98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
    122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157,
};
const uint16_t kAcTable[128] = {
      4,   5,   6,   7,   8,   9,  10,  11,  12,  13,  14,  15,  16,  17,  18,  19,
     20,  21,  22,  23,  24,  25,  26,  27,  28,  29,  30,  31,  32,  33,  34,  35,
     36,  37,  38,  39,  40,  41,  42,  43,  44,  45,  46,  47,  48,  49,  50,  51,
     52,  53,  54,  55,  56,  57,  58,  60,  62,  64,  66,  68,  70,  72,  74,  76,
     78,  80,  82,  84,  86,  88,  90,  92,  94,  96,  98, 100, 102, 104, 106, 108,
    110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
    155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
    213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284,
};

const uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};

// the band of each coefficient position, with a 17th entry for the position
// after the last
const uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};

const uint8_t kCat3[] = {173, 148, 140, 0};
const uint8_t kCat4[] = {176, 155, 140, 135, 0};
const uint8_t kCat5[] = {180, 157, 141, 134, 130, 0};
const uint8_t kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
const uint8_t* const kCat3456[] = {kCat3, kCat4, kCat5, kCat6};

// ---------------------------------------------------------------------------
// The RIFF container.

constexpr uint32_t kRIFF = fourcc("RIFF");
constexpr uint32_t kWEBP = fourcc("WEBP");
constexpr uint32_t kVP8 = fourcc("VP8 ");
constexpr uint32_t kVP8L = fourcc("VP8L");
constexpr uint32_t kVP8X = fourcc("VP8X");
constexpr uint32_t kALPH = fourcc("ALPH");
constexpr uint32_t kANIM = fourcc("ANIM");
constexpr uint32_t kANMF = fourcc("ANMF");

constexpr uint8_t kAnimationFlag = 0x02;
constexpr uint8_t kValidFlags = 0x3e;  // animation, XMP, EXIF, alpha, ICC

// One image bitstream: the payload of a VP8 or a VP8L chunk.
struct Bitstream {
    const uint8_t* data = nullptr;
    size_t size = 0;
    bool lossless = false;
    int width = 0, height = 0;
};

// What a file shows: its canvas and the image placed on it (a still image
// fills its canvas; an animation shows frame 0 at its offset).
struct Picture {
    int canvas_w = 0, canvas_h = 0;
    int x_off = 0, y_off = 0;
    Bitstream image;
};

// A VP8 key frame's 10-byte header: the frame tag, the start code and the
// 14-bit sizes (the top two bits of each are the scale, which is ignored).
void vp8_frame_size(const uint8_t* p, size_t size, int* width, int* height) {
    if (size < 10) malformed("the 'VP8 ' chunk is shorter than its 10-byte frame header");
    const uint32_t bits = le24(p);
    if (bits & 1) malformed("the 'VP8 ' chunk holds an inter frame, not a key frame");
    if (((bits >> 1) & 7) > 3) malformed("the 'VP8 ' chunk has an unknown profile");
    if (!((bits >> 4) & 1)) malformed("the 'VP8 ' chunk's frame is not shown");
    if ((bits >> 5) >= size) malformed("the 'VP8 ' chunk's first partition runs past the chunk");
    if (p[3] != 0x9d || p[4] != 0x01 || p[5] != 0x2a)
        malformed("the 'VP8 ' chunk has no start code 9d 01 2a");
    *width = int(le16(p + 6) & 0x3fff);
    *height = int(le16(p + 8) & 0x3fff);
    if (*width == 0 || *height == 0) malformed("the 'VP8 ' chunk has a width or height of 0");
}

// A VP8L header: the signature byte, 14-bit sizes less one, the alpha hint
// and a 3-bit version that must be 0.
void vp8l_frame_size(const uint8_t* p, size_t size, int* width, int* height) {
    if (size < 5) malformed("the 'VP8L' chunk is shorter than its 5-byte header");
    if (p[0] != 0x2f) malformed("the 'VP8L' chunk does not start with the signature 0x2f");
    const uint32_t bits = le32(p + 1);
    if (bits >> 29) malformed("the 'VP8L' chunk has a version other than 0");
    *width = int(bits & 0x3fff) + 1;
    *height = int((bits >> 14) & 0x3fff) + 1;
}

Bitstream image_chunk(uint32_t tag, const uint8_t* payload, uint32_t size) {
    Bitstream b;
    b.data = payload;
    b.size = size;
    b.lossless = tag == kVP8L;
    if (b.lossless)
        vp8l_frame_size(payload, size, &b.width, &b.height);
    else
        vp8_frame_size(payload, size, &b.width, &b.height);
    return b;
}

// Walks the chunks of [p, end): each an 8-byte header (fourcc, little-endian
// size) and its payload padded to an even size, all inside the range.
struct Chunks {
    const uint8_t* p;
    const uint8_t* end;
    const char* where;

    bool next(uint32_t* tag, const uint8_t** payload, uint32_t* size) {
        if (p == end) return false;
        if (end - p < 8) malformed(std::string("a chunk header in ") + where + " is truncated");
        *tag = le32(p);
        *size = le32(p + 4);
        const uint64_t padded = uint64_t(*size) + (*size & 1);
        if (padded > uint64_t(end - p - 8))
            malformed("the " + tag_name(*tag) + " chunk (" + std::to_string(*size) +
                      " bytes, padded to even) runs past the end of " + where);
        *payload = p + 8;
        p += 8 + padded;
        return true;
    }
};

// An ANMF payload: 24-bit x/2, y/2, width-1, height-1 and duration, a flags
// byte, then an optional ALPH chunk and one VP8 or VP8L chunk.
void anmf_frame(const uint8_t* p, uint32_t size, int* x, int* y, Bitstream* image) {
    if (size < 16) malformed("an 'ANMF' chunk is shorter than its 16-byte header");
    *x = 2 * int(le24(p));
    *y = 2 * int(le24(p + 3));
    const int w = 1 + int(le24(p + 6));
    const int h = 1 + int(le24(p + 9));
    Chunks sub{p + 16, p + size, "an 'ANMF' chunk"};
    uint32_t tag, n;
    const uint8_t* payload;
    bool alpha = false, found = false;
    while (sub.next(&tag, &payload, &n)) {
        if (tag == kALPH) {
            if (found) malformed("an 'ALPH' chunk follows the image in an 'ANMF' chunk");
            alpha = true;
        } else if (tag == kVP8 || tag == kVP8L) {
            if (found) malformed("an 'ANMF' chunk holds two images");
            if (tag == kVP8L && alpha) malformed("an 'ANMF' chunk holds 'ALPH' before 'VP8L'");
            *image = image_chunk(tag, payload, n);
            found = true;
        }
    }
    if (!found) malformed("an 'ANMF' chunk holds no 'VP8 ' or 'VP8L' chunk");
    if (image->width != w || image->height != h)
        malformed("an 'ANMF' chunk says " + std::to_string(w) + "x" + std::to_string(h) +
                  " but its image is " + std::to_string(image->width) + "x" +
                  std::to_string(image->height));
}

Picture parse_container(const uint8_t* data, size_t size) {
    if (size < 12) malformed("the file is shorter than the 12-byte RIFF header");
    if (le32(data) != kRIFF || le32(data + 8) != kWEBP) malformed("not a RIFF WEBP file");
    const uint32_t riff = le32(data + 4);
    if (riff < 12) malformed("the 'RIFF' size " + std::to_string(riff) + " is below 12");
    if (uint64_t(riff) > uint64_t(size) - 8)
        malformed("the file is truncated: 'RIFF' says " + std::to_string(riff + 8ull) +
                  " bytes, " + std::to_string(size) + " are present");
    Chunks chunks{data + 12, data + 8 + riff, "the 'RIFF' chunk"};
    uint32_t tag, n;
    const uint8_t* payload;
    Picture pic;
    if (!chunks.next(&tag, &payload, &n)) malformed("the 'RIFF' chunk holds no chunk");
    if (tag == kVP8 || tag == kVP8L) {  // a simple file; later chunks are ignored
        pic.image = image_chunk(tag, payload, n);
        pic.canvas_w = pic.image.width;
        pic.canvas_h = pic.image.height;
        return pic;
    }
    if (tag != kVP8X)
        malformed("the first chunk is " + tag_name(tag) + ", not 'VP8 ', 'VP8L' or 'VP8X'");
    if (n != 10) malformed("the 'VP8X' chunk has " + std::to_string(n) + " bytes, not 10");
    const uint8_t flags = payload[0];
    if (flags & ~kValidFlags) malformed("the 'VP8X' chunk sets reserved flag bits");
    const bool animated = flags & kAnimationFlag;
    pic.canvas_w = 1 + int(le24(payload + 4));
    pic.canvas_h = 1 + int(le24(payload + 7));
    if (uint64_t(pic.canvas_w) * uint64_t(pic.canvas_h) >= (uint64_t(1) << 32))
        malformed("the 'VP8X' canvas is too large");
    bool alpha = false, found = false, anim = false;
    while (chunks.next(&tag, &payload, &n)) {
        if (tag == kALPH || tag == kVP8 || tag == kVP8L) {
            if (animated) malformed("an animation holds " + tag_name(tag) + " outside 'ANMF'");
            if (found) malformed("the file holds a second image chunk " + tag_name(tag));
            if (tag == kALPH) {
                alpha = true;
                continue;
            }
            if (tag == kVP8L && alpha) malformed("the file holds 'ALPH' before 'VP8L'");
            pic.image = image_chunk(tag, payload, n);
            found = true;
        } else if (tag == kANIM) {
            if (n < 6) malformed("the 'ANIM' chunk is shorter than 6 bytes");
            anim = true;
        } else if (tag == kANMF) {
            if (!animated) malformed("an 'ANMF' chunk in a file whose 'VP8X' flags no animation");
            if (!anim) malformed("an 'ANMF' chunk comes before the 'ANIM' chunk");
            int x, y;
            Bitstream image;
            anmf_frame(payload, n, &x, &y, &image);
            if (x + image.width > pic.canvas_w || y + image.height > pic.canvas_h)
                malformed("an 'ANMF' frame lies outside the 'VP8X' canvas");
            if (!found) {
                pic.image = image;
                pic.x_off = x;
                pic.y_off = y;
                found = true;
            }
        }  // ICCP, EXIF, XMP and unknown chunks are skipped
    }
    if (!found)
        malformed(animated ? "the animation holds no 'ANMF' frame"
                           : "the 'VP8X' file holds no 'VP8 ' or 'VP8L' chunk");
    if (!animated && (pic.image.width != pic.canvas_w || pic.image.height != pic.canvas_h))
        malformed("the 'VP8X' canvas is " + std::to_string(pic.canvas_w) + "x" +
                  std::to_string(pic.canvas_h) + " but its image is " +
                  std::to_string(pic.image.width) + "x" + std::to_string(pic.image.height));
    return pic;
}

// ---------------------------------------------------------------------------
// VP8: the boolean decoder (RFC 6386 section 7), in libwebp's form: `range_`
// holds the range less one and `value_` the unread bits, `bits_` of them
// beyond the 8 compared. Past the end of its partition it reads zeros once
// and marks end of data, as libwebp does.

class BoolReader {
public:
    void init(const uint8_t* p, size_t n) {
        buf_ = p;
        end_ = p + n;
        value_ = 0;
        bits_ = -8;
        range_ = 254;
        eof_ = false;
        load();
    }

    int bit(int prob) {
        if (bits_ < 0) load();
        uint32_t range = range_;
        const uint32_t split = (range * uint32_t(prob)) >> 8;
        const uint32_t value = uint32_t(value_ >> bits_);
        int b;
        if (value > split) {
            range -= split;
            value_ -= uint64_t(split + 1) << bits_;
            b = 1;
        } else {
            range = split + 1;
            b = 0;
        }
        const int shift = 7 ^ (31 - __builtin_clz(range));
        range <<= shift;
        bits_ -= shift;
        range_ = range - 1;
        return b;
    }

    uint32_t literal(int n) {  // n bits, most significant first
        uint32_t v = 0;
        while (n-- > 0) v |= uint32_t(bit(0x80)) << n;
        return v;
    }

    int signed_literal(int n) {
        const int v = int(literal(n));
        return bit(0x80) ? -v : v;
    }

    bool eof() const { return eof_; }

private:
    void load() {
        if (end_ - buf_ >= 8) {  // seven bytes at once
            uint64_t v = 0;
            for (int i = 0; i < 7; ++i) v = (v << 8) | buf_[i];
            buf_ += 7;
            value_ = (value_ << 56) | v;
            bits_ += 56;
        } else if (buf_ < end_) {
            value_ = (value_ << 8) | *buf_++;
            bits_ += 8;
        } else if (!eof_) {
            value_ <<= 8;
            bits_ += 8;
            eof_ = true;
        } else {
            bits_ = 0;
        }
    }

    const uint8_t* buf_ = nullptr;
    const uint8_t* end_ = nullptr;
    uint64_t value_ = 0;
    int bits_ = 0;
    uint32_t range_ = 254;
    bool eof_ = false;
};

// Intra modes, in libwebp's order (see kBModesProba). The 16x16 and chroma
// modes are DC, TM, V (VE) and H (HE); the three DC variants for missing
// edges follow the subblock modes.
enum BMode {
    B_DC_PRED = 0, B_TM_PRED, B_VE_PRED, B_HE_PRED, B_RD_PRED,
    B_VR_PRED, B_LD_PRED, B_VL_PRED, B_HD_PRED, B_HU_PRED,
    DC_PRED_NOTOP = 10, DC_PRED_NOLEFT, DC_PRED_NOTOPLEFT,
};

constexpr int BPS = 32;                    // stride of the reconstruction buffer
constexpr int Y_OFF = BPS * 1 + 8;         // its luma block, with a row above
constexpr int U_OFF = Y_OFF + BPS * 16 + BPS;
constexpr int V_OFF = U_OFF + 16;
constexpr int YUV_SIZE = BPS * 17 + BPS * 9;

inline uint8_t clip8(int v) { return uint8_t(v < 0 ? 0 : v > 255 ? 255 : v); }

inline int avg3(int a, int b, int c) { return (a + 2 * b + c + 2) >> 2; }
inline int avg2(int a, int b) { return (a + b + 1) >> 1; }

void fill(uint8_t* dst, int size, int v) {
    for (int j = 0; j < size; ++j) std::memset(dst + j * BPS, v, size);
}

void true_motion(uint8_t* dst, int size) {
    const uint8_t* top = dst - BPS;
    const int tl = top[-1];
    for (int y = 0; y < size; ++y) {
        const int left = dst[-1 + y * BPS];
        for (int x = 0; x < size; ++x) dst[x + y * BPS] = clip8(top[x] + left - tl);
    }
}

void vertical(uint8_t* dst, int size) {
    for (int j = 0; j < size; ++j) std::memcpy(dst + j * BPS, dst - BPS, size);
}

void horizontal(uint8_t* dst, int size) {
    for (int j = 0; j < size; ++j) std::memset(dst + j * BPS, dst[j * BPS - 1], size);
}

// 16x16 (size 16, shift 5) and chroma (size 8, shift 4) predictions; DC uses
// only the edges that exist, or 128.
void predict_block(uint8_t* dst, int mode, int size, int shift) {
    switch (mode) {
        case B_DC_PRED: {
            int dc = size;
            for (int j = 0; j < size; ++j) dc += dst[j * BPS - 1] + dst[j - BPS];
            fill(dst, size, dc >> shift);
            break;
        }
        case DC_PRED_NOTOP: {
            int dc = size >> 1;
            for (int j = 0; j < size; ++j) dc += dst[j * BPS - 1];
            fill(dst, size, dc >> (shift - 1));
            break;
        }
        case DC_PRED_NOLEFT: {
            int dc = size >> 1;
            for (int j = 0; j < size; ++j) dc += dst[j - BPS];
            fill(dst, size, dc >> (shift - 1));
            break;
        }
        case DC_PRED_NOTOPLEFT: fill(dst, size, 0x80); break;
        case B_TM_PRED: true_motion(dst, size); break;
        case B_VE_PRED: vertical(dst, size); break;
        case B_HE_PRED: horizontal(dst, size); break;
        default: malformed("a 16x16 or chroma mode out of range");
    }
}

#define DST(x, y) dst[(x) + (y) * BPS]

// 4x4 subblock predictions (RFC 6386 section 12.3), reading the row above
// with the four pixels above-right, and the column to the left.
void predict4(uint8_t* dst, int mode) {
    const uint8_t* top = dst - BPS;
    const int X = top[-1], A = top[0], B = top[1], C = top[2], D = top[3];
    const int E = top[4], F = top[5], G = top[6], H = top[7];
    const int I = dst[-1], J = dst[-1 + BPS], K = dst[-1 + 2 * BPS], L = dst[-1 + 3 * BPS];
    switch (mode) {
        case B_DC_PRED: {
            int dc = 4;
            for (int i = 0; i < 4; ++i) dc += top[i] + dst[-1 + i * BPS];
            fill(dst, 4, dc >> 3);
            break;
        }
        case B_TM_PRED: true_motion(dst, 4); break;
        case B_VE_PRED: {
            const uint8_t v[4] = {uint8_t(avg3(X, A, B)), uint8_t(avg3(A, B, C)),
                                  uint8_t(avg3(B, C, D)), uint8_t(avg3(C, D, E))};
            for (int j = 0; j < 4; ++j) std::memcpy(dst + j * BPS, v, 4);
            break;
        }
        case B_HE_PRED: {
            std::memset(dst, avg3(X, I, J), 4);
            std::memset(dst + BPS, avg3(I, J, K), 4);
            std::memset(dst + 2 * BPS, avg3(J, K, L), 4);
            std::memset(dst + 3 * BPS, avg3(K, L, L), 4);
            break;
        }
        case B_RD_PRED:
            DST(0, 3) = avg3(J, K, L);
            DST(1, 3) = DST(0, 2) = avg3(I, J, K);
            DST(2, 3) = DST(1, 2) = DST(0, 1) = avg3(X, I, J);
            DST(3, 3) = DST(2, 2) = DST(1, 1) = DST(0, 0) = avg3(A, X, I);
            DST(3, 2) = DST(2, 1) = DST(1, 0) = avg3(B, A, X);
            DST(3, 1) = DST(2, 0) = avg3(C, B, A);
            DST(3, 0) = avg3(D, C, B);
            break;
        case B_LD_PRED:
            DST(0, 0) = avg3(A, B, C);
            DST(1, 0) = DST(0, 1) = avg3(B, C, D);
            DST(2, 0) = DST(1, 1) = DST(0, 2) = avg3(C, D, E);
            DST(3, 0) = DST(2, 1) = DST(1, 2) = DST(0, 3) = avg3(D, E, F);
            DST(3, 1) = DST(2, 2) = DST(1, 3) = avg3(E, F, G);
            DST(3, 2) = DST(2, 3) = avg3(F, G, H);
            DST(3, 3) = avg3(G, H, H);
            break;
        case B_VR_PRED:
            DST(0, 0) = DST(1, 2) = avg2(X, A);
            DST(1, 0) = DST(2, 2) = avg2(A, B);
            DST(2, 0) = DST(3, 2) = avg2(B, C);
            DST(3, 0) = avg2(C, D);
            DST(0, 3) = avg3(K, J, I);
            DST(0, 2) = avg3(J, I, X);
            DST(0, 1) = DST(1, 3) = avg3(I, X, A);
            DST(1, 1) = DST(2, 3) = avg3(X, A, B);
            DST(2, 1) = DST(3, 3) = avg3(A, B, C);
            DST(3, 1) = avg3(B, C, D);
            break;
        case B_VL_PRED:
            DST(0, 0) = avg2(A, B);
            DST(1, 0) = DST(0, 2) = avg2(B, C);
            DST(2, 0) = DST(1, 2) = avg2(C, D);
            DST(3, 0) = DST(2, 2) = avg2(D, E);
            DST(0, 1) = avg3(A, B, C);
            DST(1, 1) = DST(0, 3) = avg3(B, C, D);
            DST(2, 1) = DST(1, 3) = avg3(C, D, E);
            DST(3, 1) = DST(2, 3) = avg3(D, E, F);
            DST(3, 2) = avg3(E, F, G);
            DST(3, 3) = avg3(F, G, H);
            break;
        case B_HD_PRED:
            DST(0, 0) = DST(2, 1) = avg2(I, X);
            DST(0, 1) = DST(2, 2) = avg2(J, I);
            DST(0, 2) = DST(2, 3) = avg2(K, J);
            DST(0, 3) = avg2(L, K);
            DST(3, 0) = avg3(A, B, C);
            DST(2, 0) = avg3(X, A, B);
            DST(1, 0) = DST(3, 1) = avg3(I, X, A);
            DST(1, 1) = DST(3, 2) = avg3(J, I, X);
            DST(1, 2) = DST(3, 3) = avg3(K, J, I);
            DST(1, 3) = avg3(L, K, J);
            break;
        case B_HU_PRED:
            DST(0, 0) = avg2(I, J);
            DST(2, 0) = DST(0, 1) = avg2(J, K);
            DST(2, 1) = DST(0, 2) = avg2(K, L);
            DST(1, 0) = avg3(I, J, K);
            DST(3, 0) = DST(1, 1) = avg3(J, K, L);
            DST(3, 1) = DST(1, 2) = avg3(K, L, L);
            DST(3, 2) = DST(2, 2) = DST(0, 3) = DST(1, 3) = DST(2, 3) = DST(3, 3) = L;
            break;
        default: malformed("a subblock mode out of range");
    }
}

#undef DST

// The inverse DCT of one 4x4 block (RFC 6386 section 14.3), added to the
// prediction: columns first, then rows with the rounding 4 and the shift 3.
inline int mul1(int a) { return ((a * 20091) >> 16) + a; }
inline int mul2(int a) { return (a * 35468) >> 16; }

void inverse_dct_add(const int16_t* in, uint8_t* dst) {
    int tmp[16];
    for (int i = 0; i < 4; ++i) {
        const int a = in[i] + in[8 + i];
        const int b = in[i] - in[8 + i];
        const int c = mul2(in[4 + i]) - mul1(in[12 + i]);
        const int d = mul1(in[4 + i]) + mul2(in[12 + i]);
        tmp[4 * i + 0] = a + d;
        tmp[4 * i + 1] = b + c;
        tmp[4 * i + 2] = b - c;
        tmp[4 * i + 3] = a - d;
    }
    for (int i = 0; i < 4; ++i, dst += BPS) {
        const int dc = tmp[i] + 4;
        const int a = dc + tmp[8 + i];
        const int b = dc - tmp[8 + i];
        const int c = mul2(tmp[4 + i]) - mul1(tmp[12 + i]);
        const int d = mul1(tmp[4 + i]) + mul2(tmp[12 + i]);
        dst[0] = clip8(dst[0] + ((a + d) >> 3));
        dst[1] = clip8(dst[1] + ((b + c) >> 3));
        dst[2] = clip8(dst[2] + ((b - c) >> 3));
        dst[3] = clip8(dst[3] + ((a - d) >> 3));
    }
}

// The inverse WHT of the Y2 block (section 14.3) into the DC of the 16 luma
// blocks (out[16 * n]).
void inverse_wht(const int16_t* in, int16_t* out) {
    int tmp[16];
    for (int i = 0; i < 4; ++i) {
        const int a0 = in[i] + in[12 + i];
        const int a1 = in[4 + i] + in[8 + i];
        const int a2 = in[4 + i] - in[8 + i];
        const int a3 = in[i] - in[12 + i];
        tmp[i] = a0 + a1;
        tmp[8 + i] = a0 - a1;
        tmp[4 + i] = a3 + a2;
        tmp[12 + i] = a3 - a2;
    }
    for (int i = 0; i < 4; ++i, out += 64) {
        const int dc = tmp[4 * i] + 3;
        const int a0 = dc + tmp[4 * i + 3];
        const int a1 = tmp[4 * i + 1] + tmp[4 * i + 2];
        const int a2 = tmp[4 * i + 1] - tmp[4 * i + 2];
        const int a3 = dc - tmp[4 * i + 3];
        out[0] = int16_t((a0 + a1) >> 3);
        out[16] = int16_t((a3 + a2) >> 3);
        out[32] = int16_t((a0 - a1) >> 3);
        out[48] = int16_t((a3 - a2) >> 3);
    }
}

// The loop filters (section 15), on pixels p with `step` across the edge.
inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }  // [-1020, 1020]
inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }      // [-112, 112]

inline void filter2(uint8_t* p, int step) {  // 4 pixels in, 2 out
    const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
    const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
    const int a1 = sclip2((a + 4) >> 3);
    const int a2 = sclip2((a + 3) >> 3);
    p[-step] = clip8(p0 + a2);
    p[0] = clip8(q0 - a1);
}

inline void filter4(uint8_t* p, int step) {  // 4 pixels in, 4 out
    const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
    const int a = 3 * (q0 - p0);
    const int a1 = sclip2((a + 4) >> 3);
    const int a2 = sclip2((a + 3) >> 3);
    const int a3 = (a1 + 1) >> 1;
    p[-2 * step] = clip8(p1 + a3);
    p[-step] = clip8(p0 + a2);
    p[0] = clip8(q0 - a1);
    p[step] = clip8(q1 - a3);
}

inline void filter6(uint8_t* p, int step) {  // 6 pixels in, 6 out
    const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
    const int q0 = p[0], q1 = p[step], q2 = p[2 * step];
    const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
    const int a1 = (27 * a + 63) >> 7;
    const int a2 = (18 * a + 63) >> 7;
    const int a3 = (9 * a + 63) >> 7;
    p[-3 * step] = clip8(p2 + a3);
    p[-2 * step] = clip8(p1 + a2);
    p[-step] = clip8(p0 + a1);
    p[0] = clip8(q0 - a1);
    p[step] = clip8(q1 - a2);
    p[2 * step] = clip8(q2 - a3);
}

inline bool high_edge_variance(const uint8_t* p, int step, int thresh) {
    return std::abs(p[-2 * step] - p[-step]) > thresh || std::abs(p[step] - p[0]) > thresh;
}

// 4|p0 - q0| + |p1 - q1| <= 2 * limit + 1 is the RFC's 2|p0 - q0| + |p1 - q1| / 2 <= limit
inline bool needs_filter(const uint8_t* p, int step, int t2) {
    return 4 * std::abs(p[-step] - p[0]) + std::abs(p[-2 * step] - p[step]) <= t2;
}

inline bool needs_filter2(const uint8_t* p, int step, int t2, int it) {
    const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
    const int q0 = p[0], q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
    if (4 * std::abs(p0 - q0) + std::abs(p1 - q1) > t2) return false;
    return std::abs(p3 - p2) <= it && std::abs(p2 - p1) <= it && std::abs(p1 - p0) <= it &&
           std::abs(q3 - q2) <= it && std::abs(q2 - q1) <= it && std::abs(q1 - q0) <= it;
}

// The simple filter across one edge of 16 pixels: `step` crosses the edge,
// `along` walks it.
void simple_edge(uint8_t* p, int step, int along, int limit) {
    const int t2 = 2 * limit + 1;
    for (int i = 0; i < 16; ++i, p += along)
        if (needs_filter(p, step, t2)) filter2(p, step);
}

// The normal filter across one edge of `size` pixels; macroblock edges
// (`mb_edge`) take the 6-tap filter where the variance is low.
void normal_edge(uint8_t* p, int step, int along, int size, int limit, int ilevel,
                 int hev_thresh, bool mb_edge) {
    const int t2 = 2 * limit + 1;
    for (int i = 0; i < size; ++i, p += along) {
        if (!needs_filter2(p, step, t2, ilevel)) continue;
        if (high_edge_variance(p, step, hev_thresh))
            filter2(p, step);
        else if (mb_edge)
            filter6(p, step);
        else
            filter4(p, step);
    }
}

struct FilterInfo {
    int limit = 0;  // 2 * level + ilevel; 0 turns the filter off
    int ilevel = 0;
    int hev_thresh = 0;
    bool inner = false;  // filter the inner edges
};

struct QuantMatrix {
    int y1[2], y2[2], uv[2];  // DC, AC
};

struct MacroBlock {  // one macroblock's modes and coefficients
    int segment = 0;
    bool skip = false;
    bool is_i4x4 = false;
    uint8_t imodes[16] = {};  // the 4x4 modes, or imodes[0] the 16x16 mode
    uint8_t uvmode = 0;
    int16_t coeffs[384];      // 16 luma, 4 U and 4 V blocks of 16
    uint32_t nz_y = 0;        // a bit for each luma block with a non-zero coefficient
    uint32_t nz_uv = 0;       // the same for the 4 U (bits 0-3) and 4 V (bits 4-7) blocks
};

struct TopSamples {
    uint8_t y[16], u[8], v[8];
};

// The non-zero context of a macroblock's edge blocks in libwebp's layout:
// `nz` bits 0-3 the luma blocks, 4-5 U, 6-7 V; `nz_dc` the Y2 block.
struct NzContext {
    uint8_t nz = 0, nz_dc = 0;
};

class VP8Decoder {
public:
    VP8Decoder(const uint8_t* data, size_t size) { parse_headers(data, size); }

    // Decode every macroblock into the 16x16-aligned planes y_, u_, v_.
    void decode();

    // The planes cropped to width x height and (width+1)/2 x (height+1)/2.
    void copy_planes(uint8_t* y, uint8_t* u, uint8_t* v) const;

    // libwebp's output stage: fancy upsampling and YUV -> RGB into rows of
    // `stride` bytes.
    void to_rgb(uint8_t* out, size_t stride) const;

    int width = 0, height = 0;

private:
    void parse_headers(const uint8_t* data, size_t size);
    void parse_segment_header();
    void parse_filter_header();
    void parse_partitions(const uint8_t* buf, size_t size);
    void parse_quant();
    void parse_proba();
    void precompute_filter_strengths();
    void parse_intra_modes(MacroBlock* block, int mb_x);
    bool parse_residuals(MacroBlock* block, int mb_x, BoolReader* br);
    int get_coeffs(BoolReader* br, int type, int ctx, const int* dq, int n, int16_t* out);
    void reconstruct_row(int mb_y);
    void filter_row(int mb_y);

    BoolReader br_;
    BoolReader parts_[8];
    int num_parts_ = 1;
    int mb_w_ = 0, mb_h_ = 0;

    // segment header
    bool use_segment_ = false, update_map_ = false, absolute_delta_ = true;
    int seg_quant_[4] = {}, seg_filter_[4] = {};
    uint8_t seg_proba_[3] = {255, 255, 255};
    // filter header
    bool simple_ = false, use_lf_delta_ = false;
    int level_ = 0, sharpness_ = 0;
    int ref_lf_delta_[4] = {}, mode_lf_delta_[4] = {};
    int filter_type_ = 0;  // 0 off, 1 simple, 2 normal
    FilterInfo fstrengths_[4][2];

    QuantMatrix dqm_[4];
    uint8_t proba_[4][8][3][11];
    bool use_skip_proba_ = false;
    int skip_p_ = 0;

    std::vector<uint8_t> intra_t_;   // the 4x4 modes along the bottom of the row above
    uint8_t intra_l_[4];             // and along the right of the macroblock to the left
    std::vector<NzContext> nz_;      // nz_[0] is the left context, nz_[1 + x] the top
    std::vector<TopSamples> top_;    // the unfiltered bottom samples of the row above
    std::vector<MacroBlock> row_;    // the current row's macroblocks
    std::vector<FilterInfo> finfo_;
    uint8_t yuv_b_[YUV_SIZE];

    int y_stride_ = 0, uv_stride_ = 0;
    std::vector<uint8_t> y_, u_, v_;
};

void VP8Decoder::parse_headers(const uint8_t* data, size_t size) {
    vp8_frame_size(data, size, &width, &height);
    const uint32_t partition_length = le24(data) >> 5;
    mb_w_ = (width + 15) >> 4;
    mb_h_ = (height + 15) >> 4;
    data += 10;
    size -= 10;
    if (partition_length > size) malformed("the 'VP8 ' chunk's first partition runs past the chunk");
    br_.init(data, partition_length);
    data += partition_length;
    size -= partition_length;
    br_.literal(1);  // colour space
    br_.literal(1);  // clamping type (libwebp always clamps)
    parse_segment_header();
    parse_filter_header();
    parse_partitions(data, size);
    parse_quant();
    br_.literal(1);  // refresh_entropy_probs: a key frame has nothing to keep
    parse_proba();
}

void VP8Decoder::parse_segment_header() {
    use_segment_ = br_.literal(1);
    if (use_segment_) {
        update_map_ = br_.literal(1);
        if (br_.literal(1)) {  // update the segment data
            absolute_delta_ = br_.literal(1);
            for (int s = 0; s < 4; ++s) seg_quant_[s] = br_.literal(1) ? br_.signed_literal(7) : 0;
            for (int s = 0; s < 4; ++s) seg_filter_[s] = br_.literal(1) ? br_.signed_literal(6) : 0;
        }
        if (update_map_)
            for (int s = 0; s < 3; ++s) seg_proba_[s] = br_.literal(1) ? uint8_t(br_.literal(8)) : 255;
    }
    if (br_.eof()) malformed("the 'VP8 ' segment header is truncated");
}

void VP8Decoder::parse_filter_header() {
    simple_ = br_.literal(1);
    level_ = int(br_.literal(6));
    sharpness_ = int(br_.literal(3));
    use_lf_delta_ = br_.literal(1);
    if (use_lf_delta_ && br_.literal(1)) {  // update the deltas
        for (int i = 0; i < 4; ++i)
            if (br_.literal(1)) ref_lf_delta_[i] = br_.signed_literal(6);
        for (int i = 0; i < 4; ++i)
            if (br_.literal(1)) mode_lf_delta_[i] = br_.signed_literal(6);
    }
    // libwebp filters nothing when the frame's level is 0, whatever the segments say
    filter_type_ = level_ == 0 ? 0 : simple_ ? 1 : 2;
    if (br_.eof()) malformed("the 'VP8 ' filter header is truncated");
}

// The token partitions: 1, 2, 4 or 8, each size but the last's in 3 bytes
// (clamped to what is left, as libwebp does); the last must not be empty.
void VP8Decoder::parse_partitions(const uint8_t* buf, size_t size) {
    num_parts_ = 1 << br_.literal(2);
    const size_t last = size_t(num_parts_ - 1);
    if (size < 3 * last) malformed("the 'VP8 ' token partition sizes are truncated");
    const uint8_t* sz = buf;
    const uint8_t* part = buf + 3 * last;
    size_t left = size - 3 * last;
    for (size_t p = 0; p < last; ++p, sz += 3) {
        const size_t psize = std::min<size_t>(le24(sz), left);
        parts_[p].init(part, psize);
        part += psize;
        left -= psize;
    }
    parts_[last].init(part, left);
    if (part >= buf + size) malformed("the 'VP8 ' chunk's last token partition is empty");
}

void VP8Decoder::parse_quant() {
    const int base_q0 = int(br_.literal(7));
    const int dqy1_dc = br_.literal(1) ? br_.signed_literal(4) : 0;
    const int dqy2_dc = br_.literal(1) ? br_.signed_literal(4) : 0;
    const int dqy2_ac = br_.literal(1) ? br_.signed_literal(4) : 0;
    const int dquv_dc = br_.literal(1) ? br_.signed_literal(4) : 0;
    const int dquv_ac = br_.literal(1) ? br_.signed_literal(4) : 0;
    auto clip = [](int v, int m) { return v < 0 ? 0 : v > m ? m : v; };
    for (int i = 0; i < 4; ++i) {
        int q;
        if (use_segment_) {
            q = seg_quant_[i] + (absolute_delta_ ? 0 : base_q0);
        } else if (i > 0) {
            dqm_[i] = dqm_[0];
            continue;
        } else {
            q = base_q0;
        }
        QuantMatrix& m = dqm_[i];
        m.y1[0] = kDcTable[clip(q + dqy1_dc, 127)];
        m.y1[1] = kAcTable[clip(q, 127)];
        m.y2[0] = kDcTable[clip(q + dqy2_dc, 127)] * 2;
        m.y2[1] = std::max(8, (kAcTable[clip(q + dqy2_ac, 127)] * 101581) >> 16);  // x * 155 / 100
        m.uv[0] = kDcTable[clip(q + dquv_dc, 117)];
        m.uv[1] = kAcTable[clip(q + dquv_ac, 127)];
    }
}

void VP8Decoder::parse_proba() {
    for (int t = 0; t < 4; ++t)
        for (int b = 0; b < 8; ++b)
            for (int c = 0; c < 3; ++c)
                for (int p = 0; p < 11; ++p)
                    proba_[t][b][c][p] = br_.bit(kCoeffsUpdateProba[t][b][c][p])
                                             ? uint8_t(br_.literal(8))
                                             : kCoeffsProba0[t][b][c][p];
    use_skip_proba_ = br_.literal(1);
    if (use_skip_proba_) skip_p_ = int(br_.literal(8));
}

// The filter limits of each segment, for macroblocks without (0) and with
// (1) 4x4 prediction.
void VP8Decoder::precompute_filter_strengths() {
    for (int s = 0; s < 4; ++s) {
        int base_level = level_;
        if (use_segment_) base_level = seg_filter_[s] + (absolute_delta_ ? 0 : level_);
        for (int i4x4 = 0; i4x4 <= 1; ++i4x4) {
            FilterInfo& info = fstrengths_[s][i4x4];
            int level = base_level;
            if (use_lf_delta_) {
                level += ref_lf_delta_[0];  // intra frame
                if (i4x4) level += mode_lf_delta_[0];
            }
            level = level < 0 ? 0 : level > 63 ? 63 : level;
            if (level > 0) {
                int ilevel = level;
                if (sharpness_ > 0) {
                    ilevel >>= sharpness_ > 4 ? 2 : 1;
                    if (ilevel > 9 - sharpness_) ilevel = 9 - sharpness_;
                }
                if (ilevel < 1) ilevel = 1;
                info.ilevel = ilevel;
                info.limit = 2 * level + ilevel;
                info.hev_thresh = level >= 40 ? 2 : level >= 15 ? 1 : 0;
            } else {
                info.limit = 0;
            }
            info.inner = i4x4;
        }
    }
}

void VP8Decoder::parse_intra_modes(MacroBlock* block, int mb_x) {
    uint8_t* top = &intra_t_[4 * mb_x];
    uint8_t* left = intra_l_;
    block->segment = 0;
    if (update_map_)
        block->segment = !br_.bit(seg_proba_[0]) ? br_.bit(seg_proba_[1])
                                                 : br_.bit(seg_proba_[2]) + 2;
    block->skip = use_skip_proba_ ? br_.bit(skip_p_) : false;
    block->is_i4x4 = !br_.bit(145);
    if (!block->is_i4x4) {
        const int ymode = br_.bit(156) ? (br_.bit(128) ? B_TM_PRED : B_HE_PRED)
                                       : (br_.bit(163) ? B_VE_PRED : B_DC_PRED);
        block->imodes[0] = uint8_t(ymode);
        std::memset(top, ymode, 4);
        std::memset(left, ymode, 4);
    } else {
        uint8_t* modes = block->imodes;
        for (int y = 0; y < 4; ++y) {
            int ymode = left[y];
            for (int x = 0; x < 4; ++x) {
                const uint8_t* prob = kBModesProba[top[x]][ymode];
                ymode = !br_.bit(prob[0]) ? B_DC_PRED
                      : !br_.bit(prob[1]) ? B_TM_PRED
                      : !br_.bit(prob[2]) ? B_VE_PRED
                      : !br_.bit(prob[3])
                          ? (!br_.bit(prob[4]) ? B_HE_PRED
                                               : !br_.bit(prob[5]) ? B_RD_PRED : B_VR_PRED)
                          : (!br_.bit(prob[6]) ? B_LD_PRED
                             : !br_.bit(prob[7]) ? B_VL_PRED
                             : !br_.bit(prob[8]) ? B_HD_PRED : B_HU_PRED);
                top[x] = uint8_t(ymode);
            }
            std::memcpy(modes, top, 4);
            modes += 4;
            left[y] = uint8_t(ymode);
        }
    }
    block->uvmode = !br_.bit(142) ? B_DC_PRED
                  : !br_.bit(114) ? B_VE_PRED
                  : br_.bit(183) ? B_TM_PRED : B_HE_PRED;
}

// The tokens of one block from position n (section 13): returns the
// position after the last non-zero coefficient (16 if a run of zeros reaches
// the end), as libwebp's GetCoeffs does.
int VP8Decoder::get_coeffs(BoolReader* br, int type, int ctx, const int* dq, int n, int16_t* out) {
    const uint8_t* p = proba_[type][kBands[n]][ctx];
    for (; n < 16; ++n) {
        if (!br->bit(p[0])) return n;  // end of block
        while (!br->bit(p[1])) {       // a zero
            p = proba_[type][kBands[++n]][0];
            if (n == 16) return 16;
        }
        const uint8_t* next = proba_[type][kBands[n + 1]][0];
        int v;
        if (!br->bit(p[2])) {
            v = 1;
            p = next + 11;  // context 1
        } else {
            if (!br->bit(p[3])) {
                v = !br->bit(p[4]) ? 2 : 3 + br->bit(p[5]);
            } else if (!br->bit(p[6])) {
                v = !br->bit(p[7]) ? 5 + br->bit(159) : 7 + 2 * br->bit(165) + br->bit(145);
            } else {
                const int bit1 = br->bit(p[8]);
                const int bit0 = br->bit(p[9 + bit1]);
                const int cat = 2 * bit1 + bit0;
                v = 0;
                for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab) v += v + br->bit(*tab);
                v += 3 + (8 << cat);
            }
            p = next + 22;  // context 2
        }
        const int sign = br->bit(0x80);
        out[kZigzag[n]] = int16_t((sign ? -v : v) * dq[n > 0]);
    }
    return 16;
}

// The residuals of one macroblock; returns whether all are zero.
bool VP8Decoder::parse_residuals(MacroBlock* block, int mb_x, BoolReader* br) {
    NzContext& mb = nz_[1 + mb_x];
    NzContext& left = nz_[0];
    const QuantMatrix& q = dqm_[block->segment];
    int16_t* dst = block->coeffs;
    std::memset(dst, 0, sizeof(block->coeffs));
    int first, ac_type;
    uint32_t nz_y = 0, nz_uv = 0;
    if (!block->is_i4x4) {  // the Y2 block of the luma DCs
        int16_t dc[16] = {0};
        const int ctx = mb.nz_dc + left.nz_dc;
        const int nz = get_coeffs(br, 1, ctx, q.y2, 0, dc);
        mb.nz_dc = left.nz_dc = nz > 0;
        inverse_wht(dc, dst);
        first = 1;
        ac_type = 0;
    } else {
        first = 0;
        ac_type = 3;
    }
    uint32_t tnz = mb.nz & 0x0f, lnz = left.nz & 0x0f;
    for (int y = 0; y < 4; ++y) {
        int l = lnz & 1;
        for (int x = 0; x < 4; ++x, dst += 16) {
            const int ctx = l + (tnz & 1);
            const int nz = get_coeffs(br, ac_type, ctx, q.y1, first, dst);
            l = nz > first;
            tnz = (tnz >> 1) | (uint32_t(l) << 7);
            if (nz > 1 || dst[0] != 0) nz_y |= 1u << (4 * y + x);
        }
        tnz >>= 4;
        lnz = (lnz >> 1) | (uint32_t(l) << 7);
    }
    uint32_t out_t_nz = tnz, out_l_nz = lnz >> 4;
    for (int ch = 0; ch < 4; ch += 2) {
        tnz = mb.nz >> (4 + ch);
        lnz = left.nz >> (4 + ch);
        for (int y = 0; y < 2; ++y) {
            int l = lnz & 1;
            for (int x = 0; x < 2; ++x, dst += 16) {
                const int ctx = l + (tnz & 1);
                const int nz = get_coeffs(br, 2, ctx, q.uv, 0, dst);
                l = nz > 0;
                tnz = (tnz >> 1) | (uint32_t(l) << 3);
                if (nz > 1 || dst[0] != 0) nz_uv |= 1u << (2 * ch + 2 * y + x);
            }
            tnz >>= 2;
            lnz = (lnz >> 1) | (uint32_t(l) << 5);
        }
        out_t_nz |= (tnz << 4) << ch;
        out_l_nz |= (lnz & 0xf0) << ch;
    }
    mb.nz = uint8_t(out_t_nz);
    left.nz = uint8_t(out_l_nz);
    block->nz_y = nz_y;
    block->nz_uv = nz_uv;
    return !(nz_y | nz_uv);
}

// DC prediction without the edges that are missing (libwebp's CheckMode).
inline int check_mode(int mb_x, int mb_y, int mode) {
    if (mode != B_DC_PRED) return mode;
    if (mb_x == 0) return mb_y == 0 ? DC_PRED_NOTOPLEFT : DC_PRED_NOLEFT;
    return mb_y == 0 ? DC_PRED_NOTOP : B_DC_PRED;
}

// Predict and add the residuals of one row in yuv_b_, from the unfiltered
// samples above (top_) and to the left, and copy it into the planes. Above
// the frame is 127, left of it 129; the corner is 127 on the top row and 129
// below it.
void VP8Decoder::reconstruct_row(int mb_y) {
    uint8_t* const y_dst = yuv_b_ + Y_OFF;
    uint8_t* const u_dst = yuv_b_ + U_OFF;
    uint8_t* const v_dst = yuv_b_ + V_OFF;
    for (int j = 0; j < 16; ++j) y_dst[j * BPS - 1] = 129;
    for (int j = 0; j < 8; ++j) u_dst[j * BPS - 1] = v_dst[j * BPS - 1] = 129;
    if (mb_y > 0) {
        y_dst[-1 - BPS] = u_dst[-1 - BPS] = v_dst[-1 - BPS] = 129;
    } else {
        std::memset(y_dst - BPS - 1, 127, 16 + 4 + 1);
        std::memset(u_dst - BPS - 1, 127, 8 + 1);
        std::memset(v_dst - BPS - 1, 127, 8 + 1);
    }
    for (int mb_x = 0; mb_x < mb_w_; ++mb_x) {
        const MacroBlock& block = row_[mb_x];
        if (mb_x > 0) {  // the right columns of the previous block become the left ones
            for (int j = -1; j < 16; ++j) std::memcpy(y_dst + j * BPS - 4, y_dst + j * BPS + 12, 4);
            for (int j = -1; j < 8; ++j) {
                std::memcpy(u_dst + j * BPS - 4, u_dst + j * BPS + 4, 4);
                std::memcpy(v_dst + j * BPS - 4, v_dst + j * BPS + 4, 4);
            }
        }
        TopSamples* top = &top_[mb_x];
        if (mb_y > 0) {
            std::memcpy(y_dst - BPS, top->y, 16);
            std::memcpy(u_dst - BPS, top->u, 8);
            std::memcpy(v_dst - BPS, top->v, 8);
        }
        if (block.is_i4x4) {
            uint8_t* top_right = y_dst - BPS + 16;
            if (mb_y > 0) {
                if (mb_x >= mb_w_ - 1)  // the rightmost macroblock repeats its last top pixel
                    std::memset(top_right, top->y[15], 4);
                else
                    std::memcpy(top_right, top_[mb_x + 1].y, 4);
            }
            // the right column's subblocks take the same above-right pixels
            for (int k = 1; k < 4; ++k) std::memcpy(top_right + 4 * k * BPS, top_right, 4);
            for (int n = 0; n < 16; ++n) {
                uint8_t* dst = y_dst + (n & 3) * 4 + (n >> 2) * 4 * BPS;
                predict4(dst, block.imodes[n]);
                if (block.nz_y & (1u << n)) inverse_dct_add(block.coeffs + 16 * n, dst);
            }
        } else {
            predict_block(y_dst, check_mode(mb_x, mb_y, block.imodes[0]), 16, 5);
            for (int n = 0; n < 16; ++n)
                if (block.nz_y & (1u << n))
                    inverse_dct_add(block.coeffs + 16 * n, y_dst + (n & 3) * 4 + (n >> 2) * 4 * BPS);
        }
        const int uvmode = check_mode(mb_x, mb_y, block.uvmode);
        predict_block(u_dst, uvmode, 8, 4);
        predict_block(v_dst, uvmode, 8, 4);
        for (int n = 0; n < 4; ++n) {
            const int off = (n & 1) * 4 + (n >> 1) * 4 * BPS;
            if (block.nz_uv & (1u << n)) inverse_dct_add(block.coeffs + 256 + 16 * n, u_dst + off);
            if (block.nz_uv & (1u << (4 + n))) inverse_dct_add(block.coeffs + 320 + 16 * n, v_dst + off);
        }
        if (mb_y < mb_h_ - 1) {
            std::memcpy(top->y, y_dst + 15 * BPS, 16);
            std::memcpy(top->u, u_dst + 7 * BPS, 8);
            std::memcpy(top->v, v_dst + 7 * BPS, 8);
        }
        uint8_t* y_out = y_.data() + size_t(mb_y) * 16 * y_stride_ + mb_x * 16;
        uint8_t* u_out = u_.data() + size_t(mb_y) * 8 * uv_stride_ + mb_x * 8;
        uint8_t* v_out = v_.data() + size_t(mb_y) * 8 * uv_stride_ + mb_x * 8;
        for (int j = 0; j < 16; ++j) std::memcpy(y_out + j * y_stride_, y_dst + j * BPS, 16);
        for (int j = 0; j < 8; ++j) {
            std::memcpy(u_out + j * uv_stride_, u_dst + j * BPS, 8);
            std::memcpy(v_out + j * uv_stride_, v_dst + j * BPS, 8);
        }
    }
}

// The loop filter of one row, macroblock by macroblock: the left edge, the
// inner vertical edges, the top edge, the inner horizontal edges.
void VP8Decoder::filter_row(int mb_y) {
    for (int mb_x = 0; mb_x < mb_w_; ++mb_x) {
        const FilterInfo& f = finfo_[mb_x];
        const int limit = f.limit;
        if (limit == 0) continue;
        uint8_t* y = y_.data() + size_t(mb_y) * 16 * y_stride_ + mb_x * 16;
        const int ys = y_stride_;
        if (filter_type_ == 1) {
            if (mb_x > 0) simple_edge(y, 1, ys, limit + 4);
            if (f.inner)
                for (int k = 4; k < 16; k += 4) simple_edge(y + k, 1, ys, limit);
            if (mb_y > 0) simple_edge(y, ys, 1, limit + 4);
            if (f.inner)
                for (int k = 4; k < 16; k += 4) simple_edge(y + k * ys, ys, 1, limit);
            continue;
        }
        const int cs = uv_stride_;
        uint8_t* u = u_.data() + size_t(mb_y) * 8 * cs + mb_x * 8;
        uint8_t* v = v_.data() + size_t(mb_y) * 8 * cs + mb_x * 8;
        const int il = f.ilevel, hev = f.hev_thresh;
        if (mb_x > 0) {
            normal_edge(y, 1, ys, 16, limit + 4, il, hev, true);
            normal_edge(u, 1, cs, 8, limit + 4, il, hev, true);
            normal_edge(v, 1, cs, 8, limit + 4, il, hev, true);
        }
        if (f.inner) {
            for (int k = 4; k < 16; k += 4) normal_edge(y + k, 1, ys, 16, limit, il, hev, false);
            normal_edge(u + 4, 1, cs, 8, limit, il, hev, false);
            normal_edge(v + 4, 1, cs, 8, limit, il, hev, false);
        }
        if (mb_y > 0) {
            normal_edge(y, ys, 1, 16, limit + 4, il, hev, true);
            normal_edge(u, cs, 1, 8, limit + 4, il, hev, true);
            normal_edge(v, cs, 1, 8, limit + 4, il, hev, true);
        }
        if (f.inner) {
            for (int k = 4; k < 16; k += 4) normal_edge(y + k * ys, ys, 1, 16, limit, il, hev, false);
            normal_edge(u + 4 * cs, cs, 1, 8, limit, il, hev, false);
            normal_edge(v + 4 * cs, cs, 1, 8, limit, il, hev, false);
        }
    }
}

void VP8Decoder::decode() {
    y_stride_ = mb_w_ * 16;
    uv_stride_ = mb_w_ * 8;
    y_.assign(size_t(y_stride_) * mb_h_ * 16, 0);
    u_.assign(size_t(uv_stride_) * mb_h_ * 8, 0);
    v_.assign(size_t(uv_stride_) * mb_h_ * 8, 0);
    intra_t_.assign(4 * size_t(mb_w_), B_DC_PRED);
    nz_.assign(size_t(mb_w_) + 1, NzContext());
    top_.assign(size_t(mb_w_), TopSamples());
    row_.assign(size_t(mb_w_), MacroBlock());
    finfo_.assign(size_t(mb_w_), FilterInfo());
    std::memset(yuv_b_, 0, sizeof(yuv_b_));
    if (filter_type_ > 0) precompute_filter_strengths();
    for (int mb_y = 0; mb_y < mb_h_; ++mb_y) {
        std::memset(intra_l_, B_DC_PRED, 4);
        nz_[0] = NzContext();
        for (int mb_x = 0; mb_x < mb_w_; ++mb_x) parse_intra_modes(&row_[mb_x], mb_x);
        if (br_.eof())
            malformed("the 'VP8 ' first partition ends in macroblock row " + std::to_string(mb_y));
        BoolReader* tokens = &parts_[mb_y & (num_parts_ - 1)];
        for (int mb_x = 0; mb_x < mb_w_; ++mb_x) {
            MacroBlock& block = row_[mb_x];
            bool skip = block.skip;
            if (!skip) {
                skip = parse_residuals(&block, mb_x, tokens);
            } else {
                nz_[0].nz = nz_[1 + mb_x].nz = 0;
                if (!block.is_i4x4) nz_[0].nz_dc = nz_[1 + mb_x].nz_dc = 0;
                block.nz_y = block.nz_uv = 0;
            }
            if (filter_type_ > 0) {
                finfo_[mb_x] = fstrengths_[block.segment][block.is_i4x4];
                finfo_[mb_x].inner = finfo_[mb_x].inner || !skip;
            }
            if (tokens->eof())
                malformed("a 'VP8 ' token partition ends in macroblock row " + std::to_string(mb_y));
        }
        reconstruct_row(mb_y);
        if (filter_type_ > 0) filter_row(mb_y);
    }
}

void VP8Decoder::copy_planes(uint8_t* y, uint8_t* u, uint8_t* v) const {
    const int uw = (width + 1) / 2, uh = (height + 1) / 2;
    for (int j = 0; j < height; ++j) std::memcpy(y + size_t(j) * width, &y_[size_t(j) * y_stride_], width);
    for (int j = 0; j < uh; ++j) {
        std::memcpy(u + size_t(j) * uw, &u_[size_t(j) * uv_stride_], uw);
        std::memcpy(v + size_t(j) * uw, &v_[size_t(j) * uv_stride_], uw);
    }
}

// libwebp's YUV -> RGB (yuv.h): 14-bit fixed point, clipped.
inline int mult_hi(int v, int coeff) { return (v * coeff) >> 8; }
inline uint8_t yuv_clip8(int v) { return uint8_t((v & ~16383) == 0 ? v >> 6 : v < 0 ? 0 : 255); }

inline void yuv_to_rgb(int y, int u, int v, uint8_t* rgb) {
    const int yy = mult_hi(y, 19077);
    rgb[0] = yuv_clip8(yy + mult_hi(v, 26149) - 14234);
    rgb[1] = yuv_clip8(yy - mult_hi(u, 6419) - mult_hi(v, 13320) + 8708);
    rgb[2] = yuv_clip8(yy + mult_hi(u, 33050) - 17685);
}

// libwebp's "fancy" upsampler (upsampling.c) for one pair of output rows:
// the top row leans 3:1 towards the chroma row above, the bottom row towards
// the current one; `bottom_y` null emits the top row only.
void upsample_pair(const uint8_t* top_y, const uint8_t* bottom_y, const uint8_t* top_u,
                   const uint8_t* top_v, const uint8_t* cur_u, const uint8_t* cur_v,
                   uint8_t* top_dst, uint8_t* bottom_dst, int len) {
    const int last_pair = (len - 1) >> 1;
    int tl_u = top_u[0], tl_v = top_v[0], l_u = cur_u[0], l_v = cur_v[0];
    yuv_to_rgb(top_y[0], (3 * tl_u + l_u + 2) >> 2, (3 * tl_v + l_v + 2) >> 2, top_dst);
    if (bottom_y)
        yuv_to_rgb(bottom_y[0], (3 * l_u + tl_u + 2) >> 2, (3 * l_v + tl_v + 2) >> 2, bottom_dst);
    for (int x = 1; x <= last_pair; ++x) {
        const int t_u = top_u[x], t_v = top_v[x], u = cur_u[x], v = cur_v[x];
        const int avg_u = tl_u + t_u + l_u + u + 8, avg_v = tl_v + t_v + l_v + v + 8;
        const int d12_u = (avg_u + 2 * (t_u + l_u)) >> 3, d12_v = (avg_v + 2 * (t_v + l_v)) >> 3;
        const int d03_u = (avg_u + 2 * (tl_u + u)) >> 3, d03_v = (avg_v + 2 * (tl_v + v)) >> 3;
        yuv_to_rgb(top_y[2 * x - 1], (d12_u + tl_u) >> 1, (d12_v + tl_v) >> 1, top_dst + 3 * (2 * x - 1));
        yuv_to_rgb(top_y[2 * x], (d03_u + t_u) >> 1, (d03_v + t_v) >> 1, top_dst + 3 * (2 * x));
        if (bottom_y) {
            yuv_to_rgb(bottom_y[2 * x - 1], (d03_u + l_u) >> 1, (d03_v + l_v) >> 1,
                       bottom_dst + 3 * (2 * x - 1));
            yuv_to_rgb(bottom_y[2 * x], (d12_u + u) >> 1, (d12_v + v) >> 1, bottom_dst + 3 * (2 * x));
        }
        tl_u = t_u;
        tl_v = t_v;
        l_u = u;
        l_v = v;
    }
    if (!(len & 1)) {
        yuv_to_rgb(top_y[len - 1], (3 * tl_u + l_u + 2) >> 2, (3 * tl_v + l_v + 2) >> 2,
                   top_dst + 3 * (len - 1));
        if (bottom_y)
            yuv_to_rgb(bottom_y[len - 1], (3 * l_u + tl_u + 2) >> 2, (3 * l_v + tl_v + 2) >> 2,
                       bottom_dst + 3 * (len - 1));
    }
}

// Row 0 pairs chroma row 0 with itself; rows 2k-1 and 2k pair chroma rows
// k-1 and k; an even height's last row pairs its chroma row with itself.
void VP8Decoder::to_rgb(uint8_t* out, size_t stride) const {
    const uint8_t* y = y_.data();
    const uint8_t* u = u_.data();
    const uint8_t* v = v_.data();
    upsample_pair(y, nullptr, u, v, u, v, out, nullptr, width);
    int row = 1;
    for (; row + 1 < height; row += 2) {
        const int k = (row + 1) / 2;
        upsample_pair(y + size_t(row) * y_stride_, y + size_t(row + 1) * y_stride_,
                      u + size_t(k - 1) * uv_stride_, v + size_t(k - 1) * uv_stride_,
                      u + size_t(k) * uv_stride_, v + size_t(k) * uv_stride_,
                      out + row * stride, out + (row + 1) * stride, width);
    }
    if (row < height) {  // the last row of an even height
        const int k = row / 2;
        const uint8_t* cu = u + size_t(k) * uv_stride_;
        const uint8_t* cv = v + size_t(k) * uv_stride_;
        upsample_pair(y + size_t(row) * y_stride_, nullptr, cu, cv, cu, cv, out + row * stride,
                      nullptr, width);
    }
}

// ---------------------------------------------------------------------------
// VP8L (RFC 9649 section 3): bits are read least significant first.

class LBitReader {
public:
    LBitReader(const uint8_t* p, size_t n) : buf_(p), len_(n) {}

    // The next 57 or more bits; zeros past the end.
    uint64_t peek() const {
        const size_t byte = pos_ >> 3;
        uint64_t v = 0;
        for (size_t i = 0; i < 8 && byte + i < len_; ++i) v |= uint64_t(buf_[byte + i]) << (8 * i);
        return v >> (pos_ & 7);
    }

    uint32_t read(int n) {
        if (n == 0) return 0;
        const uint32_t v = uint32_t(peek() & ((uint64_t(1) << n) - 1));
        pos_ += size_t(n);
        return v;
    }

    void skip(int n) { pos_ += size_t(n); }

    bool eos() const { return pos_ > 8 * len_; }

private:
    const uint8_t* buf_;
    size_t len_;
    size_t pos_ = 0;
};

constexpr int kCodeLengthCodes = 19;
const uint8_t kCodeLengthCodeOrder[kCodeLengthCodes] = {17, 18, 0, 1, 2, 3, 4, 5, 16, 6,
                                                        7,  8,  9, 10, 11, 12, 13, 14, 15};

// RFC 9649's distance map (section 3, LZ77 backward references): for each
// of the 120 short codes, (yoffset << 4) | (8 - xoffset) of the neighbour
// it names.
const uint8_t kCodeToPlane[120] = {
    0x18, 0x07, 0x17, 0x19, 0x28, 0x06, 0x27, 0x29, 0x16, 0x1a, 0x26, 0x2a,
    0x38, 0x05, 0x37, 0x39, 0x15, 0x1b, 0x36, 0x3a, 0x25, 0x2b, 0x48, 0x04,
    0x47, 0x49, 0x14, 0x1c, 0x35, 0x3b, 0x46, 0x4a, 0x24, 0x2c, 0x58, 0x45,
    0x4b, 0x34, 0x3c, 0x03, 0x57, 0x59, 0x13, 0x1d, 0x56, 0x5a, 0x23, 0x2d,
    0x44, 0x4c, 0x55, 0x5b, 0x33, 0x3d, 0x68, 0x02, 0x67, 0x69, 0x12, 0x1e,
    0x66, 0x6a, 0x22, 0x2e, 0x54, 0x5c, 0x43, 0x4d, 0x65, 0x6b, 0x32, 0x3e,
    0x78, 0x01, 0x77, 0x79, 0x53, 0x5d, 0x11, 0x1f, 0x64, 0x6c, 0x42, 0x4e,
    0x76, 0x7a, 0x21, 0x2f, 0x75, 0x7b, 0x31, 0x3f, 0x63, 0x6d, 0x52, 0x5e,
    0x00, 0x74, 0x7c, 0x41, 0x4f, 0x10, 0x20, 0x62, 0x6e, 0x30, 0x73, 0x7d,
    0x51, 0x5f, 0x40, 0x72, 0x7e, 0x61, 0x6f, 0x50, 0x71, 0x7f, 0x60, 0x70,
};

constexpr int kRootBits = 8;

// A canonical prefix code: shorter codes first, then lower symbols.
class PrefixCode {
public:
    // Build from code lengths (0 = unused): a single used symbol is read
    // with no bit; otherwise the code must be complete.
    void build(const std::vector<int>& lengths, const char* what) {
        int count[16] = {0};
        int used = 0, last = 0;
        for (size_t s = 0; s < lengths.size(); ++s) {
            if (lengths[s] == 0) continue;
            ++count[lengths[s]];
            ++used;
            last = int(s);
        }
        if (used == 0) malformed(std::string("a lossless prefix code for ") + what + " has no symbol");
        single_ = used == 1 ? last : -1;
        if (used == 1) return;
        int left = 1;
        for (int len = 1; len <= 15; ++len) {
            left = 2 * left - count[len];
            if (left < 0) malformed(std::string("a lossless prefix code for ") + what + " is over-subscribed");
        }
        if (left != 0) malformed(std::string("a lossless prefix code for ") + what + " is incomplete");
        int offset[17] = {0};
        for (int len = 1; len <= 15; ++len) {
            count_[len] = uint16_t(count[len]);
            offset[len + 1] = offset[len] + count[len];
        }
        sorted_.assign(size_t(used), 0);
        for (size_t s = 0; s < lengths.size(); ++s)
            if (lengths[s]) sorted_[offset[lengths[s]]++] = uint16_t(s);
        // the root table: the next kRootBits stream bits -> (length << 16) | symbol
        std::fill(std::begin(root_), std::end(root_), 0u);
        int code = 0, index = 0;
        for (int len = 1; len <= kRootBits; ++len) {
            for (int i = 0; i < count[len]; ++i, ++code, ++index) {
                int rev = 0;
                for (int b = 0; b < len; ++b) rev |= ((code >> (len - 1 - b)) & 1) << b;
                for (int k = rev; k < (1 << kRootBits); k += 1 << len)
                    root_[k] = (uint32_t(len) << 16) | sorted_[index];
            }
            code <<= 1;
        }
    }

    int read(LBitReader& br) const {
        if (single_ >= 0) return single_;
        const uint64_t bits = br.peek();
        const uint32_t e = root_[bits & ((1u << kRootBits) - 1)];
        if (e) {
            br.skip(int(e >> 16));
            return int(e & 0xffff);
        }
        int code = 0, first = 0, index = 0;  // a longer code, bit by bit
        for (int len = 1; len <= 15; ++len) {
            code |= int((bits >> (len - 1)) & 1);
            const int count = count_[len];
            if (code - first < count) {
                br.skip(len);
                return sorted_[index + code - first];
            }
            index += count;
            first = (first + count) << 1;
            code <<= 1;
        }
        malformed("a lossless prefix code ran past 15 bits");
    }

private:
    int single_ = -1;
    uint16_t count_[16] = {0};
    std::vector<uint16_t> sorted_;
    uint32_t root_[1 << kRootBits];
};

constexpr int kNumLiteralCodes = 256;
constexpr int kNumLengthCodes = 24;
constexpr int kNumDistanceCodes = 40;
const char* const kCodeNames[5] = {"green", "red", "blue", "alpha", "distance"};

struct CodeGroup {
    PrefixCode codes[5];  // green (with lengths and cache indices), red, blue, alpha, distance
};

// The prefix codes, entropy image and colour cache of one image stream.
struct EntropyCoding {
    int cache_bits = 0;
    int tile_bits = 0;  // 0: one group for the whole image
    int tiles_x = 0;
    std::vector<uint32_t> tile_group;
    std::vector<CodeGroup> groups;
};

inline int subsample(int size, int bits) { return (size + (1 << bits) - 1) >> bits; }

inline uint32_t add_pixels(uint32_t a, uint32_t b) {
    const uint32_t ag = (a & 0xff00ff00u) + (b & 0xff00ff00u);
    const uint32_t rb = (a & 0x00ff00ffu) + (b & 0x00ff00ffu);
    return (ag & 0xff00ff00u) | (rb & 0x00ff00ffu);
}

inline uint32_t average2(uint32_t a, uint32_t b) { return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b); }

inline uint32_t clip255(uint32_t a) { return a < 256 ? a : ~a >> 24; }

inline uint32_t clamped_add_subtract_full(uint32_t c0, uint32_t c1, uint32_t c2) {
    uint32_t out = 0;
    for (int s = 0; s < 32; s += 8) {
        const int a = int((c0 >> s) & 0xff), b = int((c1 >> s) & 0xff), c = int((c2 >> s) & 0xff);
        out |= clip255(uint32_t(a + b - c)) << s;
    }
    return out;
}

inline uint32_t clamped_add_subtract_half(uint32_t c0, uint32_t c1, uint32_t c2) {
    const uint32_t ave = average2(c0, c1);
    uint32_t out = 0;
    for (int s = 0; s < 32; s += 8) {
        const int a = int((ave >> s) & 0xff), b = int((c2 >> s) & 0xff);
        out |= clip255(uint32_t(a + (a - b) / 2)) << s;
    }
    return out;
}

// The predictor that is closer, by Manhattan distance, to left + top - top-left.
inline uint32_t select(uint32_t top, uint32_t left, uint32_t top_left) {
    int pa_minus_pb = 0;
    for (int s = 0; s < 32; s += 8) {
        const int a = int((top >> s) & 0xff), b = int((left >> s) & 0xff), c = int((top_left >> s) & 0xff);
        pa_minus_pb += std::abs(b - c) - std::abs(a - c);
    }
    return pa_minus_pb <= 0 ? top : left;
}

// The 14 predictors; 14 and 15 predict black, as libwebp does.
inline uint32_t predict(int mode, uint32_t left, const uint32_t* top) {
    switch (mode) {
        case 1: return left;
        case 2: return top[0];
        case 3: return top[1];
        case 4: return top[-1];
        case 5: return average2(average2(left, top[1]), top[0]);
        case 6: return average2(left, top[-1]);
        case 7: return average2(left, top[0]);
        case 8: return average2(top[-1], top[0]);
        case 9: return average2(top[0], top[1]);
        case 10: return average2(average2(left, top[-1]), average2(top[0], top[1]));
        case 11: return select(top[0], left, top[-1]);
        case 12: return clamped_add_subtract_full(left, top[0], top[-1]);
        case 13: return clamped_add_subtract_half(left, top[0], top[-1]);
        default: return 0xff000000u;
    }
}

struct Transform {
    int type = 0;
    int xsize = 0;  // the width of the image it applies to
    int bits = 0;
    std::vector<uint32_t> data;
};

enum { PREDICTOR = 0, CROSS_COLOR = 1, SUBTRACT_GREEN = 2, COLOR_INDEXING = 3 };

class VP8LDecoder {
public:
    VP8LDecoder(const uint8_t* data, size_t size) : br_(data, size) {}

    // Decode into `out` (rows of `stride` bytes, RGB).
    void decode(uint8_t* out, size_t stride);

private:
    std::vector<uint32_t> decode_stream(int xsize, int ysize, bool level0);
    void read_transform(int* xsize);
    void read_coding(EntropyCoding* ec, int xsize, int ysize, bool level0);
    void read_code(int alphabet_size, PrefixCode* code, const char* what);
    void read_code_lengths(const PrefixCode& lengths_code, int num_symbols, std::vector<int>* lengths);
    std::vector<uint32_t> decode_pixels(const EntropyCoding& ec, int xsize, int ysize);
    int copy_value(int symbol) {
        if (symbol < 4) return symbol + 1;
        const int extra = (symbol - 2) >> 1;
        const int offset = (2 + (symbol & 1)) << extra;
        return offset + int(br_.read(extra)) + 1;
    }
    void check_eos(const char* what) const {
        if (br_.eos()) malformed(std::string("the 'VP8L' chunk is truncated in ") + what);
    }

    LBitReader br_;
    int width_ = 0, height_ = 0;
    std::vector<Transform> transforms_;
    unsigned transforms_seen_ = 0;
};

void VP8LDecoder::read_code_lengths(const PrefixCode& lengths_code, int num_symbols,
                                    std::vector<int>* lengths) {
    int max_symbol = num_symbols;
    if (br_.read(1)) {
        const int nbits = 2 + 2 * int(br_.read(3));
        max_symbol = 2 + int(br_.read(nbits));
        if (max_symbol > num_symbols) malformed("a lossless code length count exceeds its alphabet");
    }
    int symbol = 0, prev = 8;
    while (symbol < num_symbols) {
        if (max_symbol-- == 0) break;
        const int len = lengths_code.read(br_);
        if (len < 16) {
            (*lengths)[size_t(symbol++)] = len;
            if (len != 0) prev = len;
        } else {
            static const int kExtra[3] = {2, 3, 7}, kOffset[3] = {3, 3, 11};
            const int slot = len - 16;
            const int repeat = int(br_.read(kExtra[slot])) + kOffset[slot];
            if (symbol + repeat > num_symbols) malformed("a lossless code length repeat runs past its alphabet");
            const int v = len == 16 ? prev : 0;
            for (int i = 0; i < repeat; ++i) (*lengths)[size_t(symbol++)] = v;
        }
    }
}

void VP8LDecoder::read_code(int alphabet_size, PrefixCode* code, const char* what) {
    std::vector<int> lengths(size_t(alphabet_size), 0);
    if (br_.read(1)) {  // a simple code of one or two symbols
        const int num_symbols = int(br_.read(1)) + 1;
        const int first_bits = br_.read(1) ? 8 : 1;
        int symbol = int(br_.read(first_bits));
        if (symbol < alphabet_size) lengths[size_t(symbol)] = 1;
        if (num_symbols == 2) {
            symbol = int(br_.read(8));
            if (symbol < alphabet_size) lengths[size_t(symbol)] = 1;
        }
    } else {
        std::vector<int> cl_lengths(kCodeLengthCodes, 0);
        const int num_codes = int(br_.read(4)) + 4;
        for (int i = 0; i < num_codes; ++i) cl_lengths[kCodeLengthCodeOrder[i]] = int(br_.read(3));
        PrefixCode lengths_code;
        lengths_code.build(cl_lengths, "code lengths");
        read_code_lengths(lengths_code, alphabet_size, &lengths);
    }
    check_eos("a prefix code");
    code->build(lengths, what);
}

void VP8LDecoder::read_coding(EntropyCoding* ec, int xsize, int ysize, bool level0) {
    if (br_.read(1)) {
        ec->cache_bits = int(br_.read(4));
        if (ec->cache_bits < 1 || ec->cache_bits > 11)
            malformed("a lossless colour cache of " + std::to_string(ec->cache_bits) + " bits");
    }
    int num_groups = 1;
    std::vector<int> mapping;  // group index in the stream -> kept group, -1 unused
    if (level0 && br_.read(1)) {  // an entropy image
        ec->tile_bits = int(br_.read(3)) + 2;
        ec->tiles_x = subsample(xsize, ec->tile_bits);
        ec->tile_group = decode_stream(ec->tiles_x, subsample(ysize, ec->tile_bits), false);
        int max_group = 0;
        for (uint32_t& g : ec->tile_group) {
            g = (g >> 8) & 0xffff;
            max_group = std::max(max_group, int(g));
        }
        num_groups = max_group + 1;
        mapping.assign(size_t(num_groups), -1);
        int kept = 0;
        for (uint32_t& g : ec->tile_group) {
            if (mapping[g] < 0) mapping[g] = kept++;
            g = uint32_t(mapping[g]);
        }
        ec->groups.resize(size_t(kept));
    } else {
        ec->groups.resize(1);
    }
    const int alphabet[5] = {kNumLiteralCodes + kNumLengthCodes + (ec->cache_bits ? 1 << ec->cache_bits : 0),
                             kNumLiteralCodes, kNumLiteralCodes, kNumLiteralCodes, kNumDistanceCodes};
    PrefixCode unused;
    for (int g = 0; g < num_groups; ++g) {
        const int slot = mapping.empty() ? g : mapping[size_t(g)];
        for (int j = 0; j < 5; ++j)
            read_code(alphabet[j], slot < 0 ? &unused : &ec->groups[size_t(slot)].codes[j], kCodeNames[j]);
    }
}

std::vector<uint32_t> VP8LDecoder::decode_pixels(const EntropyCoding& ec, int xsize, int ysize) {
    const size_t total = size_t(xsize) * size_t(ysize);
    std::vector<uint32_t> px(total);
    std::vector<uint32_t> cache(ec.cache_bits ? size_t(1) << ec.cache_bits : 0);
    const int cache_shift = 32 - ec.cache_bits;
    auto insert = [&](uint32_t argb) {
        if (!cache.empty()) cache[(argb * 0x1e35a7bdu) >> cache_shift] = argb;
    };
    size_t pos = 0;
    int x = 0, y = 0;
    while (pos < total) {
        const CodeGroup& g = ec.tile_bits == 0
            ? ec.groups[0]
            : ec.groups[ec.tile_group[size_t(y >> ec.tile_bits) * ec.tiles_x + (x >> ec.tile_bits)]];
        const int code = g.codes[0].read(br_);
        if (code < kNumLiteralCodes) {
            const uint32_t red = uint32_t(g.codes[1].read(br_));
            const uint32_t blue = uint32_t(g.codes[2].read(br_));
            const uint32_t alpha = uint32_t(g.codes[3].read(br_));
            px[pos] = (alpha << 24) | (red << 16) | (uint32_t(code) << 8) | blue;
            insert(px[pos]);
            ++pos;
            if (++x == xsize) x = 0, ++y;
        } else if (code < kNumLiteralCodes + kNumLengthCodes) {  // a backward reference
            const size_t length = size_t(copy_value(code - kNumLiteralCodes));
            const int dist_code = copy_value(g.codes[4].read(br_));
            size_t dist;
            if (dist_code > 120) {
                dist = size_t(dist_code - 120);
            } else {  // a neighbour in the 2D map
                const int plane = kCodeToPlane[dist_code - 1];
                const int d = (plane >> 4) * xsize + 8 - (plane & 0xf);
                dist = size_t(d >= 1 ? d : 1);
            }
            check_eos("the pixels");
            if (dist > pos || total - pos < length)
                malformed("a lossless backward reference lies outside the image");
            for (size_t i = 0; i < length; ++i, ++pos) {
                px[pos] = px[pos - dist];
                insert(px[pos]);
            }
            x += int(length % size_t(xsize));
            y += int(length / size_t(xsize));
            if (x >= xsize) x -= xsize, ++y;
        } else {  // a colour cache index
            const size_t key = size_t(code - kNumLiteralCodes - kNumLengthCodes);
            px[pos] = cache[key];
            insert(px[pos]);
            ++pos;
            if (++x == xsize) x = 0, ++y;
        }
    }
    check_eos("the pixels");
    return px;
}

std::vector<uint32_t> VP8LDecoder::decode_stream(int xsize, int ysize, bool level0) {
    if (level0)
        while (br_.read(1)) read_transform(&xsize);
    EntropyCoding ec;
    read_coding(&ec, xsize, ysize, level0);
    check_eos("the prefix codes");
    return decode_pixels(ec, xsize, ysize);
}

void VP8LDecoder::read_transform(int* xsize) {
    const int type = int(br_.read(2));
    if (transforms_seen_ & (1u << type)) malformed("a lossless transform appears twice");
    transforms_seen_ |= 1u << type;
    Transform t;
    t.type = type;
    t.xsize = *xsize;
    if (type == PREDICTOR || type == CROSS_COLOR) {
        t.bits = int(br_.read(3)) + 2;
        t.data = decode_stream(subsample(t.xsize, t.bits), subsample(height_, t.bits), false);
    } else if (type == COLOR_INDEXING) {
        const int num_colors = int(br_.read(8)) + 1;
        t.bits = num_colors > 16 ? 0 : num_colors > 4 ? 1 : num_colors > 2 ? 2 : 3;
        *xsize = subsample(t.xsize, t.bits);
        std::vector<uint32_t> palette = decode_stream(num_colors, 1, false);
        t.data.assign(size_t(1) << (8 >> t.bits), 0u);  // indices past the palette: transparent black
        t.data[0] = palette[0];
        for (int i = 1; i < num_colors; ++i) t.data[size_t(i)] = add_pixels(palette[size_t(i)], t.data[size_t(i - 1)]);
    }
    transforms_.push_back(std::move(t));
}

void VP8LDecoder::decode(uint8_t* out, size_t stride) {
    if (br_.read(8) != 0x2f) malformed("the 'VP8L' chunk does not start with the signature 0x2f");
    width_ = int(br_.read(14)) + 1;
    height_ = int(br_.read(14)) + 1;
    br_.read(1);  // alpha hint
    if (br_.read(3) != 0) malformed("the 'VP8L' chunk has a version other than 0");
    std::vector<uint32_t> px = decode_stream(width_, height_, true);
    for (auto t = transforms_.rbegin(); t != transforms_.rend(); ++t) {  // last read, first undone
        const int w = t->xsize;
        if (t->type == PREDICTOR) {
            const int tiles_x = subsample(w, t->bits);
            px[0] = add_pixels(px[0], 0xff000000u);
            for (int x = 1; x < w; ++x) px[size_t(x)] = add_pixels(px[size_t(x)], px[size_t(x - 1)]);
            for (int y = 1; y < height_; ++y) {
                uint32_t* row = px.data() + size_t(y) * w;
                const uint32_t* modes = t->data.data() + size_t(y >> t->bits) * tiles_x;
                row[0] = add_pixels(row[0], row[-w]);
                for (int x = 1; x < w; ++x) {
                    const int mode = int((modes[x >> t->bits] >> 8) & 0xf);
                    row[x] = add_pixels(row[x], predict(mode, row[x - 1], row + x - w));
                }
            }
        } else if (t->type == CROSS_COLOR) {
            const int tiles_x = subsample(w, t->bits);
            for (int y = 0; y < height_; ++y) {
                uint32_t* row = px.data() + size_t(y) * w;
                const uint32_t* codes = t->data.data() + size_t(y >> t->bits) * tiles_x;
                for (int x = 0; x < w; ++x) {
                    const uint32_t c = codes[x >> t->bits];
                    const int g2r = int(int8_t(c & 0xff)), g2b = int(int8_t((c >> 8) & 0xff));
                    const int r2b = int(int8_t((c >> 16) & 0xff));
                    const uint32_t argb = row[x];
                    const int green = int(int8_t((argb >> 8) & 0xff));
                    int red = int((argb >> 16) & 0xff), blue = int(argb & 0xff);
                    red = (red + ((g2r * green) >> 5)) & 0xff;
                    blue = (blue + ((g2b * green) >> 5) + ((r2b * int(int8_t(red))) >> 5)) & 0xff;
                    row[x] = (argb & 0xff00ff00u) | (uint32_t(red) << 16) | uint32_t(blue);
                }
            }
        } else if (t->type == SUBTRACT_GREEN) {
            for (uint32_t& p : px) {
                const uint32_t g = (p >> 8) & 0xff;
                p = (p & 0xff00ff00u) | ((((p >> 16) + g) & 0xff) << 16) | (((p & 0xff) + g) & 0xff);
            }
        } else {  // colour indexing, unbundling 2, 4 or 8 indices a byte
            const int packed_w = subsample(w, t->bits);
            const int bits_per_pixel = 8 >> t->bits;
            const uint32_t mask = (1u << bits_per_pixel) - 1;
            std::vector<uint32_t> full(size_t(w) * height_);
            for (int y = 0; y < height_; ++y) {
                const uint32_t* src = px.data() + size_t(y) * packed_w;
                uint32_t* dst = full.data() + size_t(y) * w;
                uint32_t packed = 0;
                for (int x = 0; x < w; ++x) {
                    if ((x & ((1 << t->bits) - 1)) == 0) packed = (*src++ >> 8) & 0xff;
                    dst[x] = t->data[packed & mask];
                    packed >>= bits_per_pixel;
                }
            }
            px.swap(full);
        }
    }
    for (int y = 0; y < height_; ++y) {
        uint8_t* dst = out + size_t(y) * stride;
        const uint32_t* src = px.data() + size_t(y) * width_;
        for (int x = 0; x < width_; ++x) {
            dst[3 * x] = uint8_t(src[x] >> 16);
            dst[3 * x + 1] = uint8_t(src[x] >> 8);
            dst[3 * x + 2] = uint8_t(src[x]);
        }
    }
}

const struct {
    const char* name;
    const void* data;
    size_t size;
} kTables[] = {
    {"coeffs_proba0", kCoeffsProba0, sizeof(kCoeffsProba0)},
    {"coeffs_update_proba", kCoeffsUpdateProba, sizeof(kCoeffsUpdateProba)},
    {"bmodes_proba", kBModesProba, sizeof(kBModesProba)},
    {"dc_table", kDcTable, sizeof(kDcTable)},
    {"ac_table", kAcTable, sizeof(kAcTable)},
    {"zigzag", kZigzag, sizeof(kZigzag)},
    {"bands", kBands, sizeof(kBands)},
    {"cat3", kCat3, sizeof(kCat3)},
    {"cat4", kCat4, sizeof(kCat4)},
    {"cat5", kCat5, sizeof(kCat5)},
    {"cat6", kCat6, sizeof(kCat6)},
    {"code_to_plane", kCodeToPlane, sizeof(kCodeToPlane)},
    {"code_length_order", kCodeLengthCodeOrder, sizeof(kCodeLengthCodeOrder)},
};

}  // namespace

extern "C" {

// Decode the WebP file in data[0:size]. dims[0..1] receive the height and
// width of its canvas. With out == NULL only the container and the image
// header are read and the call returns 3; otherwise out must hold
// height*width*3 bytes and the call returns 0 when the RGB pixels are
// written (row-major, channels last). A malformed file returns 2 (as does
// an out_cap too small); err receives a message.
int ddgan_webp_decode(const uint8_t* data, size_t size, uint8_t* out, size_t out_cap,
                      int64_t* dims, char* err, size_t err_cap) {
    try {
        const Picture pic = parse_container(data, size);
        dims[0] = pic.canvas_h;
        dims[1] = pic.canvas_w;
        if (out == nullptr) return 3;
        const size_t stride = size_t(pic.canvas_w) * 3;
        if (out_cap < stride * size_t(pic.canvas_h)) malformed("the output buffer is smaller than the image");
        std::memset(out, 0, stride * size_t(pic.canvas_h));  // an animation's canvas: transparent black
        uint8_t* dst = out + size_t(pic.y_off) * stride + size_t(pic.x_off) * 3;
        if (pic.image.lossless) {
            VP8LDecoder(pic.image.data, pic.image.size).decode(dst, stride);
        } else {
            VP8Decoder vp8(pic.image.data, pic.image.size);
            vp8.decode();
            vp8.to_rgb(dst, stride);
        }
        return 0;
    } catch (const Failure& f) {
        set_error(err, err_cap, f.what);
        return f.code;
    } catch (const std::exception& e) {
        set_error(err, err_cap, e.what());
        return kMalformed;
    }
}

// The Y, U and V planes of a lossy file's image (frame 0 of an animation),
// cropped to height x width and (height+1)/2 x (width+1)/2, before the output
// stage. dims[0..1] receive the height and width; with y == NULL the call
// returns 3 after the headers. A lossless image returns 2.
int ddgan_webp_decode_yuv(const uint8_t* data, size_t size, uint8_t* y, uint8_t* u, uint8_t* v,
                          int64_t* dims, char* err, size_t err_cap) {
    try {
        const Picture pic = parse_container(data, size);
        if (pic.image.lossless) malformed("the image is lossless ('VP8L'): it has no Y/U/V planes");
        dims[0] = pic.image.height;
        dims[1] = pic.image.width;
        if (y == nullptr) return 3;
        VP8Decoder vp8(pic.image.data, pic.image.size);
        vp8.decode();
        vp8.copy_planes(y, u, v);
        return 0;
    } catch (const Failure& f) {
        set_error(err, err_cap, f.what);
        return f.code;
    } catch (const std::exception& e) {
        set_error(err, err_cap, e.what());
        return kMalformed;
    }
}

// Copy the constant table `name` into out[0:cap]; returns its size in bytes,
// or 0 for an unknown name (for the tests that hold the tables against
// libwebp's).
size_t ddgan_webp_table(const char* name, uint8_t* out, size_t cap) {
    for (const auto& t : kTables) {
        if (std::strcmp(t.name, name) != 0) continue;
        std::memcpy(out, t.data, std::min(cap, t.size));
        return t.size;
    }
    return 0;
}

}  // extern "C"
