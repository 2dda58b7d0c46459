// GIF image data (LZW) behind a plain C interface, bound with ctypes by
// ddgan_torch/data/gif.py, which parses the blocks around it and lays out
// the rows. It decodes as Pillow's GifDecode.c does, so that the pixels
// are PIL's: codes LSB first from the sub-blocks (a zero-length block does
// not end the stream: the next byte is read as a block size), minimum code
// size 0-12, the width growing when the entry 2^width - 1 is added, up to
// 12 bits, no entry added once the table holds 4096; a clear code resets
// the table; each pixel is kept in a byte (a literal of 12-bit codes
// modulo 256). Decoding ends when `count` pixels are out. An end code
// before that ends one call of Pillow's decoder: PIL then reads the next
// 64 KiB of the file and decodes on, or fails at the file's end.
//
// Return codes: 0 done, 2 malformed (err receives a message: data that
// run out, an end code at the file's end, a code past the table).
//
// Build: c++ -O2 -std=c++17 -shared -fPIC (ddgan_torch/ops/_cxx.py).

#include <cstddef>
#include <cstdint>
#include <cstdio>

namespace {

constexpr int kMalformed = 2;
constexpr int kTable = 4096;
constexpr size_t kRead = 65536;  // bytes PIL's ImageFile.load reads at a time

int fail(char* err, size_t cap, const char* msg) {
  if (cap) std::snprintf(err, cap, "%s", msg);
  return kMalformed;
}

}  // namespace

extern "C" int ddgan_gif_lzw(const uint8_t* data, size_t n, size_t pos, int bits, uint8_t* out,
                             size_t count, char* err, size_t err_cap) {
  if (bits < 0 || bits > 12) return fail(err, err_cap, "an LZW minimum code size past 12");
  const int clear = 1 << bits, end = clear + 1;
  static thread_local uint16_t link[kTable];
  static thread_local uint8_t suffix[kTable], first[kTable];
  uint8_t stack[kTable + 1];
  int size = bits + 1, next = end + 1, prev = -1;  // prev: the last code, -1 after a clear
  uint32_t bitbuf = 0;
  int nbits = 0, block = 0;
  size_t window = pos + kRead < n ? pos + kRead : n, done = 0;
  while (done < count) {
    while (nbits < size) {
      if (block > 0) {
        bitbuf |= static_cast<uint32_t>(data[pos++]) << nbits;
        --block;
        nbits += 8;
      } else {  // a sub-block is started only when all of it has been read
        while (pos >= window || pos + 1 + data[pos] > window) {
          if (window >= n) return fail(err, err_cap, "the GIF image data is truncated");
          window = window + kRead < n ? window + kRead : n;
        }
        block = data[pos++];
      }
    }
    const int code = static_cast<int>(bitbuf & ((1u << size) - 1));
    bitbuf >>= size;
    nbits -= size;
    if (code == clear) {
      size = bits + 1;
      next = end + 1;
      prev = -1;
      continue;
    }
    if (code == end) {
      if (window >= n)
        return fail(err, err_cap, "the GIF image data end before the image is full");
      window = window + kRead < n ? window + kRead : n;
      continue;
    }
    if (prev < 0) {  // the first code after a clear: a literal
      if (code > clear) return fail(err, err_cap, "a GIF code past the table after a clear");
      out[done++] = static_cast<uint8_t>(code);
      prev = code;
      continue;
    }
    if (code > next) return fail(err, err_cap, "a GIF code past the next free table entry");
    // the string of `code` (for code == next: prev's, then prev's first byte)
    int top = 0;
    int c = code == next ? prev : code;
    if (code == next) stack[top++] = c < clear ? static_cast<uint8_t>(c) : first[c];
    while (c >= clear) {
      stack[top++] = suffix[c];
      c = link[c];
    }
    const uint8_t head = static_cast<uint8_t>(c);
    stack[top++] = head;
    if (next < kTable) {
      link[next] = static_cast<uint16_t>(prev);
      suffix[next] = head;
      first[next] = prev < clear ? static_cast<uint8_t>(prev) : first[prev];
      if (next == (1 << size) - 1 && size < 12) ++size;
      ++next;
    }
    while (top > 0 && done < count) out[done++] = stack[--top];
    prev = code;
  }
  return 0;
}
