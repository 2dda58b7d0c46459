"""Writers, from the formats' specifications, of image files that PIL
reads but does not write: PNG at any bit depth with Adam7 interlace; BMP
with OS/2 and v3-v5 headers, RLE4, RLE8 and bitfields; PBM, PGM and PPM in
plain and raw form at any maxval; TIFF in strips or tiles, planar or not,
either byte order, classic or BigTIFF, with PackBits, LZW (new and old bit
order), Deflate or LZMA, predictor 2 or 3 (floating point), fill order 2,
or strips coded by a caller (JPEG: `jpeg_tiff`); baseline JPEG at any
sampling factors (`jpeg_encode`), which PIL cannot write.

The tests hold the port's readers against PIL on these files. This module
imports numpy and the standard library only (`chip_smoke.py` loads it by
path on the chip host), nothing of the port or of PIL.
"""

from __future__ import annotations

import lzma
import struct
import zlib

import numpy as np

# ---------------------------------------------------------------------- PNG
PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4), (2, 0, 4, 2), (0, 1, 2, 2),
         (1, 0, 2, 1))


def _png_chunk(tag: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + tag + body
            + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))


def _pack_row(samples: np.ndarray, depth: int) -> bytes:
    """One row of samples (W * channels,) as PNG bytes at `depth`."""
    if depth == 16:
        return samples.astype(">u2").tobytes()
    if depth == 8:
        return samples.astype(np.uint8).tobytes()
    bits = ((samples[:, None].astype(np.uint8) >> np.arange(depth - 1, -1, -1)) & 1).ravel()
    return np.packbits(bits).tobytes()


def _filter_row(row: bytes, prior: bytes, bpp: int, kind: int) -> bytes:
    cur = np.frombuffer(row, np.uint8).astype(np.int64)
    up = np.frombuffer(prior, np.uint8).astype(np.int64) if prior else np.zeros_like(cur)
    left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
    upleft = np.concatenate([np.zeros(bpp, np.int64), up[:-bpp]])
    if kind == 0:
        pred = np.zeros_like(cur)
    elif kind == 1:
        pred = left
    elif kind == 2:
        pred = up
    elif kind == 3:
        pred = (left + up) // 2
    else:
        pa, pb, pc = np.abs(up - upleft), np.abs(left - upleft), np.abs(left + up - 2 * upleft)
        pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, upleft))
    return bytes([kind]) + ((cur - pred) % 256).astype(np.uint8).tobytes()


def png(samples: np.ndarray, color: int, depth: int, interlace: int = 0,
        palette: np.ndarray | None = None, filters: int | None = None) -> bytes:
    """A PNG of `samples` (H, W, channels) at `depth` and colour type
    `color`, Adam7-interlaced if `interlace`; row y of each pass takes filter
    `(y + pass) % 5`, or `filters` for every row."""
    h, w = samples.shape[:2]
    channels = PNG_CHANNELS[color]
    samples = samples.reshape(h, w, channels)
    bpp = max(1, depth * channels // 8)
    passes = ADAM7 if interlace else ((0, 0, 1, 1),)
    raw = bytearray()
    for p, (y0, x0, dy, dx) in enumerate(passes):
        sub = samples[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        prior = b""
        for y in range(sub.shape[0]):
            row = _pack_row(sub[y].ravel(), depth)
            raw += _filter_row(row, prior, bpp, (y + p) % 5 if filters is None else filters)
            prior = row
    out = b"\x89PNG\r\n\x1a\n" + _png_chunk(
        b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, interlace))
    if palette is not None:
        out += _png_chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    z = zlib.compress(bytes(raw))
    return out + _png_chunk(b"IDAT", z[:7]) + _png_chunk(b"IDAT", z[7:]) + _png_chunk(b"IEND", b"")


# ---------------------------------------------------------------------- BMP
def _bmp_rows(indices: np.ndarray, bits: int) -> list:
    """Rows (top first) of palette indices or packed pixels, each padded
    to 4 bytes."""
    out = []
    for row in indices:
        if bits < 8:
            b = ((row[:, None].astype(np.uint8) >> np.arange(bits - 1, -1, -1)) & 1).ravel()
            data = np.packbits(b).tobytes()
        else:
            data = row.astype(np.uint8).tobytes()
        out.append(data + b"\0" * (-len(data) % 4))
    return out


def rle_encode(indices: np.ndarray, rle4: bool, absolute: bool = True) -> bytes:
    """Rows of palette indices (bottom row first) RLE8- or RLE4-coded:
    runs of a value (for RLE4, of a pair of alternating values) as encoded
    runs, other stretches of 3 or more in absolute mode, an end of line
    after each row and an end of bitmap last."""
    out = bytearray()
    for row in indices:
        x, w = 0, len(row)
        while x < w:
            n = 1
            if rle4:
                while x + n < w and n < 255 and row[x + n] == row[x + (n % 2)]:
                    n += 1
            else:
                while x + n < w and n < 255 and row[x + n] == row[x]:
                    n += 1
            if n >= 3 or not absolute:
                pair = (int(row[x]) << 4 | int(row[x + 1 if n > 1 else x])) if rle4 else int(row[x])
                out += bytes([n, pair])
                x += n
                continue
            # absolute: up to the next run of 3, at least 3 pixels
            e = x
            while e < w and e - x < 254 and not (e + 2 < w and row[e] == row[e + 1] == row[e + 2]):
                e += 1
            e = max(e, min(x + 3, w))
            if e - x < 3:
                for k in range(x, e):
                    out += bytes([1, (int(row[k]) << 4) if rle4 else int(row[k])])
                x = e
                continue
            seg = row[x:e]
            if rle4:
                vals = list(seg) + ([0] if len(seg) % 2 else [])
                body = bytes(int(vals[k]) << 4 | int(vals[k + 1]) for k in range(0, len(vals), 2))
            else:
                body = bytes(int(v) for v in seg)
            out += bytes([0, len(seg)]) + body + (b"\0" if len(body) % 2 else b"")
            x = e
        out += b"\0\0"
    return bytes(out + b"\0\1")


def bmp(pixels: np.ndarray, bits: int, *, header: int = 40, palette: np.ndarray | None = None,
        compression: int = 0, masks: tuple | None = None, top_down: bool = False,
        colors: int | None = None) -> bytes:
    """A BMP file. `pixels` are palette indices (H, W) for bits <= 8, else
    (H, W, 3) RGB (bits 24, 32) or packed 16/32-bit words (H, W) for
    bitfields and 16-bit; `header` 12 (OS/2), 40, 52, 56, 108 or 124;
    `compression` 0 (BI_RGB), 1 (RLE8), 2 (RLE4), 3 (BI_BITFIELDS, masks
    after a 40-byte header or inside a longer one)."""
    h, w = pixels.shape[:2]
    if bits <= 8:
        rows = None
    elif bits == 24:
        rows = [np.ascontiguousarray(r[:, ::-1]).tobytes() for r in pixels]
        rows = [r + b"\0" * (-len(r) % 4) for r in rows]
    elif bits == 32 and pixels.ndim == 3:
        bgrx = np.concatenate([pixels[:, :, ::-1], np.full((h, w, 1), 0x5A, np.uint8)], axis=2)
        rows = [r.tobytes() for r in bgrx]
    else:
        dt = "<u2" if bits == 16 else "<u4"
        rows = [r.astype(dt).tobytes() for r in pixels]
        rows = [r + b"\0" * (-len(r) % 4) for r in rows]
    if bits <= 8:
        order = pixels if top_down else pixels[::-1]
        if compression in (1, 2):
            body = rle_encode(order, rle4=compression == 2)
        else:
            body = b"".join(_bmp_rows(order, bits))
    else:
        body = b"".join(rows if top_down else rows[::-1])
    pal = b""
    if palette is not None:
        pal_arr = np.asarray(palette, np.uint8)[:, ::-1]
        if header != 12:
            pal_arr = np.concatenate([pal_arr, np.zeros((len(pal_arr), 1), np.uint8)], axis=1)
        pal = pal_arr.tobytes()
    if header == 12:
        info = struct.pack("<IHHHH", 12, w, h, 1, bits)
    else:
        info = struct.pack("<IiiHHIIiiII", header, w, -h if top_down else h, 1, bits,
                           compression, len(body), 2835, 2835,
                           len(palette) if colors is None and palette is not None else
                           (colors or 0), 0)
        extra = b""
        if header > 40:
            m = masks if masks is not None else (0, 0, 0, 0)
            m = tuple(m) + (0,) * (4 - len(m))
            extra = struct.pack("<IIII", *m)[:header - 40]
            extra += b"\0" * (header - 40 - len(extra))
        elif compression == 3:
            pal = struct.pack("<III", *masks[:3]) + pal
        info += extra
    offset = 14 + len(info) + len(pal)
    return (b"BM" + struct.pack("<IHHI", offset + len(body), 0, 0, offset) + info + pal + body)


# ------------------------------------------------------------------- Netpbm
def netpbm(pixels: np.ndarray, magic: str, maxval: int = 255, comment: bool = True) -> bytes:
    """P1-P6 bytes of `pixels` ((H, W) bits for P1/P4 with 1 = black,
    (H, W) grey for P2/P5, (H, W, 3) for P3/P6) at `maxval`, with a
    comment and mixed whitespace in the header."""
    h, w = pixels.shape[:2]
    head = f"{magic}\n" + ("# written by the tests\n" if comment else "") + f"{w}\t{h}\r\n"
    if magic not in ("P1", "P4"):
        head += f"  {maxval}\n"
    head = head.encode()
    if magic == "P4":
        return head + np.packbits(pixels.astype(np.uint8), axis=1).tobytes()
    if magic == "P1":
        lines = ["".join(str(int(v)) for v in row[:5]) + " " + " ".join(str(int(v)) for v in row[5:])
                 for row in pixels]
        return head + ("\n".join(lines) + "\n").encode()
    if magic in ("P2", "P3"):
        flat = pixels.reshape(h, -1)
        text = "\n".join(" ".join(str(int(v)) for v in row) + (" # row" if y == 0 else "")
                         for y, row in enumerate(flat))
        return head + (text + "\n").encode()
    dt = ">u2" if maxval > 255 else np.uint8
    return head + pixels.astype(dt).tobytes()


# --------------------------------------------------------------------- TIFF
def packbits(data: bytes) -> bytes:
    """Apple PackBits: runs of 2-128 equal bytes as (257 - n, b), other
    stretches as (n - 1, bytes)."""
    out, i, n = bytearray(), 0, len(data)
    while i < n:
        j = i
        while j + 1 < n and data[j + 1] == data[i] and j - i < 127:
            j += 1
        if j > i:
            out += bytes([257 - (j - i + 1), data[i]])
            i = j + 1
            continue
        j = i
        while j < n and j - i < 128 and not (j + 1 < n and data[j + 1] == data[j]):
            j += 1
        j = max(j, i + 1)
        out += bytes([j - i - 1]) + data[i:j]
        i = j
    return bytes(out)


def lzw(data: bytes, old: bool = False) -> bytes:
    """TIFF LZW: MSB-first codes from 9 to 12 bits, Clear (256) first and
    after the table fills, EOI (257) last, each width step one code early
    (TIFF 6.0). `old` writes the pre-6.0 form libtiff still reads:
    LSB-first codes whose width steps at the table's size."""
    out, acc, nacc = bytearray(), 0, 0
    width, table, nxt = 9, {}, 258

    def put(code: int) -> None:
        nonlocal acc, nacc
        if old:
            acc |= code << nacc
            nacc += width
            while nacc >= 8:
                out.append(acc & 0xFF)
                acc >>= 8
                nacc -= 8
        else:
            acc = (acc << width) | code
            nacc += width
            while nacc >= 8:
                out.append((acc >> (nacc - 8)) & 0xFF)
                nacc -= 8
                acc &= (1 << nacc) - 1

    def step() -> None:
        # libtiff's encoder widens once the next entry needs it (free > 2^n - 1);
        # the old form's decoder widens one entry later
        nonlocal width
        if width < 12 and (nxt > (1 << width) if old else nxt >= (1 << width)):
            width += 1

    put(256)
    w = b""
    for c in data:
        wc = w + bytes([c])
        if len(wc) == 1 or wc in table:
            w = wc
            continue
        put(table[w] if len(w) > 1 else w[0])
        table[wc] = nxt
        nxt += 1
        step()
        if nxt >= 4094:
            put(256)
            table, nxt, width = {}, 258, 9
        w = bytes([c])
    if w:
        put(table[w] if len(w) > 1 else w[0])
        nxt += 1
        step()
    put(257)
    if nacc:
        out.append(((acc << (8 - nacc)) & 0xFF) if not old else acc & 0xFF)
    return bytes(out)


def predict(block: np.ndarray, bits: int) -> np.ndarray:
    """Horizontal differencing (predictor 2) of (rows, W, samples) samples."""
    dt = {8: np.uint8, 16: np.uint16, 32: np.uint32}.get(bits, np.uint8)
    same_width = block.dtype.itemsize == bits // 8
    a = np.ascontiguousarray(block).view(dt) if same_width else block.astype(dt)
    out = a.copy()
    out[:, 1:] = a[:, 1:] - a[:, :-1]
    return out


def predict_float(block: np.ndarray) -> bytes:
    """Floating-point differencing (predictor 3, tif_predict.c fpDiff) of
    (rows, W, samples) float32: each row's bytes split into planes, most
    significant first, then differenced `samples` bytes apart."""
    rows, w, spp = block.shape
    b = np.ascontiguousarray(block, "<f4").view(np.uint8).reshape(rows, w * spp, 4)
    planes = b[:, :, ::-1].transpose(0, 2, 1).reshape(rows, -1).astype(np.int16)
    planes[:, spp:] -= planes[:, :-spp].copy()
    return (planes & 0xFF).astype(np.uint8).tobytes()


REVERSED = bytes(int(f"{i:08b}"[::-1], 2) for i in range(256))  # each byte's bits reversed
_TIFF_FORMATS = {1: "B", 3: "H", 4: "I", 5: "II", 7: "B", 16: "Q"}


def patch_tag(data: bytes, tag: int, value) -> bytes:
    """A classic TIFF with the inline SHORT or LONG `tag` set to `value`,
    or to `value(old)` if it is callable."""
    e = "<" if data[:2] == b"II" else ">"
    (ifd,) = struct.unpack_from(e + "I", data, 4)
    (count,) = struct.unpack_from(e + "H", data, ifd)
    out = bytearray(data)
    for k in range(count):
        at = ifd + 2 + 12 * k
        t, typ = struct.unpack_from(e + "HH", data, at)
        if t == tag:
            fmt = e + ("H" if typ == 3 else "I")
            (old,) = struct.unpack_from(fmt, data, at + 8)
            struct.pack_into(fmt, out, at + 8, value(old) if callable(value) else value)
            return bytes(out)
    raise KeyError(tag)


def tiff(samples: np.ndarray, *, photometric: int, bits: int = 8, order: str = "II",
         compression: int = 1, predictor: int = 1, planar: int = 1, rows_per_strip: int | None = None,
         tile: tuple | None = None, extra: tuple = (), colormap: np.ndarray | None = None,
         orientation: int | None = None, old_lzw: bool = False, sample_format: int | None = None,
         overrides: dict | None = None, big: bool = False, fill_order: int = 1,
         encode=None) -> bytes:
    """A one-image TIFF of `samples` (H, W, S) (uint8, uint16 or 0/1 for
    bits 1; int8/16/32 or float32 at their bits) with the given tags.
    Strips of `rows_per_strip` rows (default: one strip), or tiles of
    `tile` (height, width); planar 2 stores each sample as its own planes.
    Compression 1, 5 (LZW), 8 / 32946 (Deflate), 32773 (PackBits) or 34925
    (LZMA); predictor 2 differences samples along a row, predictor 3 is
    the floating-point one; fill order 2 reverses each stored byte's bits;
    `encode(block)` codes each strip or tile itself instead; `big` writes a
    BigTIFF (offsets as LONG8); `overrides` replaces tags, as (type,
    values) with values bytes for types 1 and 7, after the data is written."""
    e = "<" if order == "II" else ">"
    h, w, s = samples.shape

    def pack(block: np.ndarray) -> bytes:
        """(rows, cols, samples) -> the stored bytes of a strip or tile."""
        if predictor == 3:
            return predict_float(block)
        if predictor == 2:
            block = predict(block, bits).view(block.dtype) if bits == 32 else predict(block, bits)
        if bits == 1:
            return np.packbits(block.reshape(block.shape[0], -1).astype(np.uint8), axis=1).tobytes()
        if bits == 16:
            return block.astype(block.dtype.newbyteorder(e) if block.dtype.kind == "i"
                                else e + "u2").tobytes()
        if bits == 32:
            return block.astype(block.dtype.newbyteorder(e)).tobytes()
        return block.astype(np.uint8).tobytes()

    def compress(raw: bytes) -> bytes:
        if compression == 1:
            out = raw
        elif compression == 5:
            out = lzw(raw, old=old_lzw)
        elif compression in (8, 32946):
            out = zlib.compress(raw)
        elif compression == 32773:
            out = packbits(raw)
        elif compression == 34925:
            out = lzma.compress(raw)
        else:
            raise ValueError(compression)
        return out.translate(REVERSED) if fill_order == 2 else out

    if encode is not None:
        def code(block: np.ndarray) -> bytes:
            return encode(block)
    else:
        def code(block: np.ndarray) -> bytes:
            return compress(pack(block))

    planes = [samples[:, :, k:k + 1] for k in range(s)] if planar == 2 else [samples]
    chunks = []
    if tile is None:
        rps = rows_per_strip or h
        for plane in planes:
            for y in range(0, h, rps):
                chunks.append(code(plane[y:y + rps]))
    else:
        th, tw = tile
        for plane in planes:
            for y in range(0, h, th):
                for x in range(0, w, tw):
                    block = np.zeros((th, tw, plane.shape[2]), plane.dtype)
                    part = plane[y:y + th, x:x + tw]
                    block[:part.shape[0], :part.shape[1]] = part
                    chunks.append(code(block))
    entries = {256: (4, [w]), 257: (4, [h]), 258: (3, [bits] * s), 259: (3, [compression]),
               262: (3, [photometric]), 277: (3, [s]), 284: (3, [planar])}
    if predictor != 1:
        entries[317] = (3, [predictor])
    if extra:
        entries[338] = (3, list(extra))
    if colormap is not None:
        entries[320] = (3, [int(v) for v in np.asarray(colormap).T.ravel()])
    if orientation is not None:
        entries[274] = (3, [orientation])
    if sample_format is not None:
        entries[339] = (3, [sample_format] * s)
    if fill_order != 1:
        entries[266] = (3, [fill_order])
    if tile is None:
        entries[278] = (4, [rows_per_strip or h])
        off_tag, cnt_tag = 273, 279
    else:
        entries[322] = (4, [tile[1]])
        entries[323] = (4, [tile[0]])
        off_tag, cnt_tag = 324, 325
    # layout: header, data chunks, then IFD and its out-of-line values
    magic = (b"II" if order == "II" else b"MM") + struct.pack(e + "H", 43 if big else 42)
    out = bytearray(magic + (struct.pack(e + "HHQ", 8, 0, 0) if big else struct.pack(e + "I", 0)))
    offsets = []
    for c in chunks:
        offsets.append(len(out))
        out += c
        if len(out) % 2:
            out += b"\0"
    entries[off_tag] = (16 if big else 4, offsets)
    entries[cnt_tag] = (16 if big else 4, [len(c) for c in chunks])
    entries.update(overrides or {})  # (type, values) by tag, the data as written
    ifd_at = len(out)
    ofmt, nfmt, inline = ("Q", "Q", 8) if big else ("I", "H", 4)
    struct.pack_into(e + ofmt, out, 8 if big else 4, ifd_at)
    tags = sorted(entries)
    entry = 20 if big else 12
    values_at = ifd_at + struct.calcsize(nfmt) + entry * len(tags) + inline
    ifd, tail = bytearray(struct.pack(e + nfmt, len(tags))), bytearray()
    for tag in tags:
        typ, vals = entries[tag]
        data = bytes(vals) if typ in (1, 7) else struct.pack(
            e + _TIFF_FORMATS[typ] * len(vals),
            *(x for v in vals for x in (v if typ == 5 else (v,))))  # RATIONALs as (num, den)
        if len(data) <= inline:
            ifd += struct.pack(e + "HH" + ofmt, tag, typ, len(vals)) + data + b"\0" * (
                inline - len(data))
        else:
            ifd += struct.pack(e + "HH" + ofmt + ofmt, tag, typ, len(vals), values_at + len(tail))
            tail += data
            if len(tail) % 2:
                tail += b"\0"
    ifd += struct.pack(e + ofmt, 0)
    return bytes(out + ifd + tail)


# ------------------------------------------------------------------ matrices
# The files the tests and `chip_smoke.py` hold the port's readers to,
# written here or by PIL (`Image` is PIL's module, passed in), each
# (label, bytes). Every one decodes through PIL's `Image.open(f).convert("RGB")`.
PNG_LAYOUTS = [(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8), (2, 16), (3, 1), (3, 2), (3, 4),
               (3, 8), (4, 8), (4, 16), (6, 8), (6, 16)]  # (colour type, bit depth)
PNG_SIZES = [(1, 1), (2, 3), (5, 9), (9, 9), (9, 1), (17, 13)]


def png_file(rs, color: int, depth: int, interlace: int, h: int, w: int) -> bytes:
    samples = rs.randint(0, 1 << depth, (h, w, PNG_CHANNELS[color]))
    palette = rs.randint(0, 256, (1 << depth, 3)) if color == 3 else None
    return png(samples, color, depth, interlace, palette)


def png_matrix(Image, sizes=PNG_SIZES) -> list:
    """Every colour type at every depth, Adam7 or not, at `sizes`; and PIL's
    own 16-bit grey, 1-bit and sub-byte palette files."""
    import io

    rs = np.random.RandomState(1)
    out = [(f"png c{c} d{d} {'adam7' if i else 'plain'} {h}x{w}", png_file(rs, c, d, i, h, w))
           for c, d in PNG_LAYOUTS for i in (0, 1) for h, w in sizes]
    for name, im, kw in (
            ("I;16", Image.fromarray(rs.randint(0, 65536, (11, 13)).astype(np.uint16)), {}),
            ("1", Image.fromarray(rs.randint(0, 256, (11, 13)).astype(np.uint8)).convert("1"), {}),
            ("P bits 1", Image.fromarray(rs.randint(0, 2, (11, 13)).astype(np.uint8), "P"),
             dict(bits=1)),
            ("P bits 2", Image.fromarray(rs.randint(0, 4, (11, 13)).astype(np.uint8), "P"),
             dict(bits=2)),
            ("P bits 4", Image.fromarray(rs.randint(0, 16, (11, 13)).astype(np.uint8), "P"),
             dict(bits=4))):
        if im.mode == "P":
            im.putpalette(rs.randint(0, 256, 768).astype(np.uint8).tolist())
        buf = io.BytesIO()
        im.save(buf, "PNG", **kw)
        out.append((f"png PIL {name}", buf.getvalue()))
    return out


BMP_SIZES = [(1, 1), (3, 7), (9, 17), (16, 33)]
BITFIELDS_16 = [(0xF800, 0x7E0, 0x1F), (0x7C00, 0x3E0, 0x1F)]
BITFIELDS_32 = [(0xFF0000, 0xFF00, 0xFF, 0), (0xFF000000, 0xFF0000, 0xFF00, 0),
                (0xFF000000, 0xFF00, 0xFF, 0), (0xFF000000, 0xFF0000, 0xFF00, 0xFF),
                (0xFF, 0xFF00, 0xFF0000, 0xFF000000), (0xFF0000, 0xFF00, 0xFF, 0xFF000000),
                (0xFF000000, 0xFF00, 0xFF, 0xFF0000), (0, 0, 0, 0)]


def bmp_matrix(Image, sizes=BMP_SIZES) -> list:
    """Each header (OS/2 12, 40, 108, 124), bottom-up and top-down; 1, 4 and
    8 bits with palettes of 2, 3 and 2^bits colours; RLE8 and RLE4; 16
    (5-5-5), 24 and 32 bits; every BI_BITFIELDS layout PIL reads; grey
    palettes (PIL's "1" and "L"); and PIL's own files."""
    import io

    rs = np.random.RandomState(2)
    out = []
    for h, w in sizes:
        for header in (12, 40, 108, 124):
            for td in ((False,) if header == 12 else (False, True)):
                tag = f"{header} {'top-down' if td else 'bottom-up'} {h}x{w}"
                for bits in (1, 4, 8):
                    for ncol in sorted({2, 3, 1 << bits}):
                        idx = rs.randint(0, 1 << bits, (h, w))
                        pal = rs.randint(0, 256, (ncol, 3))
                        out.append((f"bmp {bits}-bit {ncol} colours {tag}",
                                    bmp(idx, bits, header=header, palette=pal, top_down=td)))
                        if header != 12 and bits in (4, 8) and not td:
                            runs = np.repeat(idx[:, ::3], 3, axis=1)[:, :w]
                            out.append((f"bmp RLE{bits} {ncol} colours {tag}",
                                        bmp(runs, bits, header=header, palette=pal,
                                            compression=1 if bits == 8 else 2)))
                for bits in (24, 32):
                    out.append((f"bmp {bits}-bit {tag}",
                                bmp(rs.randint(0, 256, (h, w, 3)).astype(np.uint8), bits,
                                    header=header, top_down=td)))
                if header == 12:
                    continue
                out.append((f"bmp 16-bit {tag}",
                            bmp(rs.randint(0, 1 << 16, (h, w)), 16, header=header, top_down=td)))
                for m in BITFIELDS_16:
                    out.append((f"bmp bitfields {m} {tag}",
                                bmp(rs.randint(0, 1 << 16, (h, w)), 16, header=header,
                                    compression=3, masks=m, top_down=td)))
                for m in BITFIELDS_32:
                    if header == 40 and m[3]:
                        continue
                    out.append((f"bmp bitfields {m} {tag}",
                                bmp(rs.randint(0, 1 << 32, (h, w), dtype=np.uint64), 32,
                                    header=header, compression=3, masks=m, top_down=td)))
    grey2 = np.array([[0, 0, 0], [255, 255, 255]])
    grey256 = np.repeat(np.arange(256)[:, None], 3, axis=1)
    out.append(("bmp 1-bit black and white", bmp(rs.randint(0, 2, (5, 9)), 1, palette=grey2)))
    out.append(("bmp 8-bit grey ramp", bmp(rs.randint(0, 256, (5, 9)), 8, palette=grey256)))
    for mode in ("1", "L", "P", "RGB", "RGBA"):
        im = Image.fromarray(rs.randint(0, 256, (7, 9, 3)).astype(np.uint8)).convert(mode)
        buf = io.BytesIO()
        im.save(buf, "BMP")
        out.append((f"bmp PIL {mode}", buf.getvalue()))
    return out


NETPBM_SIZES = [(1, 1), (3, 7), (9, 17)]


def netpbm_matrix(Image, sizes=NETPBM_SIZES) -> list:
    """P1-P6 at maxvals 1, 15, 255, 1000 and 65535, with comments and mixed
    whitespace; and PIL's own files."""
    import io

    rs = np.random.RandomState(3)
    out = []
    for magic in ("P1", "P2", "P3", "P4", "P5", "P6"):
        for maxval in ((1,) if magic in ("P1", "P4") else (1, 15, 255, 1000, 65535)):
            for h, w in sizes:
                shape = (h, w, 3) if magic in ("P3", "P6") else (h, w)
                px = rs.randint(0, maxval + 1, shape)
                out.append((f"netpbm {magic} maxval {maxval} {h}x{w}",
                            netpbm(px, magic, maxval, comment=(h + w) % 2 == 0)))
    for mode in ("1", "L", "RGB", "I;16"):
        arr = rs.randint(0, 256, (7, 9, 3)).astype(np.uint8)
        im = (Image.fromarray(rs.randint(0, 65536, (7, 9)).astype(np.uint16)) if mode == "I;16"
              else Image.fromarray(arr).convert(mode))
        buf = io.BytesIO()
        im.save(buf, "PPM")
        out.append((f"netpbm PIL {mode}", buf.getvalue()))
    return out


# (name, photometric, bits, samples, ExtraSamples)
TIFF_LAYOUTS = [("L8", 1, 8, 1, ()), ("L8 min-is-white", 0, 8, 1, ()), ("1-bit", 1, 1, 1, ()),
                ("1-bit min-is-white", 0, 1, 1, ()), ("L4", 1, 4, 1, ()),
                ("L2 min-is-white", 0, 2, 1, ()), ("I16", 1, 16, 1, ()),
                ("RGB", 2, 8, 3, ()), ("RGB16", 2, 16, 3, ()), ("RGBA", 2, 8, 4, (2,)),
                ("RGBa", 2, 8, 4, (1,)), ("RGBX", 2, 8, 4, (0,)), ("RGBA16", 2, 16, 4, (2,)),
                ("RGBa16", 2, 16, 4, (1,)), ("P8", 3, 8, 1, ()), ("P4", 3, 4, 1, ()),
                ("P1", 3, 1, 1, ()), ("LA", 1, 8, 2, (2,)), ("CMYK", 5, 8, 4, ())]
TIFF_COMPRESSIONS = (1, 5, 8, 32946, 32773)


def tiff_file(rs, layout, order: str, compression: int, predictor: int, storage: str,
              planar: int, old_lzw: bool = False) -> bytes:
    name, photo, bits, spp, extra = layout
    h, w = (19, 21) if storage == "tiles" else (13, 11)
    top = 1 << bits
    s = rs.randint(0, top, (h, w, spp))
    if 1 in extra:  # associated alpha: colours at most the alpha
        s[:, :, :3] = s[:, :, :3] * s[:, :, 3:4] // (top - 1)
    s = s.astype(np.uint16 if bits == 16 else np.uint8)
    cmap = rs.randint(0, 65536, (top, 3)) if photo == 3 else None
    kw = {"strips": dict(rows_per_strip=4), "tiles": dict(tile=(16, 16))}.get(storage, {})
    return tiff(s, photometric=photo, bits=bits, order=order, compression=compression,
                predictor=predictor, planar=planar, extra=extra, colormap=cmap,
                old_lzw=old_lzw, **kw)


def tiff_cases() -> list:
    """(layout, order, compression, predictor, storage, planar) of every
    TIFF in the matrix that PIL reads and the port reads: predictor 2 with
    LZW and Deflate at 8 and 16 bits; planar files compressed, or
    uncompressed at 8 bits without an unspecified extra sample."""
    out = []
    for layout in TIFF_LAYOUTS:
        _, _, bits, spp, extra = layout
        for order in ("II", "MM"):
            for comp in TIFF_COMPRESSIONS:
                for pred in ((1, 2) if bits in (8, 16) and comp in (5, 8, 32946) else (1,)):
                    for storage in ("one strip", "strips", "tiles"):
                        for planar in ((1, 2) if spp > 1 else (1,)):
                            if planar == 2 and (0 in extra or (comp == 1 and bits != 8)):
                                continue
                            if planar == 2 and comp == 1 and (1 in extra or layout[1] not in (2, 5)):
                                continue
                            if bits == 16 and layout[1] == 0 and order == "MM":
                                continue
                            out.append((layout, order, comp, pred, storage, planar))
    return out


def tiff_matrix(Image) -> list:
    import io

    rs = np.random.RandomState(4)
    out = []
    for layout, order, comp, pred, storage, planar in tiff_cases():
        out.append((f"tiff {layout[0]} {order} compression {comp} predictor {pred} {storage} "
                    f"planar {planar}", tiff_file(rs, layout, order, comp, pred, storage, planar)))
    for o in range(1, 9):
        out.append((f"tiff orientation {o}",
                    tiff(rs.randint(0, 256, (5, 7, 3)).astype(np.uint8), photometric=2,
                         orientation=o)))
    for old in (False, True):  # LZW through table resets and every code width
        arr = rs.randint(0, 6, (300, 200, 3)).astype(np.uint8)
        out.append((f"tiff LZW {'old' if old else 'new'} form 300x200",
                    tiff(arr, photometric=2, compression=5, old_lzw=old)))
    for mode in ("1", "L", "P", "RGB", "RGBA", "CMYK", "I;16"):
        for comp in (None, "tiff_lzw", "tiff_adobe_deflate", "packbits"):
            im = (Image.fromarray(rs.randint(0, 65536, (7, 9)).astype(np.uint16))
                  if mode == "I;16" else
                  Image.fromarray(rs.randint(0, 256, (7, 9, 3)).astype(np.uint8)).convert(mode))
            buf = io.BytesIO()
            im.save(buf, "TIFF", compression=comp)
            out.append((f"tiff PIL {mode} {comp}", buf.getvalue()))
    return out


# ------------------------------------------------------------------- JPEG
JPEG_SIZES = [(1, 1), (7, 9), (17, 33), (255, 257)]
JPEG_LAYOUTS = {"4:4:4": 0, "4:2:2": 1, "4:2:0": 2, "L": None}


def smooth_field(rs, h: int, w: int, channels: int) -> np.ndarray:
    """A smooth field per channel plus noise: flat blocks and busy ones."""
    yy, xx = np.mgrid[0:h, 0:w]
    planes = []
    for _ in range(channels):
        a, b, phase = rs.uniform(0.02, 0.25, 3)
        planes.append(127 + 90 * np.sin(a * xx + phase) * np.cos(b * yy)
                      + rs.normal(0, 14, (h, w)))
    return np.clip(np.stack(planes, -1), 0, 255).astype(np.uint8)


def pil_jpeg(Image, rs, h: int, w: int, layout: str, **save) -> bytes:
    """A smooth field written by PIL as a JPEG of `layout`."""
    import os
    import tempfile

    arr = smooth_field(rs, h, w, 1 if layout == "L" else 3)
    im = Image.fromarray(arr[:, :, 0] if layout == "L" else arr)
    if layout != "L":
        save.setdefault("subsampling", JPEG_LAYOUTS[layout])
    # through a file: PIL's progressive writer cannot always suspend into a BytesIO
    fd, path = tempfile.mkstemp(suffix=".jpg")
    os.close(fd)
    try:
        im.save(path, "JPEG", **save)
        with open(path, "rb") as f:
            return f.read()
    finally:
        os.unlink(path)


def set_adobe_transform(data: bytes, transform: int) -> bytes:
    k = data.index(b"Adobe")
    return data[:k + 11] + bytes([transform]) + data[k + 12:]


def rgb_ids(data: bytes) -> bytes:
    """A 3-component JPEG without its JFIF or Adobe marker and with
    component IDs 'R', 'G', 'B': libjpeg takes it as RGB-coded."""
    out, pos = bytearray(data[:2]), 2
    while True:
        m = data[pos + 1]
        length = int.from_bytes(data[pos + 2:pos + 4], "big")
        seg = bytearray(data[pos:pos + 2 + length])
        if m in (0xE0, 0xEE):
            pos += 2 + length
            continue
        if m in (0xC0, 0xC1, 0xC2):
            for i in range(3):
                seg[10 + 3 * i] = b"RGB"[i]
        if m == 0xDA:
            for i in range(seg[4]):
                seg[5 + 2 * i] = b"RGB"[seg[5 + 2 * i] - 1]
            return bytes(out + seg + data[pos + 2 + length:])
        out += seg
        pos += 2 + length


def jpeg_matrix(Image, arith, sizes=JPEG_SIZES) -> list:
    """Progressive files as PIL writes them (its scan script) in every
    layout and size, at q75 and q95, with optimized tables and restart
    markers; arithmetic-coded ones (`arith`: tests/_torch_jpeg_arith.py),
    sequential and progressive, in every layout and size, with restart
    markers and DAC conditioning; CMYK and YCCK files, progressive or not;
    RGB-coded files (PIL's keep_rgb, and component IDs 'R', 'G', 'B')."""
    rs = np.random.RandomState(5)
    out = []
    for h, w in sizes:
        for layout in JPEG_LAYOUTS:
            for q in (75, 95):
                out.append((f"jpeg progressive {layout} q{q} {h}x{w}",
                            pil_jpeg(Image, rs, h, w, layout, quality=q, progressive=True)))
            base = pil_jpeg(Image, rs, h, w, layout, quality=85)
            for prog in (False, True):
                out.append((f"jpeg arithmetic {'progressive' if prog else 'sequential'} "
                            f"{layout} q85 {h}x{w}", arith.to_arithmetic(base, progressive=prog)))
    for layout in JPEG_LAYOUTS:
        out.append((f"jpeg progressive {layout} optimized 37x45",
                    pil_jpeg(Image, rs, 37, 45, layout, quality=85, progressive=True,
                             optimize=True)))
        out.append((f"jpeg progressive {layout} restart every MCU 37x45",
                    pil_jpeg(Image, rs, 37, 45, layout, quality=85, progressive=True,
                             restart_marker_blocks=1)))
        base = pil_jpeg(Image, rs, 37, 45, layout, quality=85)
        for prog in (False, True):
            kind = "progressive" if prog else "sequential"
            out.append((f"jpeg arithmetic {kind} {layout} restart every 2 MCUs 37x45",
                        arith.to_arithmetic(base, progressive=prog, restart=2)))
            out.append((f"jpeg arithmetic {kind} {layout} DAC 37x45",
                        arith.to_arithmetic(base, progressive=prog, dac=True)))
    for h, w in ((1, 1), (9, 13), (40, 33)):
        for prog in (False, True):
            cmyk = Image.fromarray(rs.randint(0, 256, (h, w, 4)).astype(np.uint8), "CMYK")
            data = pil_jpeg_image(Image, cmyk, quality=90, progressive=prog)
            kind = "progressive" if prog else "sequential"
            out.append((f"jpeg CMYK {kind} {h}x{w}", data))
            out.append((f"jpeg YCCK {kind} {h}x{w}", set_adobe_transform(data, 2)))
        rgb = smooth_field(rs, h, w, 3)
        data = pil_jpeg_image(Image, Image.fromarray(rgb), quality=90, keep_rgb=True,
                              subsampling=0)
        out.append((f"jpeg RGB-coded (Adobe transform 0) {h}x{w}", data))
        out.append((f"jpeg RGB-coded (component IDs) {h}x{w}",
                    rgb_ids(pil_jpeg_image(Image, Image.fromarray(rgb), quality=90))))
    return out


def pil_jpeg_image(Image, im, **save) -> bytes:
    import io

    buf = io.BytesIO()
    im.save(buf, "JPEG", **save)
    return buf.getvalue()


# ------------------------------------------------- JPEG at any sampling
ZIGZAG = [0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41, 34,
          27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44,
          51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63]  # zigzag -> natural
_DCT = np.array([[(np.sqrt(0.125) if u == 0 else 0.5) * np.cos((2 * x + 1) * u * np.pi / 16)
                  for x in range(8)] for u in range(8)])


def jpeg_segments(data: bytes) -> list:
    """(marker, whole segment bytes) of a JPEG's segments before its first SOS."""
    pos, out = 2, []
    while data[pos + 1] != 0xDA:
        length = int.from_bytes(data[pos + 2:pos + 4], "big")
        out.append((data[pos + 1], data[pos:pos + 2 + length]))
        pos += 2 + length
    return out


def jpeg_tables(Image, quality: int) -> tuple:
    """(DQT segments, DHT segments, {table: natural-order quantizers}, {(class,
    id): {value: (length, code)}}) of a PIL baseline JPEG at `quality`:
    libjpeg's scaled Annex K quantizers and its standard Huffman tables."""
    data = pil_jpeg_image(Image, Image.fromarray(np.zeros((8, 8, 3), np.uint8)),
                          quality=quality, subsampling=0)
    dqt, dht, quant, codes = b"", b"", {}, {}
    for m, seg in jpeg_segments(data):
        body = seg[4:]
        if m == 0xDB:
            dqt += seg
            p = 0
            while p < len(body):
                t = body[p] & 15
                q = np.zeros(64, np.int64)
                q[ZIGZAG] = list(body[p + 1:p + 65])
                quant[t] = q.reshape(8, 8)
                p += 65
        elif m == 0xC4:
            dht += seg
            p = 0
            while p < len(body):
                counts = body[p + 1:p + 17]
                vals = body[p + 17:p + 17 + sum(counts)]
                code, k, table = 0, 0, {}
                for length in range(1, 17):
                    for _ in range(counts[length - 1]):
                        table[vals[k]] = (length, code)
                        code += 1
                        k += 1
                    code <<= 1
                codes[(body[p] >> 4, body[p] & 15)] = table
                p += 17 + sum(counts)
    return dqt, dht, quant, codes


def _ycc(rgb: np.ndarray) -> np.ndarray:
    r, g, b = (rgb[:, :, i].astype(np.float64) for i in range(3))
    return np.stack([0.299 * r + 0.587 * g + 0.114 * b,
                     -0.168736 * r - 0.331264 * g + 0.5 * b + 128,
                     0.5 * r - 0.418688 * g - 0.081312 * b + 128], -1)


def jpeg_encode(pixels: np.ndarray, sampling: list, tables: tuple, abbreviated: bool = False,
                ids: tuple = (1, 2, 3), transform: bool = True) -> bytes:
    """A baseline JPEG of (H, W) grey or (H, W, 3) RGB uint8 `pixels`, each
    component at its (h, v) of `sampling` (box-averaged from the YCbCr
    planes), quantized and Huffman-coded with `tables` (`jpeg_tables`):
    component 0 with table 0, the others with table 1; `transform` False
    codes RGB samples as they are. `abbreviated` leaves out JFIF, DQT and
    DHT, as a JPEG-in-TIFF strip does."""
    dqt, dht, quant, codes = tables
    if pixels.ndim == 2:
        pixels = pixels[:, :, None]
    planes = _ycc(pixels) if pixels.shape[2] == 3 and transform else pixels.astype(np.float64)
    h, w, n = planes.shape
    sampling = list(sampling)[:n]
    hmax, vmax = max(a for a, _ in sampling), max(b for _, b in sampling)
    mcux, mcuy = -(-w // (8 * hmax)), -(-h // (8 * vmax))
    coefs = []
    for c, (sh, sv) in enumerate(sampling):
        fh, fv = hmax // sh, vmax // sv
        full = np.pad(planes[:, :, c], ((0, -h % fv), (0, -w % fh)), mode="edge")
        small = full.reshape(full.shape[0] // fv, fv, full.shape[1] // fh, fh).mean((1, 3))
        bh, bw = mcuy * sv, mcux * sh
        grid = np.pad(small, ((0, max(0, bh * 8 - small.shape[0])),
                              (0, max(0, bw * 8 - small.shape[1]))), mode="edge")[:bh * 8, :bw * 8]
        blocks = grid.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3) - 128
        f = _DCT @ blocks @ _DCT.T
        q = np.round(f / quant[min(c, 1)]).astype(np.int64)
        coefs.append(q.reshape(bh, bw, 64)[:, :, ZIGZAG])
    # each table's codes, and each value's magnitude bits, as strings of 0/1
    strs = {t: {v: format(code, f"0{length}b") for v, (length, code) in table.items()}
            for t, table in codes.items()}

    def magnitude(v: int) -> tuple:
        size = abs(v).bit_length()
        return size, format(v if v >= 0 else v + (1 << size) - 1, f"0{size}b") if size else ""

    bits, last = [], [0] * n
    for my in range(mcuy):
        for mx in range(mcux):
            for c, (sh, sv) in enumerate(sampling):
                dc, ac = strs[(0, min(c, 1))], strs[(1, min(c, 1))]
                for v in range(sv):
                    for u in range(sh):
                        z = coefs[c][my * sv + v, mx * sh + u].tolist()
                        size, extra = magnitude(z[0] - last[c])
                        last[c] = z[0]
                        bits += (dc[size], extra)
                        prev = 0
                        for k in np.flatnonzero(z[1:]).tolist():
                            run = k - prev
                            while run > 15:
                                bits.append(ac[0xF0])
                                run -= 16
                            size, extra = magnitude(z[k + 1])
                            bits += (ac[run << 4 | size], extra)
                            prev = k + 1
                        if prev < 63:
                            bits.append(ac[0x00])
    stream = "".join(bits)
    stream += "1" * (-len(stream) % 8)
    scan = int(stream, 2).to_bytes(len(stream) // 8, "big") if stream else b""
    scan = scan.replace(b"\xff", b"\xff\x00")
    sof = struct.pack(">BHHB", 8, h, w, n) + b"".join(
        bytes([ids[c], sh << 4 | sv, min(c, 1)]) for c, (sh, sv) in enumerate(sampling))
    sos = bytes([n]) + b"".join(bytes([ids[c], min(c, 1) * 17]) for c in range(n)) + b"\x00\x3f\x00"
    head = b"\xff\xd8" if abbreviated else (
        b"\xff\xd8\xff\xe0\x00\x10JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00" + dqt + dht)
    return (head + b"\xff\xc0" + struct.pack(">H", len(sof) + 2) + sof
            + b"\xff\xda" + struct.pack(">H", len(sos) + 2) + sos + scan + b"\xff\xd9")


def jpeg_lossless(pixels: np.ndarray, predictor: int, tables: tuple, point_transform: int = 0,
                  jfif: bool = False, restart_rows: int = 0, interleaved: bool = True) -> bytes:
    """A lossless JPEG (SOF3, T.81 Annex H) of (H, W) or (H, W, C) uint8
    `pixels` at 8 bits, every component at 1x1: samples shifted right by
    `point_transform`, predicted by selection value `predictor` (1-7; the
    first row from the left neighbour and its first sample from
    2^(7 - Pt), the first column from above, as after each restart every
    `restart_rows` rows), the differences Huffman-coded with `tables`' DC
    table 0; one scan of all components or one scan each."""
    dqt, dht, quant, codes = tables
    if pixels.ndim == 2:
        pixels = pixels[:, :, None]
    h, w, n = pixels.shape
    x = pixels.astype(np.int64) >> point_transform
    strs = {v: format(code, f"0{length}b") for v, (length, code) in codes[(0, 0)].items()}

    def pred(c: int, yy: int, xx: int, first_row: bool) -> int:
        if first_row:
            return (1 << (7 - point_transform)) if xx == 0 else int(x[yy, xx - 1, c])
        if xx == 0:
            return int(x[yy - 1, 0, c])
        ra, rb, rc = int(x[yy, xx - 1, c]), int(x[yy - 1, xx, c]), int(x[yy - 1, xx - 1, c])
        return {1: ra, 2: rb, 3: rc, 4: ra + rb - rc, 5: ra + ((rb - rc) >> 1),
                6: rb + ((ra - rc) >> 1), 7: (ra + rb) >> 1}[predictor]

    def scan(comps: list) -> bytes:
        segments, bits = [], []
        for yy in range(h):
            if restart_rows and yy and yy % restart_rows == 0:
                segments.append(bits)
                bits = []
            first_row = yy == 0 or (restart_rows and yy % restart_rows == 0)
            for xx in range(w):
                for c in comps:
                    d = (int(x[yy, xx, c]) - pred(c, yy, xx, first_row)) & 0xFFFF
                    d = d - 0x10000 if d > 0x8000 else d
                    size = abs(d).bit_length()
                    bits.append(strs[size])
                    if size:
                        bits.append(format(d if d >= 0 else d + (1 << size) - 1, f"0{size}b"))
        segments.append(bits)
        out = b""
        for k, seg in enumerate(segments):
            stream = "".join(seg)
            stream += "1" * (-len(stream) % 8)
            data = int(stream, 2).to_bytes(len(stream) // 8, "big") if stream else b""
            out += (bytes([0xFF, 0xD0 + (k - 1) % 8]) if k else b"") + data.replace(b"\xff",
                                                                                    b"\xff\x00")
        return out

    sof = struct.pack(">BHHB", 8, h, w, n) + b"".join(bytes([c + 1, 0x11, 0]) for c in range(n))
    out = b"\xff\xd8" + (b"\xff\xe0\x00\x10JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"
                         if jfif else b"") + dht
    out += b"\xff\xc3" + struct.pack(">H", len(sof) + 2) + sof
    if restart_rows:
        out += b"\xff\xdd" + struct.pack(">HH", 4, restart_rows * w)
    for comps in ([list(range(n))] if interleaved else [[c] for c in range(n)]):
        sos = bytes([len(comps)]) + b"".join(bytes([c + 1, 0x00]) for c in comps)
        sos += bytes([predictor, 0, point_transform])
        out += b"\xff\xda" + struct.pack(">H", len(sos) + 2) + sos + scan(comps)
    return out + b"\xff\xd9"


def ycbcr_units(pixels: np.ndarray, sampling: tuple) -> bytes:
    """The YCbCr data units of TIFF 6.0 section 21 of (H, W, 3) RGB uint8:
    for each block of h x v pixels (the image edge-padded to whole blocks),
    its h * v luma samples row by row, then its mean Cb and Cr."""
    sh, sv = sampling
    ycc = np.clip(np.round(_ycc(pixels)), 0, 255)
    h, w, _ = ycc.shape
    p = np.pad(ycc, ((0, -h % sv), (0, -w % sh), (0, 0)), mode="edge")
    b = p.reshape(p.shape[0] // sv, sv, p.shape[1] // sh, sh, 3).transpose(0, 2, 1, 3, 4)
    luma = b[..., 0].reshape(b.shape[0], b.shape[1], -1)
    chroma = np.round(b[..., 1:].mean((2, 3)))
    return np.concatenate([luma, chroma], -1).astype(np.uint8).tobytes()


def ycbcr_tiff(pixels: np.ndarray, sampling: tuple, compression: int, rows_per_strip: int,
               **kw) -> bytes:
    """A YCbCr TIFF (photometric 6) of `ycbcr_units` strips, compressed
    with LZW, Deflate, PackBits or LZMA, YCbCrSubSampling `sampling`."""
    enc = {5: lzw, 8: zlib.compress, 32946: zlib.compress, 32773: packbits,
           34925: lzma.compress}[compression]
    over = {530: (3, list(sampling)), **kw.pop("overrides", {})}
    return tiff(pixels, photometric=6, compression=compression, rows_per_strip=rows_per_strip,
                encode=lambda block: enc(ycbcr_units(block, sampling)), overrides=over, **kw)


def ojpeg_tiff(pixels: np.ndarray, sampling: list, tables: tuple, **kw) -> bytes:
    """An old-style JPEG TIFF (compression 6): one strip holding a whole
    JFIF stream of `jpeg_encode`, which JPEGInterchangeFormat (513) and its
    length (514) point at too, YCbCrSubSampling the luma's."""
    stream = jpeg_encode(pixels, sampling, tables)
    over = {513: (4, [8]), 514: (4, [len(stream)]), 530: (3, list(sampling[0])),
            **kw.pop("overrides", {})}
    return tiff(pixels, photometric=6, compression=6, encode=lambda block: stream,
                overrides=over, **kw)


def jpeg_tiff(pixels: np.ndarray, photometric: int, sampling: list, tables: tuple,
              **kw) -> bytes:
    """A JPEG-in-TIFF (compression 7) of (H, W, S) uint8 `pixels`: each
    strip or tile its own abbreviated stream (YCbCr for photometric 6, the
    samples as they are otherwise), the tables in JPEGTables (347) and,
    for YCbCr, the luma sampling in YCbCrSubSampling (530)."""
    dqt, dht = tables[:2]
    s = pixels.shape[2]

    def encode(block: np.ndarray) -> bytes:
        if photometric == 6:
            return jpeg_encode(block, sampling, tables, abbreviated=True)
        return jpeg_encode(block, [(1, 1)] * s, tables, abbreviated=True, transform=False)

    over = {347: (7, b"\xff\xd8" + dqt + dht + b"\xff\xd9")}
    if photometric == 6:
        over[530] = (3, list(sampling[0]))
    over.update(kw.pop("overrides", {}))
    return tiff(pixels, photometric=photometric, compression=7, encode=encode, overrides=over,
                **kw)


# ------------------------------------- TIFF codecs and samples, JPEG sampling
TIFF_MORE_SIZES = [(1, 1), (7, 9), (17, 33), (37, 45)]
# CCITT codings as PIL (libtiff) writes them: (name, PIL compression, tags)
CCITT_CODINGS = [("RLE", "tiff_ccitt", {}), ("T.4 1-D", "group3", {}),
                 ("T.4 filled 1-D", "group3", {292: 4}), ("T.4 2-D", "group3", {292: 1}),
                 ("T.4 filled 2-D", "group3", {292: 5}), ("T.6", "group4", {})]
# YCbCr JPEG-in-TIFF: name -> the luma's (h, v), chroma at (1, 1)
YCBCR_SUBSAMPLINGS = {"4:4:4": (1, 1), "4:2:2": (2, 1), "4:2:0": (2, 2), "4:4:0": (1, 2),
                      "4:1:1": (4, 1)}
# the groups of `tiff_more_matrix`, each label's prefix after "tiff "
TIFF_MORE_GROUPS = ([f"CCITT {name} " for name, *_ in CCITT_CODINGS]
                    + ["JPEG PIL ", "JPEG RGB ", "JPEG grey "]
                    + [f"JPEG YCbCr {k} " for k in YCBCR_SUBSAMPLINGS]
                    + ["YCbCr ", "old-style JPEG ", "CIELAB ", "LZMA ", "BigTIFF ", "float ",
                       "signed ", "unsigned 32-bit ", "fill order 2 "])
# YCbCr subsamplings TIFFRGBAImage decodes (4x4 only at an even count of blocks across)
RGBA_SUBSAMPLINGS = [(1, 1), (2, 1), (2, 2), (4, 1), (4, 2), (1, 2), (4, 4)]
# JPEG sampling layouts libjpeg upsamples besides 4:4:4, 4:2:2 and 4:2:0: (h, v) per component
JPEG_SAMPLINGS = {"4:4:0": [(1, 2), (1, 1), (1, 1)], "4:1:1": [(4, 1), (1, 1), (1, 1)],
                  "4:1:0": [(4, 2), (1, 1), (1, 1)], "3x1": [(3, 1), (1, 1), (1, 1)],
                  "1x3": [(1, 3), (1, 1), (1, 1)], "Cb h1v2 Cr h2v2": [(2, 2), (2, 1), (1, 1)],
                  "chroma 1x2 of 2x2": [(2, 2), (1, 2), (1, 2)],
                  "luma below chroma": [(1, 1), (2, 2), (2, 2)],
                  "4:2:0": [(2, 2), (1, 1), (1, 1)], "4:2:2": [(2, 1), (1, 1), (1, 1)]}
JPEG_SAMPLING_SIZES = [(1, 1), (7, 9), (17, 33), (37, 45), (64, 80)]


def bilevel(rs, h: int, w: int, kind: str) -> np.ndarray:
    """(H, W) bool, True white: noise, sparse or dense blocks, or long runs."""
    if kind == "noise":
        return rs.rand(h, w) > 0.5
    if kind == "long runs":
        edges = np.sort(rs.randint(0, w + 1, (h, 6)), axis=1)
        return (np.searchsorted(edges[0], np.arange(w), side="right") % 2 == 0)[None].repeat(
            h, 0) ^ (rs.rand(h, 1) > 0.7)
    dense = kind == "dense blocks"
    cells = rs.rand(-(-h // 3) + 1, -(-w // 7) + 1) > (0.2 if dense else 0.8)
    return ~np.repeat(np.repeat(cells, 3, 0), 7, 1)[:h, :w]


def pil_tiff(Image, im, **save) -> bytes:
    import io

    buf = io.BytesIO()
    im.save(buf, "TIFF", **save)
    return buf.getvalue()


def _special_floats(rs, h: int, w: int) -> np.ndarray:
    v = (rs.randn(h, w, 1) * 90 + 110).astype(np.float32)
    flat = v.reshape(-1)
    picks = rs.randint(0, flat.size, max(1, flat.size // 8))
    flat[picks] = rs.choice(np.array([-1.5, -0.0, 0.5, 254.99, 255.0, 1e6, np.inf, -np.inf],
                                     np.float32), picks.size)
    return v


def tiff_more_matrix(Image, sizes=TIFF_MORE_SIZES) -> list:
    """TIFFs of the codecs, containers and samples beyond `tiff_matrix`:
    CCITT in every coding PIL writes (each with fill order 2, several
    strips and min-is-white), bilevel noise, blocks and long runs up to 3000
    pixels wide; JPEG-in-TIFF by PIL (L, RGB, CMYK, strips) and by
    `jpeg_tiff` (YCbCr at each YCBCR_SUBSAMPLINGS, RGB and grey, in strips,
    tiles, MM order, planar, fill order 2 and BigTIFF); YCbCr data units
    and old-style JPEG at each RGBA_SUBSAMPLINGS (PIL reads both through
    libtiff's TIFFRGBAImage), with ReferenceBlackWhite and
    YCbCrCoefficients; CIELAB (every byte value of L, a and b); LZMA;
    BigTIFF;
    float, signed and unsigned 32-bit samples with predictors 1-3 in both
    byte orders; fill order 2 at 1-16 bits. Labels start "tiff <group>"
    with the groups of TIFF_MORE_GROUPS."""
    rs = np.random.RandomState(16)
    tables = jpeg_tables(Image, 80)
    out = []
    for h, w in list(sizes) + [(40, 1750), (3, 3000)]:
        for pattern in ("noise", "sparse blocks", "dense blocks", "long runs"):
            if pattern == "long runs" and w < 1000:
                continue
            im = Image.fromarray((bilevel(rs, h, w, pattern) * 255).astype(np.uint8)).convert("1")
            for name, comp, info in CCITT_CODINGS:
                out.append((f"tiff CCITT {name} {pattern} {h}x{w}",
                            pil_tiff(Image, im, compression=comp, tiffinfo=info)))
    im = Image.fromarray((bilevel(rs, 23, 61, "sparse blocks") * 255).astype(np.uint8)).convert("1")
    for name, comp, info in CCITT_CODINGS:
        out.append((f"tiff CCITT {name} fill order 2 23x61",
                    pil_tiff(Image, im, compression=comp, tiffinfo={**info, 266: 2})))
        out.append((f"tiff CCITT {name} strips of 5 23x61",
                    pil_tiff(Image, im, compression=comp, tiffinfo={**info, 278: 5})))
        out.append((f"tiff CCITT {name} min-is-white 23x61",
                    patch_tag(pil_tiff(Image, im, compression=comp, tiffinfo=info), 262, 0)))
    for h, w in sizes:
        arr = smooth_field(rs, h, w, 3)
        for mode in ("L", "RGB", "CMYK"):
            for info in ({}, {278: 8}):
                out.append((f"tiff JPEG PIL {mode} rows {info.get(278, h)} {h}x{w}",
                            pil_tiff(Image, Image.fromarray(arr).convert(mode), compression="jpeg",
                                     quality=75, tiffinfo=info)))
        for name, sub in YCBCR_SUBSAMPLINGS.items():
            for store, kw in (("one strip", {}), ("strips of 16", dict(rows_per_strip=16)),
                              ("tiles 16x32", dict(tile=(16, 32))),
                              ("MM strips of 16", dict(rows_per_strip=16, order="MM"))):
                out.append((f"tiff JPEG YCbCr {name} {store} {h}x{w}",
                            jpeg_tiff(arr, 6, [sub, (1, 1), (1, 1)], tables, **kw)))
        for store, kw in (("tiles 16x16", dict(tile=(16, 16))), ("planar", dict(planar=2)),
                          ("fill order 2", dict(fill_order=2)),
                          ("BigTIFF strips of 8", dict(big=True, rows_per_strip=8))):
            out.append((f"tiff JPEG RGB {store} {h}x{w}",
                        jpeg_tiff(arr, 2, [(1, 1)] * 3, tables, **kw)))
        out.append((f"tiff JPEG grey tiles 16x16 {h}x{w}",
                    jpeg_tiff(arr[:, :, :1], 1, [(1, 1)], tables, tile=(16, 16))))
        for sub in RGBA_SUBSAMPLINGS:
            if sub == (4, 4) and -(-w // 4) % 2:
                continue  # libtiff reads such strips short: PIL's pixels are undefined
            name = f"{sub[0]}x{sub[1]}"
            for comp, rows in ((5, 8), (34925, 4)):
                out.append((f"tiff YCbCr {name} compression {comp} strips of {rows} {h}x{w}",
                            ycbcr_tiff(arr, sub, comp, rows)))
            if sub != (4, 4):  # 18 blocks an MCU: libjpeg takes 10 at most
                out.append((f"tiff old-style JPEG {name} {h}x{w}",
                            ojpeg_tiff(arr, [sub, (1, 1), (1, 1)], tables)))
        out.append((f"tiff YCbCr ReferenceBlackWhite 16-235 {h}x{w}",
                    ycbcr_tiff(arr, (2, 2), 8, 8, overrides={532: (5, [
                        (16, 1), (235, 1), (128, 1), (240, 1), (128, 1), (240, 1)])})))
        lab = rs.randint(0, 256, (h, w, 3)).astype(np.uint8)
        for comp, kw in ((1, {}), (5, dict(predictor=2, rows_per_strip=4)),
                         (8, dict(tile=(16, 16))), (34925, dict(order="MM"))):
            out.append((f"tiff CIELAB compression {comp} {h}x{w}",
                        tiff(lab, photometric=8, compression=comp, **kw)))
        out.append((f"tiff CIELAB planar {h}x{w}",
                    tiff(lab, photometric=8, planar=2, compression=5)))
        out.append((f"tiff old-style JPEG YCbCrCoefficients {h}x{w}",
                    ojpeg_tiff(arr, [(2, 1), (1, 1), (1, 1)], tables, overrides={529: (5, [
                        (2126, 10000), (7152, 10000), (722, 10000)])})))
        for mode in ("1", "L", "RGB", "CMYK"):
            im = Image.fromarray(arr).convert(mode)
            out.append((f"tiff LZMA PIL {mode} {h}x{w}", pil_tiff(Image, im, compression="lzma")))
            out.append((f"tiff BigTIFF PIL {mode} {h}x{w}", pil_tiff(Image, im, big_tiff=True)))
        grey16 = Image.fromarray(rs.randint(0, 400, (h, w)).astype(np.uint16))
        out.append((f"tiff LZMA PIL I;16 {h}x{w}", pil_tiff(Image, grey16, compression="lzma")))
        for order in ("II", "MM"):
            out.append((f"tiff LZMA predictor 2 RGB {order} {h}x{w}",
                        tiff(arr, photometric=2, compression=34925, predictor=2, order=order,
                             rows_per_strip=5)))
        for comp, store in ((1, dict(rows_per_strip=4)), (5, dict(tile=(16, 16))), (8, {}),
                            (34925, dict(rows_per_strip=4))):
            out.append((f"tiff BigTIFF compression {comp} {h}x{w}",
                        tiff(arr, photometric=2, compression=comp, big=True, **store)))
        f = _special_floats(rs, h, w)
        for comp in (None, "tiff_lzw", "tiff_adobe_deflate", "lzma"):
            for pred in ((1, 2, 3) if comp else (1,)):
                out.append((f"tiff float PIL {comp} predictor {pred} {h}x{w}",
                            pil_tiff(Image, Image.fromarray(f[:, :, 0]), compression=comp,
                                     tiffinfo={317: pred} if comp else {})))
        for comp in (1, 5, 8, 34925):
            for pred in ((1, 2, 3) if comp != 1 else (1,)):
                out.append((f"tiff float MM compression {comp} predictor {pred} {h}x{w}",
                            tiff(f, photometric=0 if pred == 3 else 1, bits=32, sample_format=3,
                                 order="MM", compression=comp, predictor=pred, rows_per_strip=6)))
        out.append((f"tiff float tiles predictor 3 {h}x{w}",
                    tiff(f, photometric=1, bits=32, sample_format=3, compression=8, predictor=3,
                         tile=(16, 16))))
        i32 = rs.randint(-400, 700, (h, w)).astype(np.int32)
        for comp in (None, "tiff_adobe_deflate"):
            out.append((f"tiff signed PIL I {comp} {h}x{w}",
                        pil_tiff(Image, Image.fromarray(i32, "I"), compression=comp)))
        for bits, dt, lo, hi in ((8, np.int8, -128, 128), (16, np.int16, -600, 600),
                                 (32, np.int32, -70000, 70000)):
            v = rs.randint(lo, hi, (h, w, 1)).astype(dt)
            for order in ("II", "MM"):
                for comp in (1, 5, 34925):
                    for pred in ((1, 2) if comp != 1 else (1,)):
                        out.append((f"tiff signed {bits}-bit {order} compression {comp} "
                                    f"predictor {pred} {h}x{w}",
                                    tiff(v, photometric=1, bits=bits, sample_format=2, order=order,
                                         compression=comp, predictor=pred, rows_per_strip=5)))
        u32 = rs.randint(0, 1 << 32, (h, w, 1), dtype=np.uint64).astype(np.uint32)
        u32[::3] %= 400
        for comp, pred in ((1, 1), (5, 2), (34925, 1)):
            out.append((f"tiff unsigned 32-bit compression {comp} predictor {pred} {h}x{w}",
                        tiff(u32, photometric=1, bits=32, compression=comp, predictor=pred)))
    for h, w in ((7, 9), (17, 33)):
        for bits in (1, 2, 4, 8):
            g = rs.randint(0, 1 << bits, (h, w, 1)).astype(np.uint8)
            for photo in (0, 1, 3):
                cmap = rs.randint(0, 65536, (1 << bits, 3)) if photo == 3 else None
                for comp in (1, 5, 8, 32773, 34925):
                    if comp == 1 and (photo, bits) in ((3, 1), (3, 2), (3, 4), (0, 8)):
                        continue  # PIL has no raw mode for these
                    out.append((f"tiff fill order 2 {bits}-bit photometric {photo} compression "
                                f"{comp} {h}x{w}",
                                tiff(g, photometric=photo, bits=bits, compression=comp,
                                     colormap=cmap, fill_order=2, rows_per_strip=5,
                                     order="MM" if comp == 5 else "II")))
        for comp in (1, 5, 34925):
            out.append((f"tiff fill order 2 RGB compression {comp} {h}x{w}",
                        tiff(rs.randint(0, 256, (h, w, 3)).astype(np.uint8), photometric=2,
                             compression=comp, fill_order=2)))
            out.append((f"tiff fill order 2 16-bit compression {comp} {h}x{w}",
                        tiff(rs.randint(0, 300, (h, w, 1)).astype(np.uint16), photometric=1,
                             bits=16, compression=comp, fill_order=2)))
    return out


def jpeg_sampling_matrix(Image, arith=None, sizes=JPEG_SAMPLING_SIZES) -> list:
    """Baseline JPEGs of `jpeg_encode` at each JPEG_SAMPLINGS layout and
    size, q80 and q95; with `arith` (tests/_torch_jpeg_arith.py) 4:4:0 and
    4:1:1 re-coded arithmetically, sequential and progressive. Labels
    "jpeg sampling <layout> ..."."""
    rs = np.random.RandomState(17)
    out = []
    for q in (80, 95):
        tables = jpeg_tables(Image, q)
        for name, sampling in JPEG_SAMPLINGS.items():
            for h, w in sizes:
                data = jpeg_encode(smooth_field(rs, h, w, 3), sampling, tables)
                out.append((f"jpeg sampling {name} q{q} {h}x{w}", data))
                if arith is not None and q == 80 and name in ("4:4:0", "4:1:1"):
                    for prog in (False, True):
                        kind = "progressive" if prog else "sequential"
                        out.append((f"jpeg sampling {name} arithmetic {kind} {h}x{w}",
                                    arith.to_arithmetic(data, progressive=prog)))
    return out


def jpeg_lossless_matrix(Image) -> list:
    """Lossless JPEGs of `jpeg_lossless`, grey and RGB, at predictors 1-7,
    point transforms 0 and 2 and sizes 1x1 to 17x33 (a smooth field with
    every third row's even samples drawn at random, so that differences
    reach 8 bits); and restarts every 2 rows, one scan a component. Labels
    "jpeg lossless predictor <n> ..."."""
    rs = np.random.RandomState(19)
    tables = jpeg_tables(Image, 85)
    out = []
    for h, w in ((1, 1), (7, 9), (17, 33)):
        arr = smooth_field(rs, h, w, 3)
        arr[::3, ::2] = rs.randint(0, 256, arr[::3, ::2].shape)
        for p in range(1, 8):
            for pt in (0, 2):
                for name, px in (("grey", arr[:, :, 0]), ("RGB", arr)):
                    out.append((f"jpeg lossless predictor {p} Pt {pt} {name} {h}x{w}",
                                jpeg_lossless(px, p, tables, point_transform=pt)))
            out.append((f"jpeg lossless predictor {p} restarts every 2 rows {h}x{w}",
                        jpeg_lossless(arr, p, tables, restart_rows=2)))
            out.append((f"jpeg lossless predictor {p} a scan a component {h}x{w}",
                        jpeg_lossless(arr, p, tables, point_transform=1, interleaved=False)))
    return out


def once_refused(Image) -> dict:
    """{label: bytes} of the layouts `refused` named before the port read
    them, each under the same label, now a file PIL reads."""
    rs = np.random.RandomState(6)
    rgb = rs.randint(0, 256, (6, 5, 3)).astype(np.uint8)
    g4 = Image.fromarray((rgb[:, :, 0] > 127).astype(np.uint8) * 255).convert("1")
    return {
        "jpeg lossless (SOF3)": jpeg_lossless(smooth_field(rs, 24, 24, 3), 1,
                                              jpeg_tables(Image, 85)),
        "tiff JPEG (compression 7)": jpeg_tiff(smooth_field(rs, 24, 24, 3), 2, [(1, 1)] * 3,
                                               jpeg_tables(Image, 85)),
        "tiff CCITT Group 4 (compression 4)": patch_tag(pil_tiff(Image, g4, compression="group4"),
                                                        262, 0),
        "tiff floating-point samples": tiff((rgb[:, :, :1] * 1.7 - 20).astype(np.float32),
                                            photometric=1, bits=32, sample_format=3),
        "tiff fill order 2": tiff(rgb, photometric=2, overrides={266: (3, [2])}),
        "tiff BigTIFF": tiff(rgb, photometric=2, big=True),
        "tiff CIELAB (photometric 8)": tiff(rgb, photometric=8),
        "tiff old-style JPEG (compression 6)": ojpeg_tiff(smooth_field(rs, 24, 24, 3),
                                                          [(2, 2), (1, 1), (1, 1)],
                                                          jpeg_tables(Image, 85)),
    }


def more_kinds(Image) -> dict:
    """{name: (extension, bytes)}: one file of each kind this module's new
    matrices cover, for the FID loaders of both packages."""
    rs = np.random.RandomState(18)
    arr = smooth_field(rs, 21, 26, 3)
    bi = Image.fromarray((bilevel(rs, 21, 26, "sparse blocks") * 255).astype(np.uint8)).convert("1")
    tables = jpeg_tables(Image, 85)
    out = {f"CCITT {name}": ("tif", pil_tiff(Image, bi, compression=comp, tiffinfo=info))
           for name, comp, info in CCITT_CODINGS}
    out.update({
        "JPEG-in-TIFF RGB": ("tif", pil_tiff(Image, Image.fromarray(arr), compression="jpeg")),
        "JPEG-in-TIFF YCbCr 4:2:0": ("tiff", jpeg_tiff(arr, 6, [(2, 2), (1, 1), (1, 1)], tables,
                                                       rows_per_strip=16)),
        "LZMA": ("tif", pil_tiff(Image, Image.fromarray(arr), compression="lzma")),
        "BigTIFF": ("tif", pil_tiff(Image, Image.fromarray(arr), big_tiff=True)),
        "float": ("tif", tiff(_special_floats(rs, 21, 26), photometric=1, bits=32,
                              sample_format=3, compression=8, predictor=3)),
        "signed 16-bit": ("tif", tiff(rs.randint(-300, 300, (21, 26, 1)).astype(np.int16),
                                      photometric=1, bits=16, sample_format=2, order="MM",
                                      compression=5)),
        "signed 32-bit": ("tif", tiff(rs.randint(-300, 300, (21, 26, 1)).astype(np.int32),
                                      photometric=1, bits=32, sample_format=2)),
        "fill order 2": ("tif", tiff(arr, photometric=2, compression=5, fill_order=2)),
        "YCbCr 2x2 LZW": ("tif", ycbcr_tiff(arr, (2, 2), 5, 8)),
        "old-style JPEG": ("tif", ojpeg_tiff(arr, [(2, 2), (1, 1), (1, 1)], tables)),
        "CIELAB": ("tif", tiff(rs.randint(0, 256, (21, 26, 3)).astype(np.uint8), photometric=8,
                               compression=8)),
        "JPEG 4:4:0": ("jpg", jpeg_encode(arr, JPEG_SAMPLINGS["4:4:0"], tables)),
        "JPEG 4:1:1": ("jpg", jpeg_encode(arr, JPEG_SAMPLINGS["4:1:1"], tables)),
    })
    return out


# ------------------------------------------- files refused, and malformed ones
def _scans_cut(data: bytes, keep: int) -> bytes:
    """A progressive JPEG cut after its first `keep` scans, with EOI."""
    at, k = [], 0
    while True:
        k = data.find(b"\xff\xda", k + 1)
        if k < 0:
            break
        at.append(k)
    return data[:at[keep]] + b"\xff\xd9"


def _sof_patched(data: bytes, marker: int | None = None, precision: int | None = None) -> bytes:
    k = data.index(b"\xff\xc0")
    out = bytearray(data)
    if marker is not None:
        out[k + 1] = marker
    if precision is not None:
        out[k + 4] = precision
    return bytes(out)


def refused(Image) -> dict:
    """{label: bytes} of files in layouts the port does not read: each must
    raise NotImplementedError naming ROADMAP.md item 13i."""
    rs = np.random.RandomState(6)
    base = pil_jpeg(Image, rs, 24, 24, "4:2:0", quality=85)
    prog = pil_jpeg(Image, rs, 24, 24, "4:2:0", quality=85, progressive=True)
    rgb = rs.randint(0, 256, (6, 5, 3)).astype(np.uint8)
    return {
        "jpeg arithmetic-coded lossless (SOF11)": jpeg_lossless(rgb, 1, jpeg_tables(Image, 85)
                                                                ).replace(b"\xff\xc3", b"\xff\xcb"),
        "jpeg lossless asking for a colour conversion (JFIF; libjpeg-turbo refuses it)":
            jpeg_lossless(rgb, 1, jpeg_tables(Image, 85), jfif=True),
        "jpeg hierarchical (SOF5)": _sof_patched(base, marker=0xC5),
        "jpeg 12-bit samples": _sof_patched(base, precision=12),
        "jpeg progressive, low coefficients unrefined (libjpeg smooths)": _scans_cut(prog, 5),
        "jpeg non-integral sampling ratios": jpeg_encode(rgb, [(3, 1), (2, 1), (2, 1)],
                                                         jpeg_tables(Image, 85)),
        "tiff old-style JPEG with its tables in tags (no JPEGInterchangeFormat)": tiff(
            rgb, photometric=6, overrides={259: (3, [6])}),
        "tiff YCbCr 4x4 at an odd count of blocks across (libtiff reads it short)": ycbcr_tiff(
            rs.randint(0, 256, (8, 12, 3)).astype(np.uint8), (4, 4), 5, 8),
        "tiff Zstd (compression 50000)": tiff(rgb, photometric=2, overrides={259: (3, [50000])}),
        "tiff YCbCr (photometric 6)": tiff(rgb, photometric=6),
        "tiff big-endian BigTIFF (PIL cannot open it)": tiff(rgb, photometric=2, order="MM",
                                                             big=True),
        "bmp JPEG inside (compression 4)": bmp(rgb, 24)[:30] + b"\4\0\0\0" + bmp(rgb, 24)[34:],
        "bmp 16-bit bitfields PIL does not read": bmp(rs.randint(0, 1 << 16, (4, 5)), 16,
                                                     compression=3, masks=(0xF00, 0xF0, 0xF)),
        "netpbm PFM (Pf)": b"Pf\n2 1\n-1.0\n" + np.zeros(2, "<f4").tobytes(),
        "gif": b"GIF89a\x01\0\x01\0\0\0\0;",
    }


def broken(Image) -> dict:
    """{label: bytes} of malformed files: each must raise ValueError."""
    rs = np.random.RandomState(7)
    rgb = rs.randint(0, 256, (9, 7, 3)).astype(np.uint8)
    good_png = png(rgb, 2, 16, 1)
    prog = pil_jpeg(Image, rs, 24, 24, "4:2:0", quality=85, progressive=True)
    lzw_tiff = tiff(rgb, photometric=2, compression=5)
    bad_bits = bytearray(good_png)
    bad_bits[24] = 3  # IHDR bit depth 3
    bad_bits[29:33] = (zlib.crc32(bytes(bad_bits[12:29])) & 0xFFFFFFFF).to_bytes(4, "big")
    bad_scan = bytearray(prog)
    sos = prog.index(b"\xff\xda")
    bad_scan[sos + 2 + int.from_bytes(prog[sos + 2:sos + 4], "big") - 3] = 5  # Ss > Se
    return {
        "png truncated": good_png[:len(good_png) // 2] + good_png[-12:],
        "png CRC": good_png[:40] + bytes([good_png[40] ^ 1]) + good_png[41:],
        "png bit depth 3": bytes(bad_bits),
        "bmp truncated": bmp(rgb, 24)[:-40],
        "bmp header cut": bmp(rgb, 24)[:30],
        "bmp RLE8 cut": bmp(rs.randint(0, 4, (6, 8)), 8, palette=rs.randint(0, 256, (4, 3)),
                            compression=1)[:-20],
        "netpbm truncated": netpbm(rgb, "P6")[:-5],
        "netpbm plain token": b"P2\n2 1\n255\n1 2x\n",
        "netpbm maxval 0": b"P5\n1 1\n0\n\0",
        "netpbm header cut": b"P6\n3",
        "tiff IFD past the file": b"II*\0" + (10 ** 6).to_bytes(4, "little"),
        "tiff LZW cut": lzw_tiff[:40] + lzw_tiff[60:],
        "tiff no dimensions": tiff(rgb, photometric=2, overrides={256: (4, [])}),
        "tiff byte counts short": tiff(rgb, photometric=2, compression=5, rows_per_strip=3,
                                       overrides={279: (4, [1])}),
        "tiff CCITT T.6 cut": patch_tag(pil_tiff(Image, Image.fromarray(
            rs.randint(0, 2, (20, 30)).astype(np.uint8) * 255).convert("1"), compression="group4"),
            279, lambda n: n // 3),
        "tiff LZMA cut": patch_tag(tiff(rgb, photometric=2, compression=34925), 279,
                                   lambda n: n // 3),
        "tiff JPEG strip smaller than its tags say": tiff(
            rgb, photometric=2, compression=7, encode=lambda b: jpeg_encode(
                b[:4], [(1, 1)] * 3, jpeg_tables(Image, 85), transform=False)),
        "tiff BigTIFF header cut": tiff(rgb, photometric=2, big=True)[:12],
        "jpeg progressive cut": prog[:len(prog) // 2],
        "jpeg bad progression": bytes(bad_scan),
    }
