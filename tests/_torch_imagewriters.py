"""Writers, from the formats' specifications, of image files that PIL
reads but does not write: PNG at any bit depth with Adam7 interlace; BMP
with OS/2 and v3-v5 headers, RLE4, RLE8 and bitfields; PBM, PGM and PPM in
plain and raw form at any maxval; TIFF in strips or tiles, planar or not,
either byte order, with PackBits, LZW (new and old bit order) or Deflate and
predictor 2.

The tests hold the port's readers against PIL on these files. This module
imports numpy and the standard library only (`chip_smoke.py` loads it by
path on the chip host), nothing of the port or of PIL.
"""

from __future__ import annotations

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
    dt = np.uint16 if bits == 16 else np.uint8
    a = block.astype(dt)
    out = a.copy()
    out[:, 1:] = a[:, 1:] - a[:, :-1]
    return out


def tiff(samples: np.ndarray, *, photometric: int, bits: int = 8, order: str = "II",
         compression: int = 1, predictor: int = 1, planar: int = 1, rows_per_strip: int | None = None,
         tile: tuple | None = None, extra: tuple = (), colormap: np.ndarray | None = None,
         orientation: int | None = None, old_lzw: bool = False, sample_format: int | None = None,
         overrides: dict | None = None) -> bytes:
    """A one-image TIFF of `samples` (H, W, S) (uint8, uint16 or 0/1 for
    bits 1) with the given tags. Strips of `rows_per_strip` rows (default:
    one strip), or tiles of `tile` (height, width); planar 2 stores each
    sample as its own planes. Compression 1, 5 (LZW), 8 / 32946 (Deflate)
    or 32773 (PackBits); predictor 2 differences samples along a row;
    `overrides` replaces tags after the data is written."""
    e = "<" if order == "II" else ">"
    h, w, s = samples.shape

    def pack(block: np.ndarray) -> bytes:
        """(rows, cols, samples) -> the stored bytes of a strip or tile."""
        if predictor == 2:
            block = predict(block, bits)
        if bits == 1:
            return np.packbits(block.reshape(block.shape[0], -1).astype(np.uint8), axis=1).tobytes()
        if bits == 16:
            return block.astype(e + "u2").tobytes()
        return block.astype(np.uint8).tobytes()

    def compress(raw: bytes) -> bytes:
        if compression == 1:
            return raw
        if compression == 5:
            return lzw(raw, old=old_lzw)
        if compression in (8, 32946):
            return zlib.compress(raw)
        if compression == 32773:
            return packbits(raw)
        raise ValueError(compression)

    planes = [samples[:, :, k:k + 1] for k in range(s)] if planar == 2 else [samples]
    chunks = []
    if tile is None:
        rps = rows_per_strip or h
        for plane in planes:
            for y in range(0, h, rps):
                chunks.append(compress(pack(plane[y:y + rps])))
    else:
        th, tw = tile
        for plane in planes:
            for y in range(0, h, th):
                for x in range(0, w, tw):
                    block = np.zeros((th, tw, plane.shape[2]), plane.dtype)
                    part = plane[y:y + th, x:x + tw]
                    block[:part.shape[0], :part.shape[1]] = part
                    chunks.append(compress(pack(block)))
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
    if tile is None:
        entries[278] = (4, [rows_per_strip or h])
        off_tag, cnt_tag = 273, 279
    else:
        entries[322] = (4, [tile[1]])
        entries[323] = (4, [tile[0]])
        off_tag, cnt_tag = 324, 325
    # layout: header, data chunks, then IFD and its out-of-line values
    out = bytearray((b"II*\0" if order == "II" else b"MM\0*") + struct.pack(e + "I", 0))
    offsets = []
    for c in chunks:
        offsets.append(len(out))
        out += c
        if len(out) % 2:
            out += b"\0"
    entries[off_tag] = (4, offsets)
    entries[cnt_tag] = (4, [len(c) for c in chunks])
    entries.update(overrides or {})  # (type, values) by tag, the data as written
    ifd_at = len(out)
    struct.pack_into(e + "I", out, 4, ifd_at)
    tags = sorted(entries)
    values_at = ifd_at + 2 + 12 * len(tags) + 4
    ifd, tail = bytearray(struct.pack(e + "H", len(tags))), bytearray()
    for tag in tags:
        typ, vals = entries[tag]
        fmt = e + ("H" if typ == 3 else "I") * len(vals)
        data = struct.pack(fmt, *vals)
        if len(data) <= 4:
            ifd += struct.pack(e + "HHI", tag, typ, len(vals)) + data + b"\0" * (4 - len(data))
        else:
            ifd += struct.pack(e + "HHII", tag, typ, len(vals), values_at + len(tail))
            tail += data
            if len(tail) % 2:
                tail += b"\0"
    ifd += struct.pack(e + "I", 0)
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
        "jpeg lossless (SOF3)": _sof_patched(base, marker=0xC3),
        "jpeg hierarchical (SOF5)": _sof_patched(base, marker=0xC5),
        "jpeg 12-bit samples": _sof_patched(base, precision=12),
        "jpeg progressive, low coefficients unrefined (libjpeg smooths)": _scans_cut(prog, 5),
        "tiff JPEG (compression 7)": tiff(rgb, photometric=2, overrides={259: (3, [7])}),
        "tiff CCITT Group 4 (compression 4)": tiff(rgb[:, :, :1] > 127, photometric=0, bits=1,
                                                   overrides={259: (3, [4])}),
        "tiff floating-point samples": tiff(rgb, photometric=2, sample_format=3),
        "tiff YCbCr (photometric 6)": tiff(rgb, photometric=6),
        "tiff fill order 2": tiff(rgb, photometric=2, overrides={266: (3, [2])}),
        "tiff BigTIFF": b"II+\0\x08\0\0\0" + bytes(16),
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
        "jpeg progressive cut": prog[:len(prog) // 2],
        "jpeg bad progression": bytes(bad_scan),
    }
