"""CIELAB to RGB as PIL's `convert("RGB")` gives it, without PIL or LittleCMS.

PIL converts an "LAB" image through LittleCMS (`Image.convert` builds an
`ImageCms` transform from its built-in D50 Lab profile to its sRGB one,
perceptual intent, no flags), and LittleCMS runs an 8-bit Lab transform
as an optimised pipeline (cmsopt.c OptimizeByResampling). `lab_to_rgb`
computes that pipeline's arithmetic:

  * the lookup table: 33 nodes on each axis (`_cmsReasonableGridpointsByColorspace`),
    node i at the 16-bit input floor(i * 65535 / 32 + 0.5); each node is
    the float pipeline (cmsPipelineEvalFloat: float32 between stages) of
    Lab (v4 encoding: L = x * 100, a and b = x * 255 - 128) to XYZ under
    D50 (cmsLab2XYZ), scaled by 1 / (1 + 32767 / 32768), the inverse of
    the sRGB profile's colorant matrix (its primaries and D65 white
    adapted to D50 by Bradford, cmsCreateRGBProfile), scaled back, and the
    inverse of the sRGB curve (parametric type 4, inverted analytically);
    times 65535 and saturated to a word (_cmsQuickSaturateWord);
  * each pixel: the 8-bit samples widened to 16 bits (x * 257) and
    interpolated in the table tetrahedrally, in 16.16 fixed point
    (cmsintrp.c TetrahedralInterp16), then narrowed to 8 bits
    ((v * 65281 + 2^23) >> 24).

PIL's "LAB" mode holds a and b as signed bytes, as TIFF's CIELAB does,
and flips their top bit for LittleCMS's unsigned encoding. Held against
PIL over all 2^24 inputs in the tests.
"""

from __future__ import annotations

import functools

import numpy as np

_N = 33  # lookup nodes on each axis
_D50 = (0.9642, 1.0, 0.8249)
_MAX_XYZ = 1.0 + 32767.0 / 32768.0  # MAX_ENCODEABLE_XYZ


def _inv3(a):
    """cmsmtrx.c _cmsMAT3inverse, term for term."""
    c0 = a[1][1] * a[2][2] - a[1][2] * a[2][1]
    c1 = -a[1][0] * a[2][2] + a[1][2] * a[2][0]
    c2 = a[1][0] * a[2][1] - a[1][1] * a[2][0]
    det = a[0][0] * c0 + a[0][1] * c1 + a[0][2] * c2
    return [[c0 / det, (a[0][2] * a[2][1] - a[0][1] * a[2][2]) / det,
             (a[0][1] * a[1][2] - a[0][2] * a[1][1]) / det],
            [c1 / det, (a[0][0] * a[2][2] - a[0][2] * a[2][0]) / det,
             (a[0][2] * a[1][0] - a[0][0] * a[1][2]) / det],
            [c2 / det, (a[0][1] * a[2][0] - a[0][0] * a[2][1]) / det,
             (a[0][0] * a[1][1] - a[0][1] * a[1][0]) / det]]


def _mul(a, b):
    return [[a[i][0] * b[0][j] + a[i][1] * b[1][j] + a[i][2] * b[2][j] for j in range(3)]
            for i in range(3)]


def _apply(a, v):
    return [a[i][0] * v[0] + a[i][1] * v[1] + a[i][2] * v[2] for i in range(3)]


def _srgb_to_xyz_d50():
    """cmsCreate_sRGBProfile's colorants: _cmsBuildRGB2XYZtransferMatrix of
    the Rec. 709 primaries under D65, adapted to D50 by Bradford."""
    xn, yn = 0.3127, 0.3290
    (xr, yr), (xg, yg), (xb, yb) = (0.64, 0.33), (0.30, 0.60), (0.15, 0.06)
    prim = [[xr, xg, xb], [yr, yg, yb], [1 - xr - yr, 1 - xg - yg, 1 - xb - yb]]
    coef = _apply(_inv3(prim), [xn / yn, 1.0, (1.0 - xn - yn) / yn])
    m = [[coef[0] * xr, coef[1] * xg, coef[2] * xb], [coef[0] * yr, coef[1] * yg, coef[2] * yb],
         [coef[0] * (1 - xr - yr), coef[1] * (1 - xg - yg), coef[2] * (1 - xb - yb)]]
    brad = [[0.8951, 0.2664, -0.1614], [-0.7502, 1.7135, 0.0367], [0.0389, -0.0685, 1.0296]]
    src = _apply(brad, [xn / yn, 1.0, (1 - xn - yn) / yn])
    dst = _apply(brad, list(_D50))
    cone = [[dst[0] / src[0], 0, 0], [0, dst[1] / src[1], 0], [0, 0, dst[2] / src[2]]]
    return _mul(_mul(_inv3(brad), _mul(cone, brad)), m)


def _f_inv(t: np.ndarray) -> np.ndarray:
    return np.where(t <= 24.0 / 116.0, (108.0 / 841.0) * (t - 16.0 / 116.0), t * t * t)


def _pipeline(x16: np.ndarray) -> np.ndarray:
    """The float pipeline at (N, 3) 16-bit Lab inputs: (N, 3) float32 RGB."""
    f32 = np.float32
    v = (x16.astype(np.float64) * (1.0 / 65535.0)).astype(f32).astype(np.float64)
    y = (v[:, 0] * 100.0 + 16.0) / 116.0
    x = y + 0.002 * (v[:, 1] * 255.0 - 128.0)
    z = y - 0.005 * (v[:, 2] * 255.0 - 128.0)
    xyz = (np.stack([_f_inv(x) * _D50[0], _f_inv(y) * _D50[1], _f_inv(z) * _D50[2]], -1)
           / _MAX_XYZ).astype(f32).astype(np.float64)
    inv = _inv3(_srgb_to_xyz_d50())
    lin = np.stack([sum(xyz[:, j] * (inv[i][j] * _MAX_XYZ) for j in range(3)) for i in range(3)],
                   -1).astype(f32).astype(np.float64)
    g, a, b, c, d = 2.4, 1.0 / 1.055, 0.055 / 1.055, 1.0 / 12.92, 0.04045
    with np.errstate(invalid="ignore"):
        out = np.where(lin >= (a * d + b) ** g,
                       (np.power(np.maximum(lin, 0.0), 1.0 / g) - b) / a, lin / c)
    return out.astype(f32)


def _saturate_word(v: np.ndarray) -> np.ndarray:
    """_cmsQuickSaturateWord(v * 65535): + 0.5, clamped, then the floor of
    the value rounded to 16 fraction bits (_cmsQuickFloorWord)."""
    d = v.astype(np.float64) * 65535.0 + 0.5
    fl = np.floor(np.round((d - 32767.0) * 65536.0) / 65536.0) + 32767
    return np.where(d <= 0, 0, np.where(d >= 65535.0, 65535, fl)).astype(np.int64)


@functools.cache
def _table() -> np.ndarray:
    """(33^3 * 3,) int64 nodes, axis 0 (L) slowest, channels innermost."""
    q = np.floor(np.arange(_N) * 65535.0 / (_N - 1) + 0.5).astype(np.int64)
    grid = np.stack(np.meshgrid(q, q, q, indexing="ij"), -1).reshape(-1, 3)
    return _saturate_word(_pipeline(grid)).reshape(-1)


def _tetrahedral(x: np.ndarray) -> np.ndarray:
    """cmsintrp.c TetrahedralInterp16 of (N, 3) 16-bit inputs: (N, 3)."""
    t = _table()
    f = [x[:, i] * (_N - 1) for i in range(3)]
    f = [a + (a + 0x7FFF) // 0xFFFF for a in f]  # _cmsToFixedDomain
    r = [a & 0xFFFF for a in f]
    step = [3 * _N * _N, 3 * _N, 3]  # opta[2], opta[1], opta[0]
    base = sum(step[i] * (f[i] >> 16) for i in range(3))
    one = [np.where(x[:, i] == 0xFFFF, 0, step[i]) for i in range(3)]
    rx, ry, rz = r
    # the six tetrahedra: the order of rx, ry, rz picks the path from the
    # cell's corner 0 to its far corner, one axis at a time
    paths = [((rx >= ry) & (ry >= rz), (0, 1, 2)),
             ((rx >= ry) & (ry < rz) & (rz >= rx), (2, 0, 1)),
             ((rx >= ry) & (ry < rz) & (rz < rx), (0, 2, 1)),
             ((rx < ry) & (rx >= rz), (1, 0, 2)),
             ((rx < ry) & (rx < rz) & (ry >= rz), (1, 2, 0)),
             ((rx < ry) & (rx < rz) & (ry < rz), (2, 1, 0))]
    out = np.zeros(x.shape, np.int64)
    for mask, order in paths:
        k = np.flatnonzero(mask)
        if not k.size:
            continue
        # the corners after one, two and three steps along `order`
        c1 = one[order[0]][k]
        c2 = c1 + one[order[1]][k]
        c3 = c2 + one[order[2]][k]
        for ch in range(3):
            b = base[k] + ch
            v0, v1, v2, v3 = t[b], t[b + c1], t[b + c2], t[b + c3]
            d = {order[0]: v1 - v0, order[1]: v2 - v1, order[2]: v3 - v2}
            rest = d[0] * rx[k] + d[1] * ry[k] + d[2] * rz[k] + 0x8001
            out[k, ch] = (v0 + ((rest + (rest >> 16)) >> 16)) & 0xFFFF
    return out


def lab_to_rgb(pixels: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 RGB of (H, W, 3) uint8 CIELAB as PIL's "LAB" mode
    holds it (L, then a and b as signed bytes), as PIL converts it."""
    h, w = pixels.shape[:2]
    lab = pixels.reshape(-1, 3).astype(np.int64) ^ np.array([0, 128, 128])
    v = _tetrahedral(lab * 257)
    return ((v * 65281 + 8388608) >> 24).astype(np.uint8).reshape(h, w, 3)
