"""On-device ORB extraction — the accelerator path of the front-end.

The host-side extractor fans out over cameras with a thread pool (the
reference's OpenMP axis, Frame.cc:213); this module instead runs the WHOLE
extraction pipeline of frontend/orb.py as one jitted XLA program over a
batch of images: pyramid resize, FAST-9/16 via the same 65536-entry
circular-run LUT, raster-order 3x3 NMS, the per-cell ini/min threshold
retry, spatially distributed top-K selection, intensity-centroid
orientation, 7x7 Gaussian blur, and rotated-BRIEF — one device dispatch per
frame for all cameras together.

Semantics match frontend/orb.py (same pyramid geometry, thresholds, cell
retry, circular patch, SAME BRIEF pattern so descriptors are comparable
across backends) with ONE deliberate deviation: quadtree redistribution
(DistributeOctTree, ORBextractor.cc:571) is data-dependent recursion that
does not map to a static-shape program. It is replaced by an equivalent
spatial-uniformity policy: the best keypoint of every 35px cell is
prioritized, then the remaining budget fills by response — the same
"spread first, best response second" contract.

All outputs are fixed-size per level (the per-level budget) with a validity
mask; invalid slots carry zeros.
"""

from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp

from .orb import (
    _BRIEF,
    _CIRCLE,
    _PATCH_OFF,
    CELL_W,
    EDGE_THRESHOLD,
)

_CELL_BONUS = 1 << 20  # priority offset for per-cell winners (scores < 2^16)


def _level_sizes(H, W, n_levels, scale_factor):
    sizes = [(H, W)]
    for lv in range(1, n_levels):
        s = scale_factor ** lv
        sizes.append((max(int(round(H / s)), 8), max(int(round(W / s)), 8)))
    return sizes


def _budgets(n_features, n_levels, scale_factor):
    f = 1.0 / scale_factor
    n0 = n_features * (1 - f) / (1 - f ** n_levels)
    out, total = [], 0
    for lv in range(n_levels - 1):
        b = int(round(n0 * f ** lv))
        out.append(b)
        total += b
    out.append(max(n_features - total, 0))
    return out


def _resize_bilinear_jnp(img, h, w):
    H, W = img.shape
    ys = (jnp.arange(h) + 0.5) * H / h - 0.5
    xs = (jnp.arange(w) + 0.5) * W / w - 0.5
    y0 = jnp.clip(jnp.floor(ys).astype(jnp.int32), 0, H - 1)
    x0 = jnp.clip(jnp.floor(xs).astype(jnp.int32), 0, W - 1)
    y1 = jnp.clip(y0 + 1, 0, H - 1)
    x1 = jnp.clip(x0 + 1, 0, W - 1)
    fy = jnp.clip(ys - y0, 0, 1)[:, None]
    fx = jnp.clip(xs - x0, 0, 1)[None, :]
    I = img.astype(jnp.float32)
    out = (
        I[y0][:, x0] * (1 - fy) * (1 - fx)
        + I[y0][:, x1] * (1 - fy) * fx
        + I[y1][:, x0] * fy * (1 - fx)
        + I[y1][:, x1] * fy * fx
    )
    return jnp.clip(jnp.round(out), 0, 255).astype(jnp.uint8)


def _run9(m):
    """Branchless circular run-of-9 test over a 16-bit mask (int32 lanes).

    Equivalent to _ARC_LUT[m] (orb.py:51) but with shift-AND doubling
    instead of a 65536-entry gather: shifts and ANDs fuse into the
    elementwise program, a table lookup per pixel does not."""
    m32 = m | (m << 16)           # duplicate: circular runs become linear
    r = m32 & (m32 >> 1)          # run >= 2 starting at each bit
    r = r & (r >> 2)              # run >= 4
    r = r & (r >> 4)              # run >= 8
    r = r & (m32 >> 8)            # run >= 9
    return (r & 0xFFFF) != 0


def _fast_masks(img, threshold):
    """(corner mask, response) — frontend/orb.py fast_detect semantics."""
    ok, _, score = _fast_masks_pair(img, threshold, threshold)
    return ok, score


def _fast_masks_pair(img, ini_th, min_th):
    """One pass over the 16 circle offsets serving BOTH thresholds
    (ComputeKeyPointsOctTree runs an ini and a fallback min detect on every
    cell; sharing the diffs halves the dominant FAST cost on chip).

    Returns (ok_min, ok_ini, score) where score is the min-threshold
    response (sum of |d|-th over exceeding circle pixels), zero outside
    min-corners."""
    H, W = img.shape
    I = img.astype(jnp.int32)
    c = I[3:-3, 3:-3]
    zero = jnp.zeros(c.shape, jnp.int32)
    mb_min, md_min, mb_ini, md_ini, resp = zero, zero, zero, zero, zero
    for k, (dx, dy) in enumerate(_CIRCLE):
        p = I[3 + dy: H - 3 + dy, 3 + dx: W - 3 + dx]
        d = p - c
        mb_min = mb_min | (jnp.where(d > min_th, 1, 0) << k)
        md_min = md_min | (jnp.where(d < -min_th, 1, 0) << k)
        mb_ini = mb_ini | (jnp.where(d > ini_th, 1, 0) << k)
        md_ini = md_ini | (jnp.where(d < -ini_th, 1, 0) << k)
        a = jnp.abs(d)
        resp = resp + jnp.where(a > min_th, a - min_th, 0)
    corner_min = _run9(mb_min) | _run9(md_min)
    corner_ini = _run9(mb_ini) | _run9(md_ini)
    ok_min = jnp.zeros((H, W), bool).at[3:-3, 3:-3].set(corner_min)
    ok_ini = jnp.zeros((H, W), bool).at[3:-3, 3:-3].set(corner_ini)
    score = jnp.zeros((H, W), jnp.int32).at[3:-3, 3:-3].set(
        jnp.where(corner_min, resp, 0)
    )
    return ok_min, ok_ini, score


def _nms3_jnp(score):
    H, W = score.shape
    pad = jnp.full((H + 2, W + 2), -1, score.dtype).at[1:-1, 1:-1].set(score)
    center = pad[1:-1, 1:-1]
    keep = jnp.ones((H, W), bool)
    for dy, dx, strict in [(-1, -1, True), (-1, 0, True), (-1, 1, True),
                           (0, -1, True), (0, 1, False), (1, -1, False),
                           (1, 0, False), (1, 1, False)]:
        nb = pad[1 + dy: H + 1 + dy, 1 + dx: W + 1 + dx]
        keep = keep & ((center > nb) if strict else (center >= nb))
    return keep


def _cell_retry(cand_min, cand_ini, H, W):
    """Per-cell ini/min retry: keep ini corners; where a cell has none,
    admit the min-threshold corners (ComputeKeyPointsOctTree semantics)."""
    b = EDGE_THRESHOLD - 3
    hi, wi = H - 2 * b, W - 2 * b
    ncy = -(-hi // CELL_W)
    ncx = -(-wi // CELL_W)
    ini_in = jnp.zeros((ncy * CELL_W, ncx * CELL_W), bool)
    ini_in = ini_in.at[:hi, :wi].set(cand_ini[b: b + hi, b: b + wi])
    has_ini = ini_in.reshape(ncy, CELL_W, ncx, CELL_W).any(axis=(1, 3))
    has_full = jnp.repeat(
        jnp.repeat(has_ini, CELL_W, axis=0), CELL_W, axis=1
    )[:hi, :wi]
    has_pix = jnp.zeros((H, W), bool).at[b: b + hi, b: b + wi].set(has_full)
    inside = jnp.zeros((H, W), bool).at[b: b + hi, b: b + wi].set(True)
    return inside & (cand_ini | (cand_min & ~has_pix))


def _cell_best_mask(score, H, W):
    """Mark the best-scoring pixel of every 35px cell (spatial uniformity
    first — the quadtree's contract)."""
    b = EDGE_THRESHOLD - 3
    hi, wi = H - 2 * b, W - 2 * b
    ncy = -(-hi // CELL_W)
    ncx = -(-wi // CELL_W)
    s_in = jnp.zeros((ncy * CELL_W, ncx * CELL_W), score.dtype)
    s_in = s_in.at[:hi, :wi].set(score[b: b + hi, b: b + wi])
    cells = s_in.reshape(ncy, CELL_W, ncx, CELL_W)
    cmax = cells.max(axis=(1, 3), keepdims=True)
    best = (cells == cmax) & (cells > 0)
    best = best.reshape(ncy * CELL_W, ncx * CELL_W)[:hi, :wi]
    return jnp.zeros((H, W), bool).at[b: b + hi, b: b + wi].set(best)


def _gaussian_blur7_jnp(img, sigma=2.0):
    r = 3
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    k = jnp.asarray(k / k.sum(), jnp.float32)
    I = img.astype(jnp.float32)
    pad = jnp.pad(I, r, mode="reflect")
    tmp = jnp.zeros_like(pad)
    Wd = img.shape[1]
    tmp = tmp.at[:, r:-r].set(
        sum(k[i] * pad[:, i: i + Wd] for i in range(7))
    )
    Hd = img.shape[0]
    out = sum(k[i] * tmp[i: i + Hd, r:-r] for i in range(7))
    return jnp.clip(jnp.round(out), 0, 255).astype(jnp.float32)


# Window radius for per-keypoint patch extraction: covers the circular
# orientation patch (radius 15) and any rotated BRIEF offset
# (|coord| <= 14 -> rotated reach <= ceil(14*sqrt(2)) = 20).
_WIN_R = 20


def _moment_kernels():
    """Dense (41,41) weight images w_x/w_y over the window such that
    m10 = <window, w_x>, m01 = <window, w_y> reproduce the circular-patch
    intensity-centroid sums of orb.py exactly."""
    Wn = 2 * _WIN_R + 1
    wx = np.zeros((Wn, Wn), np.float32)
    wy = np.zeros((Wn, Wn), np.float32)
    for dy, dx in _PATCH_OFF:
        wx[_WIN_R + dy, _WIN_R + dx] += dx
        wy[_WIN_R + dy, _WIN_R + dx] += dy
    return wx, wy


_WX_MOM, _WY_MOM = _moment_kernels()


def _extract_level(img, brief, ini_th, min_th, budget):
    """One pyramid level -> (xy (B,2) f32 level-px, score, angle, desc
    (B,32) int32-as-u8, valid).

    Orientation and BRIEF avoid per-point gathers: a 41x41 window around
    each keypoint is extracted with one-hot row/col matmuls, then orientation is a dense dot with fixed moment
    kernels and BRIEF samples are one-hot dots inside the window. Border
    clamping matches the gather version bit-exactly because the window is
    built from clipped global indices.
    """
    H, W = img.shape
    ok_min, ok_ini, score = _fast_masks_pair(img, ini_th, min_th)
    nms = _nms3_jnp(jnp.where(ok_min, score, 0))
    cand_min = ok_min & nms
    cand_ini = ok_ini & cand_min
    cand = _cell_retry(cand_min, cand_ini, H, W)
    s = jnp.where(cand, score, 0)
    prio = s + jnp.where(_cell_best_mask(s, H, W), _CELL_BONUS, 0)
    vals, flat = jax.lax.top_k(prio.reshape(-1), budget)
    ys = flat // W
    xs = flat % W
    valid = vals > 0
    sc = s.reshape(-1)[flat]

    blur = _gaussian_blur7_jnp(img)
    R, Wn = _WIN_R, 2 * _WIN_R + 1
    off = jnp.arange(-R, R + 1)
    rows = jnp.clip(ys[:, None] + off[None, :], 0, H - 1)     # (K,Wn)
    cols = jnp.clip(xs[:, None] + off[None, :], 0, W - 1)     # (K,Wn)
    oh_y = jax.nn.one_hot(rows, H, dtype=jnp.float32)          # (K,Wn,H)
    oh_x = jax.nn.one_hot(cols, W, dtype=jnp.float32)          # (K,Wn,W)
    stack = jnp.stack([img.astype(jnp.float32), blur])         # (2,H,W)
    strip = jnp.einsum("kwh,chx->ckwx", oh_y, stack)           # (2,K,Wn,W)
    win = jnp.einsum("ckwx,kvx->ckwv", strip, oh_x)            # (2,K,Wn,Wn)
    win_raw, win_blur = win[0], win[1]

    # intensity-centroid orientation: dense dot with the moment kernels
    m10 = jnp.einsum("kwv,wv->k", win_raw, jnp.asarray(_WX_MOM))
    m01 = jnp.einsum("kwv,wv->k", win_raw, jnp.asarray(_WY_MOM))
    ang = jnp.arctan2(m01, m10)

    # rotated BRIEF on the blurred window
    ca, sa = jnp.cos(ang), jnp.sin(ang)
    bx1, by1, bx2, by2 = brief[:, 0], brief[:, 1], brief[:, 2], brief[:, 3]

    def samp(bx, by):
        rx = jnp.round(ca[:, None] * bx[None, :] - sa[:, None] * by[None, :])
        ry = jnp.round(sa[:, None] * bx[None, :] + ca[:, None] * by[None, :])
        oy = jax.nn.one_hot(ry.astype(jnp.int32) + R, Wn,
                            dtype=jnp.float32)                 # (K,256,Wn)
        ox = jax.nn.one_hot(rx.astype(jnp.int32) + R, Wn,
                            dtype=jnp.float32)
        t = jnp.einsum("kpw,kwv->kpv", oy, win_blur)
        return jnp.einsum("kpv,kpv->kp", t, ox)

    bits = (samp(bx1, by1) < samp(bx2, by2)).astype(jnp.int32)  # (K,256)
    pack_w = jnp.asarray([128, 64, 32, 16, 8, 4, 2, 1], jnp.int32)
    desc = jnp.einsum("kab,b->ka", bits.reshape(budget, 32, 8), pack_w)

    xy = jnp.stack([xs, ys], axis=1).astype(jnp.float32)
    return xy, sc, ang, desc, valid


def build_orb_device(H, W, n_features=1200, scale_factor=1.2, n_levels=8,
                  ini_th=20, min_th=7):
    """Compile-once extractor for images of a fixed size. Returns a jitted
    function (B,H,W) uint8 -> dict of per-keypoint arrays, K = n_features
    slots ordered by pyramid level."""
    sizes = _level_sizes(H, W, n_levels, scale_factor)
    budgets = _budgets(n_features, n_levels, scale_factor)
    brief = jnp.asarray(_BRIEF, jnp.int32)

    def one_image(img):
        outs = []
        for lv in range(n_levels):
            h, w = sizes[lv]
            lvl_img = img if lv == 0 else _resize_bilinear_jnp(img, h, w)
            xy, sc, ang, desc, valid = _extract_level(
                lvl_img, brief, ini_th, min_th, budgets[lv]
            )
            outs.append((
                xy * np.float32(scale_factor ** lv),
                jnp.full(budgets[lv], lv, jnp.int32),
                ang, desc, valid, sc,
            ))
        xy = jnp.concatenate([o[0] for o in outs])
        octv = jnp.concatenate([o[1] for o in outs])
        ang = jnp.concatenate([o[2] for o in outs])
        desc = jnp.concatenate([o[3] for o in outs])
        valid = jnp.concatenate([o[4] for o in outs])
        sc = jnp.concatenate([o[5] for o in outs])
        return {"xy": xy, "octave": octv, "angle": ang, "desc": desc,
                "valid": valid, "score": sc}

    return jax.jit(jax.vmap(one_image))


class ORBExtractorDevice:
    """Drop-in .extract() with the on-device pipeline; one compiled program
    per (H, W, n_features) combination (cached on the instance)."""

    def __init__(self, n_features=1200, scale_factor=1.2, n_levels=8,
                 ini_th=20, min_th=7):
        self.n_features = n_features
        self.scale_factor = scale_factor
        self.n_levels = n_levels
        self.ini_th = ini_th
        self.min_th = min_th
        self._fns = {}

    def set_num(self, n):
        self.n_features = n

    def _fn(self, H, W):
        key = (H, W, self.n_features)
        if key not in self._fns:
            self._fns[key] = build_orb_device(
                H, W, self.n_features, self.scale_factor, self.n_levels,
                self.ini_th, self.min_th,
            )
        return self._fns[key]

    def extract(self, image: np.ndarray):
        out = self.extract_batch(image[None])
        return tuple(o[0] for o in out)

    def extract_batch(self, images: np.ndarray):
        """(B,H,W) uint8 grayscale or (B,H,W,3) uint8 **BGR** (OpenCV
        channel order, matching the host backend orb.py) -> per-image lists
        (xy, octave, desc, angle), one device round-trip for the whole
        batch. RGB callers must reverse the channel axis first."""
        if images.ndim == 4:
            if images.shape[-1] != 3:
                raise ValueError(
                    f"4D input must be (B,H,W,3) BGR, got {images.shape}"
                )
            # ITU-R 601 luma on BGR, same conversion as the host backend
            images = np.clip(
                0.114 * images[..., 0] + 0.587 * images[..., 1]
                + 0.299 * images[..., 2], 0, 255
            ).astype(np.uint8)
        B, H, W = images.shape
        # one batched device->host fetch instead of one transfer per array
        out = jax.device_get(self._fn(H, W)(jnp.asarray(images)))
        xy = out["xy"]
        octv = out["octave"]
        ang = out["angle"]
        desc = out["desc"].astype(np.uint8)
        valid = out["valid"]
        xys, octs, descs, angs = [], [], [], []
        for b in range(B):
            m = valid[b]
            xys.append(xy[b][m].astype(np.float64))
            octs.append(np.broadcast_to(octv, (len(m),))[m].astype(np.int64)
                        if octv.ndim == 1 else octv[b][m].astype(np.int64))
            descs.append(desc[b][m])
            angs.append(ang[b][m].astype(np.float64))
        return xys, octs, descs, angs
