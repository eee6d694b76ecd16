"""Diagnostic overlays + accuracy metric — focr's --test / --verify modes.

Replicates draw_test_rectangles (main.rs:241-274), draw_test_text
(main.rs:276-298), draw_verify (main.rs:300-329) and red_blue_mse
(main.rs:518-524). These are host-side (one-shot diagnostics), with the MSE
reduction exactly mirroring the reference's i64-sum / f32-divide.
"""

from __future__ import annotations

import numpy as np

from focr_jax.fonts.ft import Face
from focr_jax.models.types import DecodedLine, DecodeOptions, RenderOptions
from focr_jax.oracle.focr_oracle import render_string


def _blend_rgba(dst: np.ndarray, src_rgba: tuple[int, int, int, int]) -> None:
    """image crate Pixel::blend for Rgba over Rgba (alpha compositing, u8)."""
    r, g, b, a = src_rgba
    alpha = a / 255.0
    out_a = dst[..., 3] / 255.0
    comp_a = alpha + out_a * (1 - alpha)
    safe = np.where(comp_a == 0, 1.0, comp_a)
    for i, s in enumerate((r, g, b)):
        dst[..., i] = np.round(
            (s * alpha + dst[..., i] * out_a * (1 - alpha)) / safe
        ).astype(np.uint8)
    dst[..., 3] = np.round(comp_a * 255).astype(np.uint8)


def draw_test_rectangles(img: np.ndarray, dopts: DecodeOptions) -> np.ndarray:
    """Translucent red outlines around every non-white scan rect (main.rs:241-274)."""
    H, W = img.shape
    out = np.stack([img, img, img, np.full_like(img, 255)], axis=-1).astype(np.uint8)
    c = (255, 0, 0, 128)
    i = 0
    while True:
        y = dopts.y_start + i * dopts.line_advance
        i += 1
        y0 = min(y, H)
        ch = min(dopts.line_height, H - y0)
        if ch <= 0:
            break
        x0 = min(dopts.x_start, W)
        cw = min(dopts.width, W - x0)
        crop = img[y0 : y0 + ch, x0 : x0 + cw]
        if (crop == 255).all():
            continue
        xs = slice(dopts.x_start, min(dopts.x_start + dopts.width + 1, W))
        _blend_rgba(out[y, xs], c)
        if y + dopts.line_height < H:
            _blend_rgba(out[y + dopts.line_height, xs], c)
        ys = slice(y, min(y + dopts.line_height + 1, H))
        _blend_rgba(out[ys, dopts.x_start], c)
        if dopts.x_start + dopts.width < W:
            _blend_rgba(out[ys, dopts.x_start + dopts.width], c)
    return out


def draw_test_text(
    face: Face, text: str, img: np.ndarray, ropts: RenderOptions
) -> np.ndarray:
    """Alpha-blend the alphabet string in red over the page (main.rs:276-298)."""
    H, W = img.shape
    out = np.stack([img, img, img, np.full_like(img, 255)], axis=-1).astype(np.uint8)
    canvas = render_string(face, text, ropts)
    inv = 255 - canvas.pixels.astype(np.int32)  # canvas_to_lum8 (main.rs:331-340)
    h = min(H, inv.shape[0])
    w = min(W, inv.shape[1])
    region = out[:h, :w]
    mask = inv[:h, :w] != 255
    # dst alpha is 255 everywhere, so Rgba blend reduces to a lerp with a=128/255
    alpha = 128.0 / 255.0
    src = inv[:h, :w].astype(np.float64)
    dst = region.astype(np.float64)
    blended_r = np.round(src * alpha + dst[..., 0] * (1 - alpha)).astype(np.uint8)
    blended_gb = np.round(dst[..., 1:3] * (1 - alpha)).astype(np.uint8)
    region[..., 0] = np.where(mask, blended_r, region[..., 0])
    region[..., 1] = np.where(mask, blended_gb[..., 0], region[..., 1])
    region[..., 2] = np.where(mask, blended_gb[..., 1], region[..., 2])
    return out


def draw_verify(
    img: np.ndarray,
    lines: list[DecodedLine],
    face: Face,
    dopts: DecodeOptions,
    ropts: RenderOptions,
) -> np.ndarray:
    """Black canvas; reference ink -> red channel, re-rendered decode -> blue
    (main.rs:300-329)."""
    H, W = img.shape
    out = np.zeros((H, W, 3), dtype=np.uint8)
    ink = img != 255
    out[..., 0] = np.where(ink, img, 0)

    for line in lines:
        canvas = render_string(face, line.text, ropts)
        inv = 255 - canvas.pixels.astype(np.int32)
        ys, xs = np.nonzero(inv != 255)
        for yy, xx in zip(ys, xs):
            ty, tx = line.y + yy, dopts.x_start + xx
            if 0 <= ty < H and 0 <= tx < W:
                out[ty, tx, 2] = inv[yy, xx]
    return out


def red_blue_mse(img_rgb: np.ndarray) -> float:
    """f32 mean of (R-B)^2 over pixels (main.rs:518-524)."""
    r = img_rgb[..., 0].astype(np.int64)
    b = img_rgb[..., 2].astype(np.int64)
    total = int(((r - b) ** 2).sum())
    H, W = img_rgb.shape[:2]
    return float(np.float32(total) / np.float32(H * W))
