"""Template banks: rasterize once at startup, match forever on-device.

This inverts the reference's loop order (SURVEY.md §7 design stance): instead
of re-rasterizing every candidate glyph inside the decode loop
(main.rs:98-106 — FreeType FFI per (cell × glyph)!), we rasterize the whole
alphabet ONCE per (font, size, grid) into dense u8 template arrays that live
in HBM, then score all (cell, glyph) pairs with batched matmuls.

Two bank kinds:

  * GridBank  — focr: per-cell clipped templates for the static cursor grid
                (monospace fast path, SURVEY.md §7 stage 2)
  * NeedleBank— ncc: per-(offset, letter) needles with box-size policy
                (ncc.rs:563-649)
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from focr_jax.fonts.ft import Canvas, Face, RectF
from focr_jax.models.types import BoxSize, RenderOptions
from focr_jax.oracle.focr_oracle import advance_px, alphabet_origin


@dataclass(frozen=True)
class GridBank:
    """Per-cell glyph templates for one (grid, crop-height) configuration.

    templates[k, g] is glyph g rasterized at cursor position k into the
    (crop_w × crop_h) line canvas — exactly what score_glyph compares against
    (main.rs:87-110) — cropped to the cell window [wx0[k], wx0[k]+win_w).
    """

    alphabet: str
    templates: np.ndarray  # [C, G, crop_h, win_w] u8
    tsq: np.ndarray  # [C, G] i32 — sum of squared template values
    wx0: np.ndarray  # [C] i32 — window start column in the line crop
    positions: np.ndarray  # [C] f32 — cursor x positions
    crop_w: int
    crop_h: int
    monospace: bool

    @property
    def n_cells(self) -> int:
        return self.templates.shape[0]

    @property
    def n_glyphs(self) -> int:
        return self.templates.shape[1]

    @property
    def win_w(self) -> int:
        return self.templates.shape[3]


def cursor_positions(face: Face, alphabet: str, ropts: RenderOptions, width: int) -> np.ndarray:
    """Static cursor grid for monospace fonts: replicates the f32 accumulation
    ``pos += advance/upem*size*kern_x`` (main.rs:176-178). Requires every
    alphabet glyph to share one advance (checked by caller)."""
    adv = advance_px(face, face.glyph_for_char(alphabet[0]), ropts)
    out = []
    pos = np.float32(0.0)
    while pos < np.float32(width):
        out.append(pos)
        pos = pos + adv
    return np.array(out, dtype=np.float32)


def is_monospace(face: Face, alphabet: str, ropts: RenderOptions) -> bool:
    advs = {float(advance_px(face, face.glyph_for_char(c), ropts)) for c in alphabet}
    return len(advs) <= 1


def build_grid_bank(
    face: Face,
    alphabet: str,
    ropts: RenderOptions,
    crop_w: int,
    crop_h: int,
) -> GridBank:
    """Build the focr cell/glyph template bank for a (crop_w × crop_h) line.

    Replaces decode_line's inner rasterization (main.rs:125-172). Each
    template is rasterized into a full line-sized canvas (so edge clipping
    matches the reference exactly) and cropped to a fixed-width window derived
    from actual ink extents.
    """
    if not is_monospace(face, alphabet, ropts):
        raise ValueError("grid bank requires a monospace alphabet (use the sequential fallback)")
    from focr_jax.utils import cache

    key = cache.bank_key(
        "grid",
        face.path,
        size=ropts.size,
        kern_x=ropts.kern_x,
        hinting=(ropts.hinting.full, ropts.hinting.size),
        alphabet=alphabet,
        crop_w=crop_w,
        crop_h=crop_h,
    )
    if (hit := cache.load_arrays(key)) is not None:
        return GridBank(
            alphabet=alphabet,
            templates=hit["templates"],
            tsq=hit["tsq"],
            wx0=hit["wx0"],
            positions=hit["positions"],
            crop_w=crop_w,
            crop_h=crop_h,
            monospace=True,
        )

    gids = [face.glyph_for_char(c) for c in alphabet]
    ox, oy = alphabet_origin(face, alphabet, ropts)
    positions = cursor_positions(face, alphabet, ropts, crop_w)
    C, G = len(positions), len(gids)

    canvases = np.zeros((C, G, crop_h, crop_w), dtype=np.uint8)
    canvas = Canvas(crop_w, crop_h)
    for k, pos in enumerate(positions):
        for gi, gid in enumerate(gids):
            canvas.fill(0)
            face.rasterize_glyph(
                canvas, gid, ropts.size, (float(ox + pos), float(oy)), ropts.hinting
            )
            canvases[k, gi] = canvas.pixels

    # Window per cell from actual ink extents (can exceed the metrics-derived
    # raster bounds by a pixel, so we derive from pixels, not metrics).
    col_ink = canvases.any(axis=2)  # [C, G, crop_w]
    any_ink = col_ink.any(axis=1)  # [C, crop_w]
    wx0 = np.zeros(C, dtype=np.int32)
    wx1 = np.ones(C, dtype=np.int32)
    for k in range(C):
        cols = np.nonzero(any_ink[k])[0]
        if len(cols):
            wx0[k], wx1[k] = cols[0], cols[-1] + 1
        else:
            wx0[k], wx1[k] = 0, 1
    win_w = int((wx1 - wx0).max())
    wx1 = np.minimum(wx0 + win_w, crop_w)
    wx0 = wx1 - win_w
    np.clip(wx0, 0, None, out=wx0)

    templates = np.zeros((C, G, crop_h, win_w), dtype=np.uint8)
    for k in range(C):
        w = min(win_w, crop_w - wx0[k])
        templates[k, :, :, :w] = canvases[k, :, :, wx0[k] : wx0[k] + w]

    t64 = canvases.astype(np.int64)
    tsq = (t64 * t64).sum(axis=(2, 3))
    # ||T||^2 exceeds i32 only for very large dense glyphs (>~33k ink px);
    # keep the compact i32 when safe, widen otherwise (ssd_metric promotes
    # its combine to i64 in the same regime — a blind cast would wrap)
    if tsq.max() < 2**31:
        tsq = tsq.astype(np.int32)
    cache.store_arrays(
        key, {"templates": templates, "tsq": tsq, "wx0": wx0, "positions": positions}
    )
    return GridBank(
        alphabet=alphabet,
        templates=templates,
        tsq=tsq,
        wx0=wx0,
        positions=positions,
        crop_w=crop_w,
        crop_h=crop_h,
        monospace=True,
    )


# --------------------------------------------------------------------------
# Proportional-font phase bank (focr sequential fallback, SURVEY.md §7 hard
# part 4)
# --------------------------------------------------------------------------

PROP_PHASES = 64  # FreeType quantizes translations to 1/64 px (26.6 fixed)


@dataclass(frozen=True)
class PropBank:
    """Per-(glyph, subpixel-phase) templates for the sequential greedy decode.

    FreeType rounds the rasterization translation to 1/64 px
    (`_to_f26dot6 = round(t*64)`, fonts/ft.py), and a post-hint translation by
    whole pixels shifts the coverage bitmap exactly — so the bitmap the
    reference draws at cursor t is templates[g, round(t*64) % 64] shifted by
    round(t*64) // 64 px. 64 phases therefore make the device decode
    BIT-EXACT, not approximate.

    templates[g, p] is glyph g rendered at x = base + p/64 into a
    (crop_h × wbank) canvas; colsq_cum[g, p, c] = Σ_{cols<c} Σ_rows T² gives
    the exact clipped ‖T‖² when the window hangs past the line-canvas edge
    (the reference clips ink at the canvas, main.rs:96-106).
    """

    alphabet: str
    templates: np.ndarray  # [G, P, crop_h, wbank] u8
    colsq_cum: np.ndarray  # [G, P, wbank+1] i32
    advances: np.ndarray  # [G] f32 — cursor advance per glyph
    base: int  # template canvas x margin (covers negative left bearing)
    ox: np.float32  # alphabet origin (main.rs:131-147)
    oy: np.float32
    crop_h: int

    @property
    def n_glyphs(self) -> int:
        return self.templates.shape[0]

    @property
    def wbank(self) -> int:
        return self.templates.shape[3]


def build_prop_bank(
    face: Face, alphabet: str, ropts: RenderOptions, crop_h: int
) -> PropBank:
    """Rasterize the G×64 phase bank (cached on disk like the grid bank)."""
    from focr_jax.utils import cache

    P = PROP_PHASES
    gids = [face.glyph_for_char(c) for c in alphabet]
    ox, oy = alphabet_origin(face, alphabet, ropts)
    advances = np.array(
        [advance_px(face, g, ropts) for g in gids], dtype=np.float32
    )

    key = cache.bank_key(
        "prop",
        face.path,
        size=ropts.size,
        kern_x=ropts.kern_x,
        hinting=(ropts.hinting.full, ropts.hinting.size),
        alphabet=alphabet,
        crop_h=crop_h,
        phases=P,
    )
    if (hit := cache.load_arrays(key)) is not None:
        return PropBank(
            alphabet=alphabet,
            templates=hit["templates"],
            colsq_cum=hit["colsq_cum"],
            advances=advances,
            base=int(hit["base"][0]),
            ox=ox,
            oy=oy,
            crop_h=crop_h,
        )

    # canvas extent: union of raster bounds over glyphs and phases, ±2 px of
    # slack (actual ink can exceed the metrics-derived bounds by a pixel)
    x0 = x1 = 0
    for g in gids:
        for p in range(P):
            rb = face.raster_bounds(g, ropts.size, (p / P, float(oy)), ropts.hinting)
            x0 = min(x0, rb.x0)
            x1 = max(x1, rb.x1)
    base = -x0 + 2
    wbank = base + x1 + 2

    G = len(gids)
    templates = np.zeros((G, P, crop_h, wbank), dtype=np.uint8)
    canvas = Canvas(wbank, crop_h)
    for gi, g in enumerate(gids):
        for p in range(P):
            canvas.fill(0)
            face.rasterize_glyph(
                canvas, g, ropts.size, (base + p / P, float(oy)), ropts.hinting
            )
            templates[gi, p] = canvas.pixels

    colsq = (templates.astype(np.int64) ** 2).sum(axis=2)  # [G, P, wbank]
    colsq_cum = np.zeros((G, P, wbank + 1), dtype=np.int64)
    np.cumsum(colsq, axis=2, out=colsq_cum[:, :, 1:])
    assert colsq_cum.max() < 2**31
    colsq_cum = colsq_cum.astype(np.int32)
    cache.store_arrays(
        key,
        {
            "templates": templates,
            "colsq_cum": colsq_cum,
            "base": np.array([base]),
        },
    )
    return PropBank(
        alphabet=alphabet,
        templates=templates,
        colsq_cum=colsq_cum,
        advances=advances,
        base=base,
        ox=ox,
        oy=oy,
        crop_h=crop_h,
    )


# --------------------------------------------------------------------------
# NCC needle bank
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class Needle:
    letter: str
    offset: tuple[float, float]  # the subpixel grid offset (pre-correction)
    corrected_offset: tuple[float, float]
    pixels: np.ndarray  # [n_h, n_w] u8
    s_n: int
    s2_n: int


def offsets_grid(x_bits: int, y_bits: int) -> list[tuple[float, float]]:
    """2^x_bits × 2^y_bits subpixel offsets, x-major (ncc.rs:563-573)."""
    xs = 2**x_bits
    ys = 2**y_bits
    return [(x / xs, y / ys) for x in range(xs) for y in range(ys)]


def _box_for_offset(
    face: Face,
    alphabet: str,
    ropts: RenderOptions,
    box_size: BoxSize,
    offset: tuple[float, float],
) -> tuple[float, tuple[int, int] | None]:
    """(y_offset, canvas (w, h) or None for per-char boxes) — ncc.rs:588-628."""
    m = face.metrics
    to_px = np.float32(1.0) / np.float32(m.units_per_em) * np.float32(ropts.size)
    if box_size is BoxSize.FONT:
        bbox = m.bounding_box.scale(float(to_px)).round_out()
        y_offset = float(np.ceil(np.float32(m.ascent) * to_px))
        return y_offset, (bbox.width, bbox.height)
    if box_size is BoxSize.ALPHABET:
        y_offset = 0.0
        bbox = RectF()
        for c in alphabet:
            gid = face.glyph_for_char(c)
            tb = face.typographic_bounds(gid).scale(float(to_px))
            bearing_y = tb.y0 + tb.height  # glyph_bounds.origin().y() + height
            y_offset = max(y_offset, float(np.ceil(np.float32(bearing_y))))
            rb = face.raster_bounds(gid, ropts.size, offset, ropts.hinting)
            bbox = bbox.union_rect(rb.to_f32())
        out = bbox.round_out()
        return y_offset, (out.width, out.height)
    return 0.0, None


def render_needle(
    face: Face,
    letter: str,
    corrected_offset: tuple[float, float],
    ropts: RenderOptions,
    canvas_size: tuple[int, int] | None,
    padding: tuple[int, int],
) -> np.ndarray:
    """The ncc glyph renderer (ncc.rs:143-196): canvas = box (+2*padding) for
    fixed boxes (origin (0,0)) or tight raster bounds for per-char boxes
    (origin -raster_bounds.origin())."""
    gid = face.glyph_for_char(letter)
    if canvas_size is not None:
        size = (canvas_size[0] + 2 * padding[0], canvas_size[1] + 2 * padding[1])
        origin = (0.0, 0.0)
    else:
        rb = face.raster_bounds(gid, ropts.size, corrected_offset, ropts.hinting)
        size = (rb.width + 2 * padding[0], rb.height + 2 * padding[1])
        origin = (-float(rb.x0), -float(rb.y0))
    canvas = Canvas(size[0], size[1])
    face.rasterize_glyph(
        canvas,
        gid,
        ropts.size,
        (
            origin[0] + padding[0] + corrected_offset[0],
            origin[1] + padding[1] + corrected_offset[1],
        ),
        ropts.hinting,
    )
    return canvas.pixels


def build_needles(
    face: Face,
    alphabet: str,
    ropts: RenderOptions,
    box_size: BoxSize,
    x_bits: int,
    y_bits: int,
    padding: tuple[int, int] = (0, 0),
) -> list[Needle]:
    """All (offset × letter) needles in reference iteration order
    (offsets outer, letters inner — ncc.rs:587-655)."""
    from focr_jax.utils import cache

    key = cache.bank_key(
        "needles",
        face.path,
        size=ropts.size,
        hinting=(ropts.hinting.full, ropts.hinting.size),
        alphabet=alphabet,
        box=box_size.value,
        x_bits=x_bits,
        y_bits=y_bits,
        padding=padding,
    )
    if (hit := cache.load_arrays(key)) is not None:
        n = int(hit["n"][0])
        return [
            Needle(
                letter=str(hit["letters"][i]),
                offset=(float(hit["offsets"][i, 0]), float(hit["offsets"][i, 1])),
                corrected_offset=(
                    float(hit["corrected"][i, 0]),
                    float(hit["corrected"][i, 1]),
                ),
                pixels=hit[f"px{i}"],
                s_n=int(hit["s_n"][i]),
                s2_n=int(hit["s2_n"][i]),
            )
            for i in range(n)
        ]

    needles: list[Needle] = []
    for offset in offsets_grid(x_bits, y_bits):
        y_off, canvas_size = _box_for_offset(face, alphabet, ropts, box_size, offset)
        corrected = (offset[0], offset[1] + y_off)
        for letter in alphabet:
            px = render_needle(face, letter, corrected, ropts, canvas_size, padding)
            p64 = px.astype(np.int64)
            needles.append(
                Needle(
                    letter=letter,
                    offset=offset,
                    corrected_offset=corrected,
                    pixels=px,
                    s_n=int(p64.sum()),
                    s2_n=int((p64 * p64).sum()),
                )
            )
    arrays: dict[str, np.ndarray] = {
        "n": np.array([len(needles)]),
        "letters": np.array([nd.letter for nd in needles]),
        "offsets": np.array([nd.offset for nd in needles], dtype=np.float64),
        "corrected": np.array([nd.corrected_offset for nd in needles], dtype=np.float64),
        "s_n": np.array([nd.s_n for nd in needles], dtype=np.int64),
        "s2_n": np.array([nd.s2_n for nd in needles], dtype=np.int64),
    }
    for i, nd in enumerate(needles):
        arrays[f"px{i}"] = nd.pixels
    cache.store_arrays(key, arrays)
    return needles
