"""Exact-integer SSD scoring ops for the focr grid decoder.

The reference scores each candidate glyph with an i64 SSD over the whole line
canvas (main.rs:87-110, 510-516). Expanding ||I - T||^2 = ||I||^2 - 2 I.T
+ ||T||^2 and dropping the template-independent ||I||^2, the argmin over
templates is exactly argmin_T (||T||^2 - 2 I.T) — computed here as one batched
matmul.

Exactness argument (why bf16 matmul is bit-exact here): pixel values are u8
(<= 255 = 8 bits), losslessly representable in bf16's 8-bit mantissa; the
matmul multiplies exactly and accumulates in f32 (preferred_element_type), and
every partial sum is
a non-negative integer bounded by n*255^2.  While n*65025 < 2^24 every
intermediate is exactly representable, so the f32 result equals the integer
dot product.  Beyond that bound we split the template into 4-bit nibbles
(T = 16*Th + Tl, terms bounded by n*255*15) and recombine in i32 — exact for
any realistic template size.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

_EXACT_F32_LIMIT = 1 << 24


def extract_strips(inv: jax.Array, ys: tuple[int, ...], crop_h: int, x0: int, crop_w: int):
    """[B, H, W] inverted pages -> [B, R, crop_h, crop_w] line strips.

    Gather-free: the scan grid's arithmetic row structure is exploited
    instead of a large advanced-index gather — a pad+reshape when rows are
    uniformly spaced with
    stride >= height (the common case: line_advance >= line_height), falling
    back to a 1-D take for overlapping/irregular grids.
    """
    B, H, W = inv.shape
    R = len(ys)
    if R == 1:
        return inv[:, ys[0] : ys[0] + crop_h, x0 : x0 + crop_w][:, None]
    strides = {ys[i + 1] - ys[i] for i in range(R - 1)}
    if len(strides) == 1 and (adv := strides.pop()) >= crop_h:
        y0 = ys[0]
        tail = y0 + R * adv
        body = inv
        if tail > H:
            body = jnp.pad(inv, ((0, 0), (0, tail - H), (0, 0)))  # zeros = white
        return body[:, y0:tail].reshape(B, R, adv, W)[:, :, :crop_h, x0 : x0 + crop_w]
    rows = np.asarray(ys, dtype=np.int32)[:, None] + np.arange(crop_h, dtype=np.int32)
    flat = jnp.take(inv, jnp.asarray(rows.reshape(-1)), axis=1)
    return flat.reshape(B, R, crop_h, W)[:, :, :, x0 : x0 + crop_w]


def extract_windows(strips: jax.Array, wx0: np.ndarray, win_w: int) -> jax.Array:
    """[B, R, h, crop_w] strips -> [B, R, C, h, win_w] per-cell windows via
    statically unrolled slices (compile-friendly; no gather)."""
    padded = jnp.pad(strips, ((0, 0), (0, 0), (0, 0), (0, win_w)))
    cells = [padded[:, :, :, int(w) : int(w) + win_w] for w in wx0]
    return jnp.stack(cells, axis=2)


def _exact_dot(dot, wins: jax.Array, tmpl: jax.Array, n: int) -> jax.Array:
    """Exact integer dot via bf16 matmuls (``dot(w, t) -> f32``), picking the
    cheapest split whose every partial sum stays below 2^24 (exactly
    representable in f32):
      n*255*255 < 2^24 (n <= 258)    -> 1 matmul
      n*255*15  < 2^24 (n <= 4385)   -> template nibble split, 2 matmuls
      n*15*15   < 2^24 (n <= 74565)  -> both-operand nibble split, 4 matmuls
    The 4-matmul recombination itself overflows i32 once the true dot
    n*255*255 can exceed 2^31 (n > 33026), so that branch combines in i64
    (partial dots still fit i32; only the cheap elementwise combine widens).
    """
    if n * 65025 < _EXACT_F32_LIMIT:
        return dot(wins, tmpl).astype(jnp.int32)
    ti = tmpl.astype(jnp.int32)
    thi = jnp.right_shift(ti, 4)
    tlo = jnp.bitwise_and(ti, 15)
    if n * 3825 < _EXACT_F32_LIMIT:
        return dot(wins, thi).astype(jnp.int32) * 16 + dot(wins, tlo).astype(jnp.int32)
    assert n * 225 < _EXACT_F32_LIMIT, (
        f"window of {n} pixels exceeds the exact-bf16 SSD bound (74565); "
        "bit parity cannot be guaranteed"
    )
    acc_t = jnp.int32 if n * 65025 < 2**31 else jnp.int64
    wi = wins.astype(jnp.int32)
    whi = jnp.right_shift(wi, 4)
    wlo = jnp.bitwise_and(wi, 15)
    return (
        dot(whi, thi).astype(acc_t) * 256
        + (dot(whi, tlo).astype(acc_t) + dot(wlo, thi).astype(acc_t)) * 16
        + dot(wlo, tlo).astype(acc_t)
    )


def exact_corr(wins: jax.Array, tmpl: jax.Array) -> jax.Array:
    """Exact integer correlation I.T.

    wins: [B, R, C, p, q] integer-valued (inverted image windows, 0..255)
    tmpl: [C, G, p, q] u8 templates
    returns: [B, R, C, G] i32, exactly sum(I*T) per (cell, glyph)
    """

    def dot(w, t):
        return jnp.einsum(
            "brcpq,cgpq->brcg",
            w.astype(jnp.bfloat16),
            t.astype(jnp.bfloat16),
            preferred_element_type=jnp.float32,
        )

    p, q = tmpl.shape[-2], tmpl.shape[-1]
    return _exact_dot(dot, wins, tmpl, p * q)


def exact_corr_mat(wins: jax.Array, tmpl: jax.Array) -> jax.Array:
    """Exact integer correlation as a plain matmul.

    wins: [L, K] integer-valued 0..255; tmpl: [T, K] u8 templates.
    Returns [L, T] i32 == exact sum(wins * tmpl) per pair — same split
    scheme as exact_corr (see _exact_dot).
    """

    def dot(w, t):
        return jnp.einsum(
            "lk,tk->lt",
            w.astype(jnp.bfloat16),
            t.astype(jnp.bfloat16),
            preferred_element_type=jnp.float32,
        )

    return _exact_dot(dot, wins, tmpl, tmpl.shape[-1])


def ssd_metric(wins: jax.Array, tmpl: jax.Array, tsq: jax.Array) -> jax.Array:
    """[B, R, C, G] metric = ||T||^2 - 2 I.T (equi-argmin with full SSD).

    i32 while the worst-case |metric| bound 3*n*255^2 fits (n <= 11008);
    beyond that a dense-ink window/template pair could silently wrap the i32
    subtraction, so the combine widens to i64 (the matmuls are unchanged)."""
    n = tmpl.shape[-2] * tmpl.shape[-1]
    corr = exact_corr(wins, tmpl)
    if 3 * n * 65025 >= 2**31:
        return tsq[None, None].astype(jnp.int64) - 2 * corr.astype(jnp.int64)
    return tsq[None, None].astype(jnp.int32) - 2 * corr


def argmin_glyph(metric: jax.Array) -> jax.Array:
    """First-minimum argmin over the glyph axis (Rust min_by_key, main.rs:159)."""
    return jnp.argmin(metric, axis=-1).astype(jnp.int32)
