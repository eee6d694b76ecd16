"""Bit-packed page-upload wire format: host-side encode + on-device decode.

OPT-IN (FOCR_NCC_PACK=1), off by default: it trades ~0.4x of the ncc
pipeline's host->device page bytes for an on-device decode, which pays only
where the upload bounds the pipeline; no measurement on a directly attached
card has shown that yet (the reference never uploads — its AVX2 sweep reads
pages straight from host RAM, ncc.cpp:48-142).

Text pages are mostly background: the INVERTED page (255 - x, the form every
engine tier consumes) is ~70-80% zeros on dense corpora. This module ships

  mask  [B, H, ceil(W/8)] u8 -- one bit per pixel (np.packbits big-endian:
                               bit 7 of byte j covers x = 8j), 1 = nonzero
  vals  [nnz_pad]          u8 -- the nonzero pixel values in flat C scan
                               order (page-major, then row-major), zero
                               padded to a static rung (see vals_rung)

which is bits/8 + ink bytes ~= 0.33-0.42x of raw for dense text, and the
device reconstructs the exact u8 plane with one unpack + cumsum + gather --
three fused vector passes, no scalar loop. The decode is EXACT (every u8
value is preserved verbatim), so bit parity of every downstream tier is
untouched by construction.

Dtype notes: the package runs with jax_enable_x64 on, so every literal that
meets a device array here is dtype-pinned (a bare python int would promote
the u8 planes to i64).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


def pack_wave(inv: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Encode an inverted u8 wave [B, H, W] into (mask, vals) -- see module
    docstring for the format. Pure NumPy; ~ms per 8 MB wave (packbits is a
    single vector pass, the boolean extract a second)."""
    nz = inv != 0
    mask = np.packbits(nz, axis=-1)  # big-endian bit order (bit 7 first)
    vals = inv[nz]  # flat C order == ascending (b, y, x) == mask bit order
    return mask, vals


def vals_rung(n: int) -> int:
    """Static size ladder for the vals buffer: quarter-power-of-two steps
    (1, 1.25, 1.5, 1.75 x 2^k), so padding waste stays <= 25% while each
    octave adds at most 4 compiled shapes (every fresh shape costs a device
    compile; the persistent compile cache amortizes across runs)."""
    n = max(int(n), 512)
    k = (n - 1).bit_length()  # n in (2^(k-1), 2^k]
    step = 1 << max(k - 3, 0)  # quarter of the octave floor 2^(k-1)
    return -(-n // step) * step


def packed_nbytes(shape: tuple[int, int, int], nnz: int) -> int:
    """Wire bytes for a packed [B, H, W] wave with ``nnz`` nonzero pixels."""
    B, H, W = shape
    return B * H * ((W + 7) // 8) + vals_rung(nnz)


@functools.partial(jax.jit, static_argnames=("W",))
def unpack_wave(mask: jax.Array, vals: jax.Array, *, W: int) -> jax.Array:
    """Exact on-device decode: (mask [B, H, WB] u8, vals [nnz_pad] u8) ->
    [B, H, W] u8. Index of each set bit into vals = its rank among set bits
    (inclusive cumsum - 1) -- one i32 cumsum over B*H*W lanes and one 1D
    table gather, both plain vector work XLA fuses with the consumer's first
    pass over the plane."""
    B, H, WB = mask.shape
    shifts = jnp.arange(7, -1, -1, dtype=jnp.uint8)  # MSB first: packbits order
    bits = (mask[:, :, :, None] >> shifts) & jnp.uint8(1)  # [B, H, WB, 8] u8
    bits = bits.reshape(B, H, WB * 8)[:, :, :W]
    idx = jnp.cumsum(bits.reshape(-1).astype(jnp.int32), dtype=jnp.int32)
    idx = jnp.maximum(idx - jnp.int32(1), jnp.int32(0)).reshape(B, H, W)
    v = jnp.take(vals, idx, mode="clip")
    return jnp.where(bits != jnp.uint8(0), v, jnp.uint8(0))
