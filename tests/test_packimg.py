"""ops/packimg.py — the bit-packed page-upload wire format.

The decode must be EXACT for every u8 plane (bit parity of all downstream
engine tiers rides on it), the rung ladder must bound padding waste, and the
dispatch gate must pick the packed path only when it is smaller on the wire.
"""

import os

import numpy as np
import pytest

from focr_jax.ops import packimg


def _roundtrip(inv: np.ndarray) -> np.ndarray:
    mask, vals = packimg.pack_wave(inv)
    assert mask.shape == (*inv.shape[:2], (inv.shape[2] + 7) // 8)
    pad = packimg.vals_rung(vals.size) - vals.size
    out = packimg.unpack_wave(mask, np.pad(vals, (0, pad)), W=inv.shape[2])
    return np.asarray(out)


@pytest.mark.parametrize("shape", [(1, 5, 7), (2, 16, 33), (3, 40, 64)])
@pytest.mark.parametrize("density", [0.0, 0.1, 0.5, 1.0])
def test_roundtrip_exact(shape, density):
    rng = np.random.default_rng(hash((shape, density)) % 2**32)
    inv = np.where(
        rng.random(shape) < density, rng.integers(1, 256, shape), 0
    ).astype(np.uint8)
    np.testing.assert_array_equal(_roundtrip(inv), inv)


def test_roundtrip_all_255():
    inv = np.full((2, 9, 13), 255, np.uint8)
    np.testing.assert_array_equal(_roundtrip(inv), inv)


def test_roundtrip_single_pixel_corners():
    for b, y, x in [(0, 0, 0), (1, 7, 30), (0, 7, 0), (1, 0, 30)]:
        inv = np.zeros((2, 8, 31), np.uint8)
        inv[b, y, x] = 77
        np.testing.assert_array_equal(_roundtrip(inv), inv)


def test_vals_rung_ladder():
    # covers n, <= 25% waste, quarter-pow2 members, monotone
    prev = 0
    for n in [1, 511, 512, 513, 1000, 4096, 5000, 100_000, 2_000_001]:
        r = packimg.vals_rung(n)
        assert r >= max(n, 512)
        assert r <= max(n, 512) * 1.25 + 512
        k = (r - 1).bit_length()
        step = 1 << max(k - 3, 0)
        assert r % step == 0
        assert r >= prev
        prev = r


def test_packed_nbytes_accounts_mask_and_rung():
    assert packimg.packed_nbytes((2, 10, 17), 600) == 2 * 10 * 3 + packimg.vals_rung(600)


def test_dispatch_gate_and_bit_parity(monkeypatch):
    """A dense search must be bit-identical whichever upload path carried the
    pixels — run the same page through a forced-packed and a forced-raw
    matcher and compare raw CSV output byte for byte."""
    from focr_jax.fonts.ft import Face
    from focr_jax.models.ncc import NccMatcher
    from focr_jax.models.types import NCC_DEFAULT_ALPHABET, RenderOptions

    from focr_jax.fonts import DEJAVU_MONO

    face = Face(DEJAVU_MONO)
    ropts = RenderOptions(size=11.0)
    rng = np.random.default_rng(11)
    page = np.full((80, 120), 255, np.uint8)
    # a few glyph-ish ink blobs
    for _ in range(12):
        y, x = rng.integers(0, 70), rng.integers(0, 108)
        page[y : y + 9, x : x + 7] = rng.integers(0, 128, (9, 7))

    outs = {}
    for env in ("0", "1"):
        monkeypatch.setenv("FOCR_NCC_PACK", env)
        m = NccMatcher(
            face, NCC_DEFAULT_ALPHABET[:12], ropts, x_bits=1
        )
        hits = m.get_hits(page)
        outs[env] = [
            (h.letter, h.x, h.y, np.float32(h.similarity).tobytes())
            for h in hits
        ]
    assert outs["0"] == outs["1"]
