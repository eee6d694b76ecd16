"""Direct tests of the post-processing fast paths (models/post.py).

The reference pipeline is process_hits (object form, the literal
partition_by port, ncc.rs:723-786); _winner_arrays / _run_winners are its
vectorized/native core. Both the native C winners scan and the NumPy
fallback must agree with each other and with the object pipeline on every
distribution, including similarity TIES (last max wins, ncc.rs:763) and
negative/zero/huge overlaps.
"""

import numpy as np
import pytest

from focr_jax.models import post as post_mod
from focr_jax.models.post import _run_winners
from focr_jax.native import ncc_cpu


def _numpy_winners(lkey, lsim, ov, N):
    """The NumPy fallback path, forced (bypasses the native gate)."""
    nxt = np.maximum(
        np.searchsorted(lkey, lkey + ov, side="right"),
        np.arange(1, N + 1),
    )
    run_starts = []
    nxt_l = nxt.tolist()
    r = 0
    while r < N:
        run_starts.append(r)
        r = nxt_l[r]
    rs = np.array(run_starts, dtype=np.int64)
    run_max = np.maximum.reduceat(lsim, rs) if len(rs) else np.zeros(0, np.float32)
    run_of = np.repeat(np.arange(len(rs)), np.diff(np.append(rs, N)))
    at_max = lsim == run_max[run_of]
    return (
        np.maximum.reduceat(np.where(at_max, np.arange(N), -1), rs)
        if len(rs)
        else np.zeros(0, np.int64)
    )


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("ov", [-3, 0, 1, 5, 70000])
def test_run_winners_native_matches_numpy(seed, ov):
    if not ncc_cpu.available():
        pytest.skip("native toolchain unavailable")
    rng = np.random.default_rng(seed)
    N = int(rng.integers(1, 4000))
    # clustered ascending keys over a few simulated lines, with duplicates
    ys = np.sort(rng.integers(0, 7, N)) << 17
    xs = np.sort(rng.integers(0, 600, N))
    key = np.sort(ys + xs).astype(np.int64)
    # quantized sims force plenty of exact ties (the last-max surface)
    sim = (rng.integers(0, 8, N) / 8.0).astype(np.float32)
    a = ncc_cpu.post_winners(key, sim, ov)
    b = _numpy_winners(key, sim, ov, N)
    np.testing.assert_array_equal(a, b)
    # and the dispatching wrapper picks one of them
    np.testing.assert_array_equal(_run_winners(key, sim, ov, N), a)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("ov", [-3, 0, 1, 5, 70000])
def test_post_sort_winners_matches_sort_then_scan(seed, ov):
    """The fused native radix-sort+scan must equal a stable argsort followed
    by the sorted-input winner scan, mapped back to original indices —
    including duplicate keys (stability surface) and similarity ties."""
    if not ncc_cpu.available():
        pytest.skip("native toolchain unavailable")
    rng = np.random.default_rng(100 + seed)
    N = int(rng.integers(1, 4000))
    # UNSORTED keys with duplicates across simulated needle groups
    ys = rng.integers(0, 7, N).astype(np.int64) << 17
    xs = rng.integers(0, 600, N).astype(np.int64)
    key = ys + xs
    sim = (rng.integers(0, 8, N) / 8.0).astype(np.float32)
    got = ncc_cpu.post_sort_winners(key, sim, ov)
    order = np.argsort(key, kind="stable")
    widx_sorted = _numpy_winners(key[order], sim[order], ov, N)
    np.testing.assert_array_equal(got, order[widx_sorted])


@pytest.mark.parametrize("shift", [33, 49])
def test_post_sort_winners_multipass_keys(shift):
    """Keys past 2^32 / 2^48 force the radix sort's 3rd and 4th 16-bit
    digit passes (focr_post_sort_winners's `passes` loop) — the realistic
    page-key tests above stop at 2 passes, so a digit-offset bug in the
    upper passes would be invisible to them."""
    if not ncc_cpu.available():
        pytest.skip("native toolchain unavailable")
    rng = np.random.default_rng(shift)
    N = 2500
    ys = rng.integers(0, 7, N).astype(np.int64) << shift
    xs = rng.integers(0, 600, N).astype(np.int64)
    key = ys + xs
    sim = (rng.integers(0, 8, N) / 8.0).astype(np.float32)
    for ov in (0, 5):
        got = ncc_cpu.post_sort_winners(key, sim, ov)
        order = np.argsort(key, kind="stable")
        widx_sorted = _numpy_winners(key[order], sim[order], ov, N)
        np.testing.assert_array_equal(got, order[widx_sorted])


def test_winner_arrays_native_matches_numpy(monkeypatch):
    """Full _winner_arrays parity: the fused native path and the pure-NumPy
    path must return identical winner arrays and line bounds."""
    if not ncc_cpu.available():
        pytest.skip("native toolchain unavailable")
    from focr_jax.models.ncc import HitStruct
    from focr_jax.models.post import _winner_arrays

    rng = np.random.default_rng(17)
    for trial in range(6):
        N = int(rng.integers(1, 3000))
        nid = np.sort(rng.integers(0, 50, N)).astype(np.int32)
        x = rng.integers(0, 600, N).astype(np.int64)
        y = (rng.integers(0, 8, N) * 15 + 9).astype(np.int64)
        sim = (rng.integers(70, 101, N) / 100.0).astype(np.float32)
        hs = HitStruct(needle_id=nid, x=x, y=y, sim=sim, matcher=None)
        for ov in (-1, 0, 5, 40):
            a = _winner_arrays(hs, 0.95, ov)
            monkeypatch.setattr(ncc_cpu, "available", lambda: False)
            b = _winner_arrays(hs, 0.95, ov)
            monkeypatch.undo()
            assert (a is None) == (b is None), f"trial {trial} ov {ov}"
            if a is None:
                continue
            for ai, bi in zip(a, b):
                np.testing.assert_array_equal(ai, bi, err_msg=f"trial {trial} ov {ov}")


def test_run_winners_numpy_fallback_used_when_native_missing(monkeypatch):
    """The gate degrades to NumPy (not an exception) without the toolchain."""
    monkeypatch.setattr(ncc_cpu, "available", lambda: False)
    key = np.array([0, 2, 4, 100], dtype=np.int64)
    sim = np.array([0.5, 0.9, 0.9, 0.1], dtype=np.float32)
    got = _run_winners(key, sim, 5, 4)
    # one run [0,2,4] (anchored at key 0, overlap 5) -> last max idx 2; run [100]
    np.testing.assert_array_equal(got, [2, 3])


def test_winner_arrays_matches_object_pipeline():
    """Randomized HitStruct-level check: the vectorized pipeline must equal
    the literal partition_by port for text/struct outputs (ties included)."""
    from focr_jax.models.post import process_hits, process_hits_struct
    from focr_jax.models.types import MatchWithLetter

    class _FakeNeedle:
        def __init__(self, letter):
            self.letter = letter
            self.pixels = np.zeros((3, 2), np.uint8)

    class _FakeMatcher:
        def __init__(self, letters):
            self.needles = [_FakeNeedle(c) for c in letters]

    rng = np.random.default_rng(11)
    letters = "abcXYZ"
    m = _FakeMatcher(letters)
    for trial in range(8):
        N = int(rng.integers(1, 800))
        nid = rng.integers(0, len(letters), N).astype(np.int32)
        x = rng.integers(0, 500, N).astype(np.int64)
        y = (rng.integers(0, 6, N) * 15 + 9).astype(np.int64)
        sim = (rng.integers(70, 100, N) / 100.0).astype(np.float32)
        hs = post_mod.__dict__  # noqa: F841 - readability
        from focr_jax.models.ncc import HitStruct

        # HitStruct iteration order: grouped by needle id like the engine
        order = np.argsort(nid, kind="stable")
        struct = HitStruct(
            needle_id=nid[order], x=x[order], y=y[order],
            sim=sim[order], matcher=m,
        )
        objs = [
            MatchWithLetter(letters[int(t)], int(xx), int(yy), 2, 3, float(ss))
            for t, xx, yy, ss in zip(nid[order], x[order], y[order], sim[order])
        ]
        for ov in (-1, 0, 5, 40):
            a = process_hits_struct(struct, 0.9, ov)
            b = process_hits(objs, 0.9, ov)
            ka = [[(h.letter, h.x, h.y, np.float32(h.similarity).tobytes()) for h in ln] for ln in a]
            kb = [[(h.letter, h.x, h.y, np.float32(h.similarity).tobytes()) for h in ln] for ln in b]
            assert ka == kb, f"trial {trial} ov {ov}"
