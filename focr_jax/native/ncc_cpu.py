"""Native host NCC searcher: the C++ kernel behind the oracle's interface.

Mirrors the role of the reference's AVX2 path (search_c_u8, ncc.rs:332-404):
a fast host implementation cross-checked against the pure-NumPy oracle (the
reference cross-checks --rust vs the C kernel the same way, ncc.rs:651-655).
Used as the host fallback when a device search overflows its candidate
capacity, and as a standalone CPU execution tier.
"""

from __future__ import annotations

import ctypes

import numpy as np

from focr_jax.models.types import MAX_MATCHES, Match
from focr_jax.native.build import FMatch, available, load
from focr_jax.oracle.ncc_oracle import Searcher as OracleSearcher


class NativeSearcher:
    """Drop-in for oracle.ncc_oracle.Searcher, with the hot loop in C++.

    Reuses the oracle's integral tables / patch-stat precompute (those are
    cheap, vectorized NumPy and encode the `_nz` border quirk); only the
    per-needle correlation sweep moves to native code.
    """

    def __init__(self, img: np.ndarray):
        self._lib = load()
        self._oracle = OracleSearcher(img)
        self.h, self.w = self._oracle.h, self._oracle.w
        self._ref = np.ascontiguousarray(self._oracle.reference)

    def _prep(self, n_w: int, n_h: int):
        prep = self._oracle.prepare_for_size(n_w, n_h)
        return (
            np.ascontiguousarray(prep.patch_sum),
            np.ascontiguousarray(prep.patch_rnorm),
            np.ascontiguousarray(prep.start_end),
        )

    def search(
        self, needle: np.ndarray, threshold: float, warn: bool = True
    ) -> list[Match]:
        import sys

        n_h, n_w = needle.shape
        if n_w > 16:
            raise NotImplementedError("needle wider than 16 px (reference panics too)")
        ps, rn, se = self._prep(n_w, n_h)
        nd = np.ascontiguousarray(needle)
        out = (FMatch * MAX_MATCHES)()
        cnt = self._lib.focr_ncc_search_u8(
            self._ref.ctypes.data_as(ctypes.c_void_p), self.w, self.h,
            nd.ctypes.data_as(ctypes.c_void_p), n_w, n_h,
            ps.ctypes.data_as(ctypes.c_void_p),
            rn.ctypes.data_as(ctypes.c_void_p),
            se.ctypes.data_as(ctypes.c_void_p),
            ctypes.c_float(threshold), out, MAX_MATCHES,
        )
        if cnt < 0:
            raise ValueError("native ncc kernel rejected arguments")
        if cnt >= MAX_MATCHES and warn:
            print(f"WARN got >= {MAX_MATCHES} matches", file=sys.stderr)
        return [
            Match(x=m.x, y=m.y, w=n_w, h=n_h, similarity=m.similarity)
            for m in out[:cnt]
        ]

    def search_many(
        self, needles: np.ndarray, threshold: float
    ) -> list[list[Match]]:
        """Search a [T, n_h, n_w] bank of same-size needles; OpenMP-parallel
        across needles (the native counterpart of the rayon fan-out)."""
        T, n_h, n_w = needles.shape
        if n_w > 16:
            raise NotImplementedError("needle wider than 16 px")
        ps, rn, se = self._prep(n_w, n_h)
        nd = np.ascontiguousarray(needles)
        out = (FMatch * (T * MAX_MATCHES))()
        counts = np.zeros(T, dtype=np.int64)
        self._lib.focr_ncc_search_many_u8(
            self._ref.ctypes.data_as(ctypes.c_void_p), self.w, self.h,
            nd.ctypes.data_as(ctypes.c_void_p), T, n_w, n_h,
            ps.ctypes.data_as(ctypes.c_void_p),
            rn.ctypes.data_as(ctypes.c_void_p),
            se.ctypes.data_as(ctypes.c_void_p),
            ctypes.c_float(threshold), out, MAX_MATCHES,
            counts.ctypes.data_as(ctypes.c_void_p),
        )
        res = []
        for t in range(T):
            base = t * MAX_MATCHES
            res.append(
                [
                    Match(x=m.x, y=m.y, w=n_w, h=n_h, similarity=m.similarity)
                    for m in out[base : base + int(counts[t])]
                ]
            )
        return res


def post_sort_winners(key: np.ndarray, sim: np.ndarray, overlap: int) -> np.ndarray:
    """Fused stable radix sort + overlap-run winner scan over UNSORTED hits
    (models/post.py::_winner_arrays): ``key`` is the composite
    (y << xbits) + x key per hit in engine order, ``sim`` the f32
    similarities. Returns each run winner's ORIGINAL index, in run (key)
    order — same selection as sorting stably then running post_winners, in
    one native call (no NumPy argsort, no full-array gathers)."""
    lib = load()
    key = np.ascontiguousarray(key, dtype=np.int64)
    sim = np.ascontiguousarray(sim, dtype=np.float32)
    n = len(key)
    out = np.empty(n, dtype=np.int64)
    nr = lib.focr_post_sort_winners(
        key.ctypes.data_as(ctypes.c_void_p),
        sim.ctypes.data_as(ctypes.c_void_p),
        n, int(overlap),
        out.ctypes.data_as(ctypes.c_void_p),
    )
    return out[:nr]


def post_winners(key: np.ndarray, sim: np.ndarray, overlap: int) -> np.ndarray:
    """Native overlap-run winner scan (models/post.py): ``key`` is the
    composite (y << xbits) + x sort key (i64, ascending), ``sim`` the f32
    similarities in the same order. Returns the winner INDEX per run, in run
    order — partition_by + last-max semantics (ncc.rs:753-766, 1036-1052) in
    one linear C pass."""
    lib = load()
    key = np.ascontiguousarray(key, dtype=np.int64)
    sim = np.ascontiguousarray(sim, dtype=np.float32)
    n = len(key)
    out = np.empty(n, dtype=np.int64)
    nr = lib.focr_post_winners(
        key.ctypes.data_as(ctypes.c_void_p),
        sim.ctypes.data_as(ctypes.c_void_p),
        n, int(overlap),
        out.ctypes.data_as(ctypes.c_void_p),
    )
    return out[:nr]


__all__ = [
    "NativeSearcher", "available", "post_sort_winners", "post_winners",
]
