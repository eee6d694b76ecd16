"""NCC hit post-processing — the 3-step pipeline of reference README.md:48-52.

This host-side code IS the production post-processor (SURVEY.md §7 stage 5:
parity outranks elegance; the hit counts are tiny). Semantics replicated from
process_hits/partition_by (reference src/ncc.rs:723-786, 1036-1052):

  1. anchor filter: keep the exact y's that have any hit with
     f32 similarity >= anchor_threshold                    (ncc.rs:724-739)
  2. stable sort by y, partition on exact y equality        (ncc.rs:741-752)
  3. per line: stable sort by x, partition into runs — each run is ANCHORED
     AT ITS FIRST ELEMENT (partition_by never updates `last` inside a run,
     ncc.rs:1036-1052), members satisfy |x_first - x| <= overlap — then keep
     the max-similarity hit per run, LAST max wins ties (Rust max_by with
     total_cmp returns the last maximal element, ncc.rs:753-766).
"""

from __future__ import annotations

import sys
import time
from typing import Callable, Sequence, TypeVar

import numpy as np

from focr_jax.models.types import MatchWithLetter

T = TypeVar("T")


def partition_by(xs: Sequence[T], pred: Callable[[T, T], bool]) -> list[tuple[int, int]]:
    """Reference partition_by (ncc.rs:1036-1052).

    Splits ``xs`` into half-open index runs. The comparison element (`last`)
    is only updated when a run closes, so every element is compared against
    the FIRST element of its run — not its predecessor.
    Returns [] for empty input (the reference panics; nothing to partition).
    """
    if len(xs) == 0:
        return []
    slices: list[tuple[int, int]] = []
    i = 0
    j = 0
    last = xs[0]
    for next_ in xs[1:]:
        j += 1
        if not pred(last, next_):
            slices.append((i, j))
            i = j
            last = next_
    slices.append((i, j + 1))
    return slices


def process_hits(
    all_hits: Sequence[MatchWithLetter],
    anchor_threshold: float,
    overlap: int,
    verbose: bool = False,
) -> list[list[MatchWithLetter]]:
    """Reference process_hits (ncc.rs:723-786). Returns text lines of hits.

    verbose replicates the reference diagnostics: per-kept-hit y dumps
    (ncc.rs:743-746), the per-line Δx histogram over deduped neighbors
    (ncc.rs:767-778), and the total processing span (ncc.rs:781-784) — all on
    stderr.
    """
    t0 = time.perf_counter()
    anchor_f32 = np.float32(anchor_threshold)
    keep_y = {h.y for h in all_hits if np.float32(h.similarity) >= anchor_f32}
    hits = [h for h in all_hits if h.y in keep_y]
    if not hits:
        if verbose:
            print(f"processing took {int((time.perf_counter() - t0) * 1000)}ms", file=sys.stderr)
        return []

    hits.sort(key=lambda m: m.y)  # stable, like Rust sort_by_key
    if verbose:
        for h in hits:
            print(f"{h.y} {h!r}", file=sys.stderr)
    line_slices = partition_by(hits, lambda a, b: a.y == b.y)
    lines: list[list[MatchWithLetter]] = []
    for i, j in line_slices:
        line = sorted(hits[i:j], key=lambda m: m.x)  # stable
        dup_slices = partition_by(line, lambda a, b: abs(a.x - b.x) <= overlap)
        dedup: list[MatchWithLetter] = []
        for di, dj in dup_slices:
            best = line[di]
            best_sim = np.float32(best.similarity)
            for m in line[di + 1 : dj]:
                sim = np.float32(m.similarity)
                if sim >= best_sim:  # last max wins (Rust max_by semantics)
                    best, best_sim = m, sim
            dedup.append(best)
        if verbose:
            dx_counts: dict[int, int] = {}
            for a, b in zip(dedup, dedup[1:]):
                dx = b.x - a.x
                dx_counts[dx] = dx_counts.get(dx, 0) + 1
            print(dx_counts, file=sys.stderr)
        lines.append(dedup)
    if verbose:
        print(f"processing took {int((time.perf_counter() - t0) * 1000)}ms", file=sys.stderr)
    return lines


def _run_winners(lkey: np.ndarray, lsim: np.ndarray, ov: int, N: int) -> np.ndarray:
    """Winner index per overlap run over the composite-key-sorted hits:
    partition_by's run-anchored split + last-max-wins selection
    (ncc.rs:753-766, 1036-1052). Native C single pass when the toolchain is
    available; the vectorized NumPy formulation otherwise (identical output,
    pinned by tests/test_post.py)."""
    try:
        from focr_jax.native import ncc_cpu

        if ncc_cpu.available():
            return ncc_cpu.post_winners(lkey, lsim, ov)
    except Exception:  # noqa: BLE001 - toolchain missing: degrade gracefully
        pass
    # run partition anchored at each run's FIRST element (partition_by
    # semantics): jump pointers nxt[i] = end of a run starting at i, in one
    # vectorized searchsorted over the composite key. A run always contains
    # its anchor, so nxt >= i+1 — also what partition_by yields for negative
    # overlap (every hit its own run), where a raw searchsorted would return
    # nxt <= i and loop forever.
    nxt = np.maximum(
        np.searchsorted(lkey, lkey + ov, side="right"),
        np.arange(1, N + 1),
    )
    run_starts = []
    nxt_l = nxt.tolist()  # python ints: the jump loop is inherently serial
    r = 0
    while r < N:
        run_starts.append(r)
        r = nxt_l[r]
    rs = np.array(run_starts, dtype=np.int64)
    # last max per run: max value via reduceat, then the LAST index
    # attaining it (Rust max_by keeps the last maximal element)
    run_max = np.maximum.reduceat(lsim, rs) if len(rs) else np.zeros(0, np.float32)
    run_of = np.repeat(np.arange(len(rs)), np.diff(np.append(rs, N)))
    at_max = lsim == run_max[run_of]
    return (
        np.maximum.reduceat(np.where(at_max, np.arange(N), -1), rs)
        if len(rs)
        else np.zeros(0, np.int64)
    )


def _winner_arrays(hs, anchor_threshold: float, overlap: int):
    """Shared vectorized core of process_hits on HitStruct arrays: anchor
    filter, stable y/x sorts, run-anchored overlap partition, last-max dedup.

    Returns None when no hits survive, else winner arrays
    ``(wnid, wx, wy, wsim, line_bounds)`` in final output order, where
    ``line_bounds`` are the split points between text lines."""
    anchor_f32 = np.float32(anchor_threshold)
    y = hs.y
    if len(y) == 0:
        return None
    # anchor filter via a dense y lookup table: O(N) instead of the
    # unique+isin sort pair (reference coords are u16, ncc.rs:66-72, so the
    # table is at most 64KB of bools)
    tab = np.zeros(int(y.max()) + 1, dtype=bool)
    tab[y[hs.sim >= anchor_f32]] = True
    keep = tab[y]
    if not keep.any():
        return None
    y = y[keep]
    x = hs.x[keep]
    sim = hs.sim[keep]
    nid = hs.needle_id[keep]
    N = len(y)

    # ONE stable radix sort on the composite (y, x) key — lexicographic plus
    # stability is exactly "stable sort by y, then stable per-line sort by x"
    # (the reference's two sort_by_key passes, ncc.rs:741, 753). The x field
    # is wide enough that x + overlap can never carry into the y field, so
    # the same key drives the overlap-run partition below without runs ever
    # crossing a line boundary.
    xmax = int(x.max())
    # any overlap beyond the page's x span behaves identically (every |Δx|
    # is <= xmax), so clamp before sizing the key field — an absurd CLI
    # --overlap must not overflow the i64 key
    ov = min(int(overlap), xmax + 1)
    xbits = max(17, (xmax + max(ov, 0) + 2).bit_length())
    key = (y.astype(np.int64) << xbits) + x.astype(np.int64)

    try:
        from focr_jax.native import ncc_cpu

        if ncc_cpu.available():
            # fused native path: stable radix sort + winner scan in one C
            # call over the UNSORTED hits, returning winners' original
            # indices in run order — skips the comparison argsort and the
            # five full-array gathers below (identical output, pinned by
            # tests/test_post.py::test_winner_arrays_native_matches_numpy)
            widx = ncc_cpu.post_sort_winners(key, sim, ov)
            wy = y[widx]
            line_bounds = np.flatnonzero(np.diff(wy)) + 1
            return nid[widx], x[widx], wy, sim[widx], line_bounds
    except Exception:  # noqa: BLE001 - toolchain missing: degrade gracefully
        pass

    order = np.argsort(key, kind="stable")
    lkey, lx, lsim, lnid, lyy = (
        key[order], x[order], sim[order], nid[order], y[order]
    )

    bounds = np.flatnonzero(np.diff(lyy)) + 1
    starts = np.concatenate([[0], bounds, [N]]).astype(np.int64)
    line_of = np.repeat(np.arange(len(starts) - 1), np.diff(starts))

    widx = _run_winners(lkey, lsim, ov, N)
    win_line = line_of[widx] if len(widx) else np.zeros(0, np.int64)
    line_bounds = np.flatnonzero(np.diff(win_line)) + 1
    return lnid[widx], lx[widx], lyy[widx], lsim[widx], line_bounds


def process_hits_struct(hs, anchor_threshold: float, overlap: int) -> list[list[MatchWithLetter]]:
    """Array-form process_hits (models/ncc.py::HitStruct input) — identical
    semantics to process_hits, vectorized (see _winner_arrays), and
    MatchWithLetter objects are built only for the surviving line hits
    (dense pages have ~10x more raw hits than survivors)."""
    w = _winner_arrays(hs, anchor_threshold, overlap)
    if w is None:
        return []
    wnid, wx, wy, wsim, line_bounds = w
    # winner assembly, vectorized: gather every surviving hit's fields as
    # arrays, convert to python scalars in bulk (.tolist() — per-element
    # numpy indexing dominated this loop on dense pages), then slice into
    # lines by the precomputed boundaries
    letters, nws, nhs = _needle_tables(hs.matcher)
    cols = zip(
        letters[wnid].tolist(),
        wx.tolist(),
        wy.tolist(),
        nws[wnid].tolist(),
        nhs[wnid].tolist(),
        wsim.astype(np.float64).tolist(),
    )
    flat = [MatchWithLetter(*row) for row in cols]
    lines: list[list[MatchWithLetter]] = []
    prev = 0
    for b in [*line_bounds.tolist(), len(flat)]:
        lines.append(flat[prev:b])
        prev = b
    return lines


def process_hits_text(hs, anchor_threshold: float, overlap: int) -> list[str]:
    """Text-only process_hits: each output line is the concatenation of the
    surviving hits' letters (exactly what the reference prints for non---csv
    runs, ncc.rs:868-877) — no per-hit objects are materialized, which is the
    dominant post-processing cost on dense pages (~4k winners/page)."""
    w = _winner_arrays(hs, anchor_threshold, overlap)
    if w is None:
        return []
    wnid, _, _, _, line_bounds = w
    letters, _, _ = _needle_tables(hs.matcher)
    s = "".join(letters[wnid].tolist())
    out: list[str] = []
    prev = 0
    for b in [*line_bounds.tolist(), len(s)]:
        out.append(s[prev:b])
        prev = b
    return out


def line_matches_truth(got: str, want: str) -> bool:
    """True when ``got`` equals ``want`` up to EXTRA copies of a char inside
    an existing run of that char.

    With x-bits > 0, periodic glyphs legitimately emit anchor-quality
    subpixel hits more than ``overlap`` px apart, and the reference's
    run-anchored dedup keeps both — '===' can decode as '====' on every
    engine including the reference (pinned by tests/test_ncc_engine.py::
    test_subpixel_duplicate_chars_are_reference_semantics). Truth-text
    harnesses (bench.py, tools/soak.py) use this as their acceptance
    rule; engine-vs-engine comparisons must stay bit-exact and NOT use it."""
    from itertools import groupby

    gr = [(c, sum(1 for _ in g)) for c, g in groupby(got)]
    wr = [(c, sum(1 for _ in g)) for c, g in groupby(want)]
    return len(gr) == len(wr) and all(
        gc == wc and gn >= wn for (gc, gn), (wc, wn) in zip(gr, wr)
    )


def _needle_tables(matcher) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-needle (letter, nw, nh) lookup arrays, cached on the matcher."""
    tables = getattr(matcher, "_post_tables", None)
    if tables is None:
        needles = matcher.needles
        tables = (
            np.array([nd.letter for nd in needles]),
            np.array([nd.pixels.shape[1] for nd in needles], dtype=np.int64),
            np.array([nd.pixels.shape[0] for nd in needles], dtype=np.int64),
        )
        matcher._post_tables = tables
    return tables
