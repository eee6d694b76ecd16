"""The ncc template matcher.

Replaces the reference's per-needle AVX2 sweep (Searcher + ncc.cpp, SURVEY.md
§3.2) with one device pass per needle-size group computing ALL letters ×
subpixel offsets simultaneously, then an exact host-side f64 replay of the
similarity decision per candidate (the device works in f32/i32; the
candidate integers are exact, so the replay is bit-identical to
ncc.cpp:206-247).

Per page:
  invert -> [per size group] GEMM-correlate bank + window stats + ε-thresholded
  candidate compaction (ops/ncc.py) -> host f64 accept/reject + MAX_MATCHES
  scan-order cap (ncc.cpp:222-229) -> hits in reference iteration order
  (offsets outer, letters inner — ncc.rs:587-655) -> process_hits
  (models/post.py).
"""

from __future__ import annotations

import functools
import os
import sys
import threading
import time
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from focr_jax.fonts.bank import Needle, build_needles
from focr_jax.fonts.ft import Face
from focr_jax.models.types import MAX_MATCHES, BoxSize, MatchWithLetter, RenderOptions
from focr_jax.ops import ncc as ncc_ops
from focr_jax.ops import packimg

_CAP = MAX_MATCHES + 1024  # per-needle candidate capacity (ε superset)

_EMPTY = (
    np.zeros(0, np.int64),
    np.zeros(0, np.int64),
    np.zeros(0, np.float32),
)


def _matches_to_arrays(ms) -> tuple:
    """Host-searcher Match objects -> (xs, ys, sims) arrays."""
    if not ms:
        return _EMPTY
    return (
        np.array([m.x for m in ms], dtype=np.int64),
        np.array([m.y for m in ms], dtype=np.int64),
        np.array([m.similarity for m in ms], dtype=np.float32),
    )


@dataclass(frozen=True)
class HitStruct:
    """Array-of-hits form of get_hits output (reference iteration order) —
    the allocation-free fast path for post-processing big corpora."""

    needle_id: np.ndarray  # i32 [N] index into matcher.needles
    x: np.ndarray  # i64 [N]
    y: np.ndarray  # i64 [N]
    sim: np.ndarray  # f32 [N]
    matcher: "NccMatcher"

    def __len__(self) -> int:  # pragma: no cover - trivial
        return len(self.x)

    def to_objects(self) -> list[MatchWithLetter]:
        # delegate the per-hit construction (the bit-parity surface: letter,
        # w/h, float coercion) to the single implementation
        out: list[MatchWithLetter] = []
        i = 0
        N = len(self.x)
        while i < N:  # hits are grouped by needle (reference iteration order)
            j = i
            nid = self.needle_id[i]
            while j < N and self.needle_id[j] == nid:
                j += 1
            out.extend(
                self.matcher._needle_objects(
                    int(nid), (self.x[i:j], self.y[i:j], self.sim[i:j])
                )
            )
            i = j
        return out


def _wave_size() -> int | None:
    """Explicit FOCR_NCC_WAVE override, else None (callers auto-size)."""
    env = os.environ.get("FOCR_NCC_WAVE")
    return int(env) if env else None


@functools.lru_cache(maxsize=1)
def _hbm_budget() -> int:
    """Device memory budget for sizing dispatch waves: 45% of the default
    device's reported capacity, which leaves room for the uploads, outputs
    and waves in flight beside the planes _page_bytes counts. Falls back to
    4 GB when the backend reports no stats (the CPU backend)."""
    try:
        stats = jax.local_devices()[0].memory_stats() or {}
        lim = stats.get("bytes_limit") or stats.get("bytes_reservable_limit")
        if lim:
            return int(int(lim) * 0.45)
    except Exception:  # noqa: BLE001 - stats are best-effort on every backend
        pass
    return 4 << 30


def _page_bytes(grp, H: int, W: int) -> int:
    """Device bytes one page's ncc_candidates call holds for ``grp`` at its
    peak (ops/ncc.py): per window position the bf16 im2col column (2·n),
    and per needle the f32 GEMM output (twice under the nibble split), the
    i32 acc and key planes, and top_k's negated key plus its workspace."""
    n = grp.nh * grp.nw
    split = 1 if n * 65025 < 2**24 else 2
    positions = (H - grp.nh + 1) * (W - grp.nw + 1)
    return positions * (2 * n + len(grp.needle_ids) * (4 * split + 4 + 4 + 8))


def _ink_crop(inv: np.ndarray, H: int, W: int, groups) -> tuple | None:
    """Ink-bbox crop (y0, x0, Hc, Wc) for a stacked inverted wave [*, H, W].

    Hits require a window with Σp > 0, and every such window lies within the
    ink bounding box expanded by one needle size: windows at local x=1/y=1
    then map exactly to the leftmost/topmost possible inked full-page
    windows, and the excluded local x=0/y=0 columns are provably Σp == 0 —
    or the reference's own x=0/y=0 exclusion when the crop hits the page
    edge (ncc.cpp:98). This is a device candidate FILTER: per the bit-parity
    invariant, widening it is safe, narrowing it is a correctness bug — keep
    the wave and sharded paths on this single implementation. Dims round up
    to 64 to bound compiled shapes. Returns None for a blank (all-white)
    wave: zero candidates everywhere, skip the device entirely.
    """
    sweepable = [g for g in groups if g.nh < H and g.nw < W]
    if not sweepable:
        return (0, 0, H, W)
    rows_ink = inv.any(axis=(0, 2))
    if not rows_ink.any():
        return None
    cols_ink = inv.any(axis=(0, 1))
    nz_r = np.flatnonzero(rows_ink)
    nz_c = np.flatnonzero(cols_ink)
    nh_m = max(g.nh for g in sweepable)
    nw_m = max(g.nw for g in sweepable)
    y0 = max(0, int(nz_r[0]) - nh_m)
    x0 = max(0, int(nz_c[0]) - nw_m)
    y1 = min(H, int(nz_r[-1]) + 1 + nh_m)
    x1 = min(W, int(nz_c[-1]) + 1 + nw_m)
    Hc = min(H - y0, -(-(y1 - y0) // 64) * 64)
    Wc = min(W - x0, -(-(x1 - x0) // 64) * 64)
    return (y0, x0, Hc, Wc)


def _host_searcher(page: np.ndarray):
    """Fastest available exact host searcher: native C++ kernel, else oracle."""
    try:
        from focr_jax.native.ncc_cpu import NativeSearcher

        return NativeSearcher(page)
    except Exception:  # noqa: BLE001 - toolchain missing: degrade gracefully
        from focr_jax.oracle.ncc_oracle import Searcher

        return Searcher(page)


@dataclass(frozen=True)
class _Group:
    nh: int
    nw: int
    needle_ids: list[int]  # indices into the needle list, original order
    bank: np.ndarray  # [T, nh, nw] u8
    s_n: np.ndarray  # [T] i64
    s2_n: np.ndarray  # [T] i64


def _group_needles(needles: list[Needle]) -> list[_Group]:
    groups: dict[tuple[int, int], list[int]] = {}
    for i, nd in enumerate(needles):
        groups.setdefault(nd.pixels.shape, []).append(i)
    out = []
    for (nh, nw), ids in groups.items():
        out.append(
            _Group(
                nh=nh,
                nw=nw,
                needle_ids=ids,
                bank=np.stack([needles[i].pixels for i in ids]),
                s_n=np.array([needles[i].s_n for i in ids], dtype=np.int64),
                s2_n=np.array([needles[i].s2_n for i in ids], dtype=np.int64),
            )
        )
    return out


def exact_similarities(
    acc: np.ndarray, sp: np.ndarray, s2p: np.ndarray, s_n: int, s2_n: int, n: int
) -> np.ndarray:
    """The reference's f64 similarity, computed from exact integers.

    Mirrors ncc.cpp:233-238 (and the precompute ncc.rs:306-312):
      rnorm_p = 1/sqrt(s2p - sp*sp/n)        [division by n]
      num     = acc - (s_n*s_p) * (1/n)      [multiplication by 1/n]
      sim     = num * (rnorm_n * rnorm_p)
    """
    nf = np.float64(n)
    n_recip = np.float64(1.0) / nf
    s_n64 = np.asarray(s_n, dtype=np.float64)  # scalar or per-candidate array
    s2_n64 = np.asarray(s2_n, dtype=np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        rnorm_n = np.float64(1.0) / np.sqrt(s2_n64 - s_n64 * s_n64 / nf)
        norm_p = s2p.astype(np.float64) - (sp.astype(np.float64) * sp.astype(np.float64)) / nf
        rnorm_p = np.float64(1.0) / np.sqrt(norm_p)
        num = acc.astype(np.float64) - (s_n64 * sp.astype(np.float64)) * n_recip
        return num * (rnorm_n * rnorm_p)


class NccMatcher:
    """One (font, size, alphabet, offsets, box policy) matching configuration."""

    def __init__(
        self,
        face: Face,
        alphabet: str,
        ropts: RenderOptions,
        box_size: BoxSize = BoxSize.ALPHABET,
        x_bits: int = 0,
        y_bits: int = 0,
        padding: tuple[int, int] = (0, 0),
        threshold: float = 0.8,
    ):
        import focr_jax

        focr_jax.enable_compile_cache()
        self.face = face
        self.alphabet = alphabet
        self.ropts = ropts
        self.threshold = float(threshold)
        self.needles = build_needles(face, alphabet, ropts, box_size, x_bits, y_bits, padding)
        self.groups = _group_needles(self.needles)
        # needles whose candidates overflowed _CAP and were searched on the
        # host instead (collect runs on several threads, hence the lock)
        self.n_host_overflow = 0
        self._count_lock = threading.Lock()
        # device-resident per-group constants (bank, s_n, s2_n, threshold),
        # uploaded once and reused for every page
        self._dev_groups: list[tuple] | None = None
        # keyed by the Mesh VALUE (hash = devices + axis names), not id():
        # a GC'd mesh whose address a fresh, different mesh reuses must MISS
        # here, and two equal meshes sharing one compiled fn is correct.
        self._sharded_fns: dict[tuple, object] = {}  # (mesh, group, chunk) -> fn
        self._last_depth = 2  # final pipeline depth of the last corpus run

    def _pages_in_budget(self, shapes) -> int:
        """Pages whose per-page device planes (_page_bytes of the largest
        group at the largest of ``shapes``) fit _hbm_budget together: 8 at
        most, else the largest of {4, 2, 1} that fits — the page-axis
        padding steps of _dispatch_wave, so a padded batch stays within the
        bound too."""
        per = max(
            (
                _page_bytes(g, H, W)
                for H, W in shapes
                for g in self.groups
                if g.nh < H and g.nw < W
            ),
            default=0,
        )
        fit = _hbm_budget() // per if per else 8
        if fit >= 8:
            return 8
        return 4 if fit >= 4 else 2 if fit >= 2 else 1

    def _wave_for(self, pages: list[np.ndarray]) -> int:
        """Pages per dispatch wave: 8 (small waves keep the pipeline's
        fill and drain short while the per-wave dispatch cost stays
        amortized), shrunk by the memory model for every page shape in the
        corpus — _dispatch_wave buckets by shape WITHIN a wave, so sizing
        from pages[0] alone could overshoot on a later, taller bucket.
        FOCR_NCC_WAVE overrides."""
        env = _wave_size()
        if env is not None:
            return env
        return self._pages_in_budget({p.shape for p in pages})

    def _device_groups(self) -> list[tuple]:
        if self._dev_groups is None:
            thr_j = jnp.asarray(np.float32(self.threshold))
            self._dev_groups = [
                (jnp.asarray(g.bank), jnp.asarray(g.s_n), jnp.asarray(g.s2_n), thr_j)
                for g in self.groups
            ]
        return self._dev_groups

    def get_hits(
        self,
        page: np.ndarray,
        verbose: bool = False,
        raw: bool = False,
        out=None,
        sync: bool = False,
    ) -> list[MatchWithLetter]:
        """Device search + exact host recheck; hits in reference order
        (get_hits, ncc.rs:544-721).

        ``sync``: serialize per-group dispatch with a device fence
        (jax.block_until_ready) so the
        verbose elapsed/ns-per-pixel lines are true wall-clock measurements
        (the reference measures each search, ncc.rs:657-666; the pipelined
        default can only estimate — async device work has no observable
        per-group span). Slower: defeats dispatch pipelining by design."""
        meas: dict | None = {} if sync else None
        d = self._fetch_wave(self._dispatch_wave([page], measure=meas))[0]
        return self._collect_page(d, verbose, raw, out, meas=meas)

    def get_hits_many(
        self, pages: list[np.ndarray], verbose: bool = False, struct: bool = False,
        post=None,
    ):
        """Multi-page pipeline: pages dispatch in waves, a few waves in
        flight ahead of the host replay, so uploads/compute overlap
        collection and dispatch depth stays bounded. Each wave's
        results fetch in ONE device_get transfer (the reference's
        rayon fan-out, ncc.rs:839-847, re-expressed as device-queue
        pipelining).

        ``post``: optional per-page callable applied to each page's hits
        inside the pipeline's worker pool (the reference computes
        process_hits inside the same rayon task as get_hits, ncc.rs:842-845);
        the returned list then holds post(hits) per page. Fusing it here
        overlaps post-processing with the next wave's transfer."""
        import concurrent.futures as cf

        wave = self._wave_for(pages)
        out: list = []
        # three pipeline stages on three threads: a DISPATCH worker does the
        # invert/crop + upload + enqueue (host work that must not serialize
        # with the replay), a FETCH worker blocks on each wave's device_get, and
        # the main thread replays (page-parallel — the exact-f64 replay is
        # C++/NumPy releasing the GIL). Steady-state wall per wave is then
        # max(upload, device, fetch, replay) instead of upload + replay.
        # verbose stays serial: its per-search stderr lines must interleave in
        # reference order.
        with (
            cf.ThreadPoolExecutor(max_workers=1) as dpool,
            cf.ThreadPoolExecutor(max_workers=1) as pool,
            cf.ThreadPoolExecutor(max_workers=4) as cpool,
        ):
            def collect_one(d, verb):
                hits = self._collect_page(d, verb, False, None, struct)
                return post(hits) if post is not None else hits

            def collect_wave(fetched) -> list:
                if verbose:
                    return [collect_one(d, verbose) for d in fetched]
                return list(cpool.map(lambda d: collect_one(d, False), fetched))

            from collections import deque

            # up to `depth` waves in flight beyond the one being collected,
            # so uploads and sweeps of later waves run while a wave's results
            # drain and replay. Bounded so device memory stays bounded.
            # Adaptive unless FOCR_NCC_DEPTH pins it: when a wave's fetch
            # takes 3x the running median (a stalled wave), later waves keep
            # uploading and sweeping behind it, so the pipeline deepens for
            # the rest of the run. Depth changes no compiled shape.
            env_depth = os.environ.get("FOCR_NCC_DEPTH")
            state = {
                "depth": int(env_depth) if env_depth else 3,
                "fixed": bool(env_depth),
                "hist": [],
            }

            def fetch_timed(f):
                disp = f.result()
                t0 = time.perf_counter()
                fetched = self._fetch_wave(disp)
                dt = time.perf_counter() - t0
                h = state["hist"]
                if not state["fixed"] and len(h) >= 2:
                    med = sorted(h)[len(h) // 2]
                    if dt > max(0.5, 3.0 * med) and state["depth"] < 4:
                        state["depth"] += 1
                h.append(dt)
                return fetched

            pending: deque[cf.Future] = deque()
            for s in range(0, len(pages), wave):
                dfut = dpool.submit(self._dispatch_wave, pages[s : s + wave])
                pending.append(pool.submit(fetch_timed, dfut))
                if len(pending) > state["depth"]:
                    out.extend(collect_wave(pending.popleft().result()))
            while pending:
                out.extend(collect_wave(pending.popleft().result()))
            self._last_depth = state["depth"]  # observability + tests
        return out

    def get_hits_many_sharded(
        self, pages: list[np.ndarray], mesh, verbose: bool = False,
        struct: bool = False, post=None,
    ):
        """Multi-chip corpus search: pages batch over the mesh's devices
        (data-parallel, SURVEY.md §2.5/§5.8), one sharded sweep per
        needle-size group; the host replay is unchanged. Bit-identical to
        get_hits_many. Pages must share one shape (caller buckets)."""
        from focr_jax.parallel.decode import make_sharded_ncc_fn
        from focr_jax.parallel.mesh import fetch_global, pages_sharding, put_global

        if not pages:
            return []
        t_dispatch = time.perf_counter()
        H, W = pages[0].shape
        assert all(p.shape == (H, W) for p in pages), "bucket pages by shape first"
        inv = np.empty((len(pages), H, W), np.uint8)
        for k, p in enumerate(pages):
            if p.dtype != np.uint8:
                p = p.astype(np.uint8)
            np.subtract(255, p, out=inv[k])
        B = len(pages)
        # ink-bbox crop (shared _ink_crop derivation — deterministic from
        # the corpus content, so every process computes the identical crop
        # and the global shard shapes agree)
        crop = _ink_crop(inv, H, W, self.groups)
        sweepable = any(g.nh < H and g.nw < W for g in self.groups)
        if crop is None or not sweepable:
            empty_plan = [(g, "empty", None) for g in self.groups]
            return [
                post(h) if post is not None else h
                for b in range(B)
                for h in [self._collect_page(
                    (pages[b], inv[b], empty_plan, t_dispatch, (0, 0, H, W)),
                    verbose, False, None, struct,
                )]
            ]
        y0, x0, Hc, Wc = crop
        inv_c = np.ascontiguousarray(inv[:, y0 : y0 + Hc, x0 : x0 + Wc])
        pad = (-B) % mesh.size
        if pad:
            # pad with zeros = inverted WHITE pages (pad_batch's 255 fill is
            # for un-inverted pages; 255 here would be solid ink and burn a
            # full sweep per filler page)
            inv_p = np.concatenate(
                [inv_c, np.zeros((pad, Hc, Wc), dtype=np.uint8)], axis=0
            )
        else:
            inv_p = inv_c
        inv_j = put_global(inv_p, pages_sharding(mesh))
        # each device sweeps its local pages in chunks that fit the memory
        # model, not all at once: a vmap over the whole local batch would
        # hold every page's [T, H', W'] planes together
        chunk = self._pages_in_budget([(Hc, Wc)])

        group_outs: list[tuple[_Group, str, object]] = []
        for gi, grp in enumerate(self.groups):
            if grp.nh >= H or grp.nw >= W or grp.nh >= Hc or grp.nw >= Wc:
                group_outs.append((grp, "empty", None))
                continue
            # memoized per (mesh, group, chunk): a fresh @jax.jit closure per
            # call would retrace/recompile on every corpus invocation
            key = (mesh, gi, chunk)
            fn = self._sharded_fns.get(key)
            if fn is None:
                fn = make_sharded_ncc_fn(
                    mesh, grp.bank, grp.s_n, grp.s2_n, self.threshold, cap=_CAP,
                    chunk=chunk,
                )
                self._sharded_fns[key] = fn
            group_outs.append((grp, "xla", fn(inv_j)))

        fetched = fetch_global(
            [o for _, k, o in group_outs if o is not None]
        )  # one transfer wave for the whole corpus (multi-host: §5.8 gather)
        it = iter(fetched)
        per_group = [(g, k, next(it) if o is not None else None) for g, k, o in group_outs]

        results = []
        for b in range(B):
            plan = [
                (g, k, None if o is None else tuple(np.asarray(a[b]) for a in o))
                for g, k, o in per_group
            ]
            hits = self._collect_page(
                (pages[b], inv[b], plan, t_dispatch, crop),
                verbose, False, None, struct,
            )
            results.append(post(hits) if post is not None else hits)
        return results

    def _upload_wave(self, inv_up: np.ndarray):
        """Ship one inverted wave [B, Hc, Wc] to the device. FOCR_NCC_PACK=1
        opts into the bit-packed form (ops/packimg.py: mask bits + nonzero
        values, exactly reconstructed on device — parity-neutral by
        construction, ~0.44x of raw bytes on dense text) at the cost of an
        on-device decode. Raw is the default: no measurement has shown the
        upload of a directly attached card to bound this pipeline."""
        if os.environ.get("FOCR_NCC_PACK") != "1":
            return jnp.asarray(inv_up)
        mask, vals = packimg.pack_wave(inv_up)
        pad = packimg.vals_rung(vals.size) - vals.size
        if pad:
            vals = np.pad(vals, (0, pad))
        return packimg.unpack_wave(
            jnp.asarray(mask), jnp.asarray(vals), W=inv_up.shape[2]
        )

    def _dispatch_wave(self, batch: list[np.ndarray], measure=None):
        """Phase 1 for a WHOLE wave of pages: one stacked u8 upload per page
        shape, then one ncc_candidates dispatch per page and size group on
        device-side slices of that upload (the reference fans pages out
        with rayon threads, ncc.rs:839-847).

        ``measure``: optional dict — when given, each group's dispatch is
        serialized with a device fence and measure[(nh, nw)] accumulates its
        wall-clock seconds (the --verbose-sync mode; kills pipelining by
        design). Returns an opaque wave object for _fetch_wave.

        The page axis pads to the next of {1, 2, 4, 8, 16, 24, ...} with
        inverted-white zero pages (Σp == 0 ⇒ zero candidates), bounding both
        the compiled-batch-size count and the padded upload waste."""
        t0 = time.perf_counter()
        by_shape: dict[tuple[int, int], list[int]] = {}
        for i, p in enumerate(batch):
            by_shape.setdefault(p.shape, []).append(i)
        buckets = []
        for (H, W), idxs in by_shape.items():
            B = len(idxs)
            # pad the page axis to {1, 2, 4} then multiples of 8: bounded
            # compiled-shape variants without the 8x upload/sweep tax on
            # single-page calls (get_hits / --verbose-sync measure 1 page)
            Bp = B if B in (1, 2) else 4 if B <= 4 else -(-B // 8) * 8
            # one-pass u8 invert straight into the padded upload buffer
            # (255 - x never underflows for u8 x; an i32 detour would cost
            # two extra 4x-sized passes over the wave)
            inv_pad = np.zeros((Bp, H, W), np.uint8)
            for k, i in enumerate(idxs):
                p = batch[i]
                if p.dtype != np.uint8:  # tolerate wider dtypes (0..255 values)
                    p = p.astype(np.uint8)
                np.subtract(255, p, out=inv_pad[k])
            inv_all = inv_pad[:B]
            # ink-bbox crop (_ink_crop): only the crop is uploaded and
            # swept; candidates map back to full-page coordinates at collect
            # time and the exact replay runs on the FULL page, so bit parity
            # is untouched.
            crop = _ink_crop(inv_pad, H, W, self.groups)
            sweep_any = any(g.nh < H and g.nw < W for g in self.groups)
            if crop is None or not sweep_any:
                plans = [(grp, "empty", None) for grp in self.groups]
                buckets.append((idxs, inv_all, plans, (0, 0, H, W)))
                continue
            y0, x0, Hc, Wc = crop
            inv_up = (
                inv_pad
                if (Hc, Wc) == (H, W)
                else np.ascontiguousarray(inv_pad[:, y0 : y0 + Hc, x0 : x0 + Wc])
            )
            inv_j = self._upload_wave(inv_up)
            if measure is not None:
                # exclude the upload from the first group's measured span
                jax.block_until_ready(inv_j)
            plans = []
            for grp, dev in zip(self.groups, self._device_groups()):
                if grp.nh >= H or grp.nw >= W or grp.nh >= Hc or grp.nw >= Wc:
                    # past the page (reference semantics) or past the crop
                    # (a window overlapping ink cannot fit: Hc >= 2·nh + ink)
                    plans.append((grp, "empty", None))
                    continue
                tg = time.perf_counter()
                bank_j, s_n_j, s2_n_j, thr_j = dev
                outs = [
                    ncc_ops.ncc_candidates(
                        inv_j[k], bank_j, s_n_j, s2_n_j, thr_j,
                        nw=grp.nw, nh=grp.nh, cap=_CAP,
                    )
                    for k in range(B)
                ]
                plans.append((grp, "xla", outs))
                if measure is not None:
                    jax.block_until_ready(outs)
                    key = (grp.nh, grp.nw)
                    measure[key] = measure.get(key, 0.0) + time.perf_counter() - tg
            buckets.append((idxs, inv_all, plans, crop))
        return batch, buckets, t0

    def _fetch_wave(self, wave) -> list:
        """Phase 2 transfer: fetch the wave's device outputs in ONE
        jax.device_get (it issues every copy before blocking), then split
        them into per-page plan tuples for _collect_page."""
        batch, buckets, t0 = wave
        leaves = [
            outs
            for _, _, plans, _ in buckets
            for _, kind, outs in plans
            if kind == "xla"
        ]
        it = iter(jax.device_get(leaves))
        per_page: list = [None] * len(batch)
        for idxs, inv_all, plans, crop in buckets:
            page_plans: list[list] = [[] for _ in idxs]
            for grp, kind, _ in plans:
                fetched = next(it) if kind == "xla" else [None] * len(idxs)
                for pp, o in zip(page_plans, fetched):
                    pp.append((grp, kind, o))
            for k, i in enumerate(idxs):
                per_page[i] = (batch[i], inv_all[k], page_plans[k], t0, crop)
        return per_page

    def _collect_page(
        self, dispatched, verbose: bool, raw: bool, out, struct: bool = False,
        meas: dict | None = None,
    ):
        """Phase 2: fetch one page's device results, replay exact f64.

        ``meas``: per-group measured wall seconds from a sync dispatch
        (--verbose-sync); None = pipelined default, where per-group time is
        unobservable and the page span is attributed by search share."""
        page, inv, plan, t_dispatch, crop = dispatched
        H, W = page.shape
        cy0, cx0, Hc, Wc = crop  # device sweep ran on this ink-bbox crop
        thr_f32 = np.float32(self.threshold)
        thr_f64 = np.float64(thr_f32)

        # verbose timing spans dispatch -> now (device work + transfer are
        # async, so per-group wall time is unobservable; attribute the page
        # span to groups by their share of searches)
        page_elapsed = time.perf_counter() - t_dispatch
        total_searches = max(sum(len(g.needle_ids) for g in self.groups), 1)
        time_label = (
            "measured wall time, split evenly"
            if meas is not None
            else "estimated: page span attributed evenly"
        )

        # per needle: (xs i64[], ys i64[], sims f32[]) — arrays, not objects;
        # MatchWithLetter objects are built only at the API boundary (a dense
        # page has ~26k hits: building objects per hit dominates host time)
        per_needle: dict[int, tuple] = {}
        needle_s: dict[int, float] = {}  # attributed per-search seconds
        t00 = t_dispatch  # the reference's "overall" span starts at get_hits
        oracle_searcher = None
        for grp, kind, outs in plan:
            n = grp.nh * grp.nw
            if kind == "empty":
                for i in grp.needle_ids:
                    per_needle[i] = _EMPTY
                    needle_s[i] = 0.0
                continue
            if meas is not None:
                elapsed = meas.get((grp.nh, grp.nw), 0.0)
            else:
                elapsed = page_elapsed * len(grp.needle_ids) / total_searches
            for i in grp.needle_ids:
                needle_s[i] = elapsed / max(len(grp.needle_ids), 1)
            idx, acc, sp, s2p, counts = (np.asarray(o) for o in outs)
            W2 = Wc - grp.nw  # the sweep ran on the crop; remap below
            cap_eff = idx.shape[1]
            for ti, i in enumerate(grp.needle_ids):
                nd = self.needles[i]
                if counts[ti] > cap_eff:
                    if grp.nw > 16:
                        # host kernels cap at 16-px needles (the reference
                        # panics there, ncc.rs:392); re-run this needle's
                        # sweep on DEVICE with a cap sized to its count
                        per_needle[i] = self._redo_wide(grp, ti, nd, inv, int(counts[ti]))
                        continue
                    # candidate overflow (pathological): this needle is
                    # searched on the host (native C++ kernel when the
                    # toolchain is available, NumPy oracle otherwise — both
                    # bit-identical), and counted so no run hides it
                    with self._count_lock:
                        self.n_host_overflow += 1
                    if oracle_searcher is None:
                        oracle_searcher = _host_searcher(page)
                    ms = oracle_searcher.search(nd.pixels, self.threshold)
                    per_needle[i] = _matches_to_arrays(ms)
                    continue
                k = int(counts[ti])
                cand = slice(0, min(k, cap_eff))
                sim = exact_similarities(
                    acc[ti, cand], sp[ti, cand], s2p[ti, cand],
                    int(grp.s_n[ti]), int(grp.s2_n[ti]), n,
                )
                keep = (sim != np.inf) & (sim > thr_f64)
                lins = idx[ti, cand][keep].astype(np.int64)
                sims = sim[keep]
                if len(lins) >= MAX_MATCHES:
                    print(f"WARN got >= {MAX_MATCHES} matches", file=sys.stderr)
                lins_t = lins[:MAX_MATCHES]
                per_needle[i] = (
                    cx0 + 1 + lins_t % W2,
                    cy0 + 1 + lins_t // W2,
                    sims[:MAX_MATCHES].astype(np.float32),
                )
            if verbose:
                per_search_ms = elapsed * 1000.0 / max(len(grp.needle_ids), 1)
                ns_per_px = elapsed * 1e9 / (W * H) / max(len(grp.needle_ids), 1)
                print(
                    f"[group {grp.nw}x{grp.nh}] {len(grp.needle_ids)} searches "
                    f"~{per_search_ms:.2f}ms each ({time_label}; "
                    f"{ns_per_px:.2f} ns/pixel)",
                    file=sys.stderr,
                )

        # assemble in reference iteration order (offsets outer, letters inner)
        parts: list[tuple[int, tuple]] = []
        n_hits = 0
        for i, nd in enumerate(self.needles):
            arrs = per_needle.get(i, _EMPTY)
            if verbose:
                # per-search line in the reference's format (ncc.rs:657-666);
                # device work is async so the elapsed fields carry the page
                # span attributed evenly across searches (the group summary
                # above flags the estimate)
                s = needle_s.get(i, 0.0)
                print(
                    f"`{nd.letter}` [{_f32_debug(nd.offset[0])}, {_f32_debug(nd.offset[1])}] "
                    f"needle size {nd.pixels.shape[1]}x{nd.pixels.shape[0]} hits {len(arrs[0])} "
                    f"elapsed {int(s * 1000)}ms ({s * 1e9 / (W * H):.2f} ns/pixel)",
                    file=sys.stderr,
                )
            if raw and out is not None:
                self._print_raw(nd, self._needle_objects(i, arrs), out)
            parts.append((i, arrs))
            n_hits += len(arrs[0])
        if verbose:
            print(f"overall {(time.perf_counter() - t00) * 1000.0:.4f}ms", file=sys.stderr)
            print(f"hits: {n_hits}", file=sys.stderr)
            _print_count_table(
                (self.needles[i].letter, len(arrs[0])) for i, arrs in parts
            )
        if struct:
            return self._make_struct(parts)
        all_hits: list[MatchWithLetter] = []
        for i, arrs in parts:
            all_hits.extend(self._needle_objects(i, arrs))
        return all_hits

    def _needle_objects(self, i: int, arrs: tuple) -> list[MatchWithLetter]:
        nd = self.needles[i]
        nh, nw = nd.pixels.shape
        return [
            MatchWithLetter(nd.letter, int(x), int(y), nw, nh, float(s))
            for x, y, s in zip(*arrs)
        ]

    def _make_struct(self, parts: list[tuple[int, tuple]]) -> "HitStruct":
        sizes = [len(arrs[0]) for _, arrs in parts]
        total = sum(sizes)
        nid = np.repeat(
            np.array([i for i, _ in parts], dtype=np.int32),
            np.array(sizes, dtype=np.int64),
        )
        if total:
            xs = np.concatenate([arrs[0] for _, arrs in parts]).astype(np.int64)
            ys = np.concatenate([arrs[1] for _, arrs in parts]).astype(np.int64)
            sims = np.concatenate([arrs[2] for _, arrs in parts]).astype(np.float32)
        else:
            xs = np.zeros(0, np.int64)
            ys = np.zeros(0, np.int64)
            sims = np.zeros(0, np.float32)
        return HitStruct(needle_id=nid, x=xs, y=ys, sim=sims, matcher=self)

    def _redo_wide(self, grp, ti, nd, inv, count) -> tuple:
        """Re-dispatch ONE needle's sweep with a count-sized cap (exact device
        path; used when candidates overflowed and no host kernel supports the
        needle width). Returns the (xs, ys, sims) array triple. Rounding the
        cap to a power of two bounds recompiles."""
        cap = 1 << max(int(np.ceil(np.log2(count + 1))), 11)
        thr_f64 = np.float64(np.float32(self.threshold))
        idx, acc, sp, s2p, counts = (
            np.asarray(o)
            for o in ncc_ops.ncc_candidates(
                jnp.asarray(inv),
                jnp.asarray(nd.pixels[None]),
                jnp.asarray(grp.s_n[ti : ti + 1]),
                jnp.asarray(grp.s2_n[ti : ti + 1]),
                jnp.asarray(np.float32(self.threshold)),
                nw=grp.nw,
                nh=grp.nh,
                cap=cap,
            )
        )
        assert counts[0] <= cap  # count was measured by the first pass
        n = grp.nh * grp.nw
        cand = slice(0, int(counts[0]))
        sim = exact_similarities(
            acc[0, cand], sp[0, cand], s2p[0, cand],
            int(grp.s_n[ti]), int(grp.s2_n[ti]), n,
        )
        keep = (sim != np.inf) & (sim > thr_f64)
        W2 = inv.shape[1] - grp.nw
        lins = idx[0, cand][keep].astype(np.int64)
        sims = sim[keep]
        if len(lins) >= MAX_MATCHES:
            print(f"WARN got >= {MAX_MATCHES} matches", file=sys.stderr)
        lins_t = lins[:MAX_MATCHES]
        return (
            1 + lins_t % W2,
            1 + lins_t // W2,
            sims[:MAX_MATCHES].astype(np.float32),
        )


    def get_hits_native(
        self, page: np.ndarray, verbose: bool = False, raw: bool = False, out=None
    ) -> list[MatchWithLetter]:
        """All-host execution tier: the C++ kernel sweeps each size group's
        whole needle bank OpenMP-parallel (the native analogue of the
        reference's default C path + rayon fan-out). Same results as the
        device and oracle paths."""
        from focr_jax.native.ncc_cpu import NativeSearcher

        searcher = NativeSearcher(page)
        H, W = page.shape
        per_needle: dict[int, list[MatchWithLetter]] = {}
        needle_s: dict[int, float] = {}  # measured group time, split evenly
        t00 = time.perf_counter()
        for grp in self.groups:
            if grp.nh >= H or grp.nw >= W:
                for i in grp.needle_ids:
                    per_needle[i] = []
                continue
            t0 = time.perf_counter()
            results = searcher.search_many(grp.bank, self.threshold)
            elapsed = time.perf_counter() - t0
            for ti, i in enumerate(grp.needle_ids):
                nd = self.needles[i]
                needle_s[i] = elapsed / max(len(grp.needle_ids), 1)
                per_needle[i] = [
                    MatchWithLetter(nd.letter, m.x, m.y, m.w, m.h, m.similarity)
                    for m in results[ti]
                ]
            if verbose:
                per_search_ms = elapsed * 1000.0 / max(len(grp.needle_ids), 1)
                ns_per_px = elapsed * 1e9 / (W * H) / max(len(grp.needle_ids), 1)
                print(
                    f"[native group {grp.nw}x{grp.nh}] {len(grp.needle_ids)} searches "
                    f"~{per_search_ms:.2f}ms each (group-measured average; "
                    f"{ns_per_px:.2f} ns/pixel)",
                    file=sys.stderr,
                )
        all_hits: list[MatchWithLetter] = []
        for i, nd in enumerate(self.needles):
            hits = per_needle.get(i, [])
            if verbose:
                s = needle_s.get(i, 0.0)
                print(
                    f"`{nd.letter}` [{_f32_debug(nd.offset[0])}, {_f32_debug(nd.offset[1])}] "
                    f"needle size {nd.pixels.shape[1]}x{nd.pixels.shape[0]} hits {len(hits)} "
                    f"elapsed {int(s * 1000)}ms ({s * 1e9 / (W * H):.2f} ns/pixel)",
                    file=sys.stderr,
                )
            if raw and out is not None:
                self._print_raw(nd, hits, out)
            all_hits.extend(hits)
        if verbose:
            print(f"overall {(time.perf_counter() - t00) * 1000.0:.4f}ms", file=sys.stderr)
            print(f"hits: {len(all_hits)}", file=sys.stderr)
            _print_char_counts(all_hits)
        return all_hits

    def get_hits_oracle(
        self, page: np.ndarray, verbose: bool = False, raw: bool = False, out=None
    ) -> list[MatchWithLetter]:
        """Host-only differential-oracle path (the reference's --rust flag,
        ncc.rs:532-533, 651-655): NumPy Searcher per needle, same results.
        Used by tests and the CLI's --rust to cross-check the device path."""
        from focr_jax.oracle.ncc_oracle import Searcher

        t00 = time.perf_counter()
        searcher = Searcher(page)
        all_hits: list[MatchWithLetter] = []
        for nd in self.needles:
            nh, nw = nd.pixels.shape
            H, W = page.shape
            if nh >= H or nw >= W:
                hits: list[MatchWithLetter] = []
            else:
                t0 = time.perf_counter()
                ms = searcher.search(nd.pixels, self.threshold)
                elapsed = time.perf_counter() - t0
                hits = [
                    MatchWithLetter(nd.letter, m.x, m.y, m.w, m.h, m.similarity) for m in ms
                ]
                if verbose:
                    print(
                        f"`{nd.letter}` [{_f32_debug(nd.offset[0])}, {_f32_debug(nd.offset[1])}] "
                        f"needle size {nw}x{nh} hits {len(hits)} elapsed "
                        f"{int(elapsed * 1000)}ms ({elapsed * 1e9 / (W * H):.2f} ns/pixel)",
                        file=sys.stderr,
                    )
            if raw and out is not None:
                self._print_raw(nd, hits, out)
            all_hits.extend(hits)
        if verbose:
            print(f"overall {(time.perf_counter() - t00) * 1000.0:.4f}ms", file=sys.stderr)
            print(f"hits: {len(all_hits)}", file=sys.stderr)
            _print_char_counts(all_hits)
        return all_hits

    def _print_raw(self, nd: Needle, hits: list[MatchWithLetter], out) -> None:
        """The 11-field --raw CSV per hit (ncc.rs:683-698)."""
        m = self.face.metrics
        to_px = np.float32(1.0) / np.float32(m.units_per_em) * np.float32(self.ropts.size)
        gid = self.face.glyph_for_char(nd.letter)
        tb = self.face.typographic_bounds(gid).scale(float(to_px))
        bearing_x = np.float32(tb.x0)
        for h in hits:
            cx, cy = h.center
            print(
                f"{ord(nd.letter)},{_f32(cx)},{_f32(cy)},{h.x},{h.y},{h.w},{h.h},"
                f"{_f32(bearing_x)},{_f32(nd.corrected_offset[1])},"
                f"{_f32(nd.offset[0])},{_f32(nd.offset[1])}",
                file=out,
            )


def _print_char_counts(all_hits: list[MatchWithLetter]) -> None:
    """Per-char hit totals from hit objects (ncc.rs:709-718)."""
    _print_count_table((h.letter, 1) for h in all_hits)


def _print_count_table(letter_counts) -> None:
    """Per-char totals, sorted by (count, char), zeros skipped
    (ncc.rs:709-718)."""
    counts: dict[str, int] = {}
    for letter, k in letter_counts:
        if k:
            counts[letter] = counts.get(letter, 0) + k
    for letter, count in sorted(counts.items(), key=lambda kv: (kv[1], kv[0])):
        print(f"`{letter}` {count}", file=sys.stderr)


def _f32(v) -> str:
    """Rust `{}` Display for f32: shortest round-trip, no trailing .0."""
    return np.format_float_positional(np.float32(v), unique=True, trim="-")


def _f32_debug(v) -> str:
    """Rust `{:?}` Debug for f32: shortest round-trip, keeps one decimal."""
    return np.format_float_positional(np.float32(v), unique=True, trim="0")
