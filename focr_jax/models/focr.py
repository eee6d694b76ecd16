"""The focr grid decoder.

Replaces the reference's per-page sequential decode
(decode_image/decode_line/score_glyph, main.rs:87-239) with one batched,
jitted kernel per page-shape bucket:

  pages [B, H, W] u8
    -> invert (255 - x)                        (main.rs:150)
    -> gather line strips at the static row grid
    -> gather per-cell windows
    -> exact-integer SSD argmin over the template bank (ops/ssd.py)
    -> ids [B, R, C] i32 + all-white row mask  (main.rs:208-211)

Host-side assembly applies the row-loop semantics (white skip, bottom stop)
and maps glyph ids back to characters. Monospace fonts take this fast path
(the cursor grid is static, SURVEY.md §2.5); proportional fonts take the
lax.scan sequential device decoder (models/focr_prop.py — bit-exact, batched
across every line of the batch). Fonts with degenerate metrics
(non-positive advances) decode on the host oracle instead, and
GridDecoder.n_host_pages counts every page that did.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from focr_jax.fonts.bank import GridBank, build_grid_bank, is_monospace
from focr_jax.fonts.ft import Face
from focr_jax.models.types import DecodedLine, DecodeOptions, RenderOptions
from focr_jax.ops import ssd
from focr_jax.oracle import focr_oracle


@dataclass(frozen=True)
class _RowGroup:
    crop_h: int
    ys: tuple[int, ...]  # page-space y of each row in this group, ascending


def _row_groups(dopts: DecodeOptions, H: int) -> list[_RowGroup]:
    """Rows of the scan grid grouped by crop height (partial bottom rows get
    their own group). Mirrors the crop clamp of image::crop_imm
    (main.rs:199-207)."""
    groups: dict[int, list[int]] = {}
    i = 0
    while True:
        y = dopts.y_start + i * dopts.line_advance
        i += 1
        ch = min(dopts.line_height, H - min(y, H))
        if ch <= 0:
            break
        groups.setdefault(ch, []).append(y)
    return [_RowGroup(crop_h=ch, ys=tuple(ys)) for ch, ys in sorted(groups.items(), reverse=True)]


def make_strip_forward(bank: GridBank):
    """[B, R, crop_h, crop_w] u8 strips -> (ids, white): the single-chip fast
    path. Strips are cropped on the HOST so only scan-rectangle bytes are
    uploaded (~33% of a page for the canonical grid)."""
    tmpl = jnp.asarray(bank.templates)
    tsq = jnp.asarray(bank.tsq)
    win_w = bank.win_w
    wx0 = bank.wx0

    def fn(strips: jax.Array):
        inv = 255 - strips.astype(jnp.int32)  # [B, R, h, crop_w]
        white = jnp.max(inv, axis=(2, 3)) == 0
        wins = ssd.extract_windows(inv, wx0, win_w)
        metric = ssd.ssd_metric(wins, tmpl, tsq)
        ids = ssd.argmin_glyph(metric)
        if bank.n_glyphs <= 255:
            ids = ids.astype(jnp.uint8)
        return ids, white

    return fn


def crop_strips(
    pages: np.ndarray, ys: tuple[int, ...], crop_h: int, x0: int, crop_w: int,
    out: np.ndarray | None = None,
):
    """Host-side scan-rectangle crop: [B, H, W] -> [B, R, crop_h, crop_w] u8.

    Rows whose rectangle hangs past the page bottom are white-padded — the
    caller only passes ys whose crop height equals crop_h (see _row_groups),
    so padding never actually materializes for grouped rows. ``out`` lets the
    caller fill a view of a preallocated buffer (one copy instead of two on
    the throughput path)."""
    B, H, W = pages.shape
    if out is None:
        out = np.empty((B, len(ys), crop_h, crop_w), dtype=np.uint8)
    for ri, y in enumerate(ys):
        h = min(crop_h, H - y)
        out[:, ri, :h] = pages[:, y : y + h, x0 : x0 + crop_w]
        if h < crop_h:
            out[:, ri, h:] = 255
    return out


def make_grid_forward(bank: GridBank, ys: tuple[int, ...], x0: int):
    """Build the pure [B,H,W] -> (ids [B,R,C], white [B,R]) forward function
    (un-jitted; the flagship compute step exported via __graft_entry__)."""
    tmpl = jnp.asarray(bank.templates)  # [C,G,h,win]
    tsq = jnp.asarray(bank.tsq)  # [C,G]
    win_w = bank.win_w
    crop_w, crop_h = bank.crop_w, bank.crop_h
    wx0 = bank.wx0

    def fn(pages: jax.Array):
        inv = 255 - pages.astype(jnp.int32)  # [B,H,W]
        strips = ssd.extract_strips(inv, ys, crop_h, x0, crop_w)  # [B,R,h,crop_w]
        white = jnp.max(strips, axis=(2, 3)) == 0  # all-255 crop ⇔ inverted all-zero
        wins = ssd.extract_windows(strips, wx0, win_w)  # [B,R,C,h,win]
        metric = ssd.ssd_metric(wins, tmpl, tsq)
        ids = ssd.argmin_glyph(metric)
        if bank.n_glyphs <= 255:
            ids = ids.astype(jnp.uint8)  # 4x fewer bytes to fetch
        return ids, white

    return fn


class GridDecoder:
    """Batched focr decoder for one (page shape, grid, font) configuration."""

    def __init__(
        self,
        face: Face,
        alphabet: str,
        dopts: DecodeOptions,
        ropts: RenderOptions,
        page_shape: tuple[int, int],
        mesh=None,
    ):
        """mesh: optional jax.sharding.Mesh with a 'pages' (and optionally
        'glyphs') axis — shards the batch across chips (parallel/decode.py).
        None = single-chip jit (identical results either way)."""
        import focr_jax

        focr_jax.enable_compile_cache()
        self.face = face
        self.alphabet = alphabet
        self.dopts = dopts
        self.ropts = ropts
        self.page_shape = page_shape
        self.mesh = mesh if (mesh is not None and mesh.size > 1) else None
        H, W = page_shape
        self.x0 = min(dopts.x_start, W)
        self.crop_w = max(min(dopts.width, W - self.x0), 0)
        self.monospace = is_monospace(face, alphabet, ropts) if alphabet else True
        self._codes = np.array([ord(c) for c in alphabet], dtype=np.uint32)
        self._ascii = bool(alphabet) and max(map(ord, alphabet)) < 128
        self.groups: list[tuple[_RowGroup, object]] = []
        self.prop_groups: list[tuple[_RowGroup, object]] = []
        self._combined_fn = None
        self.banks: list[GridBank] = []  # per-group banks (bench FLOP model)
        self.n_host_pages = 0  # pages decoded by the host oracle, not the device
        if self.crop_w > 0 and self.monospace:
            fwds = []
            for grp in _row_groups(dopts, H):
                bank = build_grid_bank(face, alphabet, ropts, self.crop_w, grp.crop_h)
                self.banks.append(bank)
                if self.mesh is not None:
                    from focr_jax.parallel.decode import make_sharded_grid_fn

                    fn = make_sharded_grid_fn(bank, grp.ys, self.x0, self.mesh)
                else:
                    fn = make_strip_forward(bank)
                    fwds.append(fn)
                self.groups.append((grp, fn))
                self._bank0 = bank
            if self.mesh is None and fwds:
                # ONE jitted call for every row group, taking ONE flat u8
                # buffer (all groups' strips concatenated): a single upload +
                # a single dispatch per batch
                shapes = tuple(
                    (len(grp.ys), grp.crop_h, self.crop_w) for grp, _ in self.groups
                )

                def combined(flat, B, _fwds=tuple(fwds), _shapes=shapes):
                    outs = []
                    off = 0
                    for f, (R, ch, cw) in zip(_fwds, _shapes):
                        sz = B * R * ch * cw
                        outs.append(f(flat[off : off + sz].reshape(B, R, ch, cw)))
                        off += sz
                    return outs

                self._combined_fn = jax.jit(combined, static_argnames=("B",))
        self._stream_fns: dict[int, object] = {}
        if self.crop_w > 0 and not self.monospace and alphabet:
            from focr_jax.fonts.bank import build_prop_bank
            from focr_jax.models.focr_prop import PropDecoder

            try:
                for grp in _row_groups(dopts, H):
                    bank = build_prop_bank(face, alphabet, ropts, grp.crop_h)
                    self.prop_groups.append(
                        (grp, PropDecoder(bank, self.crop_w, mesh=self.mesh))
                    )
            except ValueError:  # non-positive advance: host oracle fallback
                self.prop_groups = []

    def _stream_fn(self, gi: int):
        """Jitted per-row-group strip forward for the streaming single-image
        path (separate from _combined_fn, which fuses all groups into one
        call — streaming wants one dispatch per row chunk instead)."""
        fn = self._stream_fns.get(gi)
        if fn is None:
            # single-chip groups carry the raw make_strip_forward closure
            fn = jax.jit(self.groups[gi][1])
            self._stream_fns[gi] = fn
        return fn

    def decode_batch(self, pages: np.ndarray) -> list[list[DecodedLine]]:
        """pages [B, H, W] u8 -> per-page decoded lines in row order."""
        assert pages.shape[1:] == self.page_shape
        B = pages.shape[0]
        if self.crop_w == 0:
            # zero-width crop: the all-white skip fires on every row
            # (empty-iterator all() == true), so no lines are ever emitted.
            return [[] for _ in range(B)]
        if self.monospace and not self.groups:
            # empty row grid (y_start at/past the page bottom): the
            # reference's row loop breaks immediately (main.rs:205-207)
            return [[] for _ in range(B)]
        if not self.monospace:
            if self.prop_groups:
                return self._decode_prop(pages)
            self.n_host_pages += B
            return [
                focr_oracle.decode_image(p, self.face, self.alphabet, self.dopts, self.ropts)
                for p in pages
            ]
        return self._finish(self._dispatch(pages))

    def _decode_prop(self, pages: np.ndarray) -> list[list[DecodedLine]]:
        """Proportional-font batch decode via the lax.scan device path."""
        B = pages.shape[0]
        inv = (255 - pages.astype(np.int32)).astype(np.uint8)
        per_row: dict[int, tuple[list[str], np.ndarray]] = {}
        for grp, dec in self.prop_groups:
            ch = grp.crop_h
            strips = np.stack(
                [inv[:, y : y + ch, self.x0 : self.x0 + self.crop_w] for y in grp.ys],
                axis=1,
            )  # [B, R, ch, cw]
            white = strips.max(axis=(2, 3)) == 0
            texts = dec.decode_lines(strips.reshape(-1, ch, self.crop_w))
            R = len(grp.ys)
            for ri, y in enumerate(grp.ys):
                per_row[y] = (
                    [texts[b * R + ri] for b in range(B)],
                    white[:, ri],
                )
        out: list[list[DecodedLine]] = []
        for b in range(B):
            lines = []
            for y in sorted(per_row):
                texts, white = per_row[y]
                if not white[b]:
                    lines.append(DecodedLine(text=texts[b], y=int(y)))
            out.append(lines)
        return out

    def _dispatch(self, pages: np.ndarray) -> list:
        """Upload + enqueue the device work for one batch (async dispatch)."""
        n = pages.shape[0]
        if self.mesh is not None:
            from focr_jax.parallel.mesh import pad_batch, pages_sharding, put_global

            pages, _ = pad_batch(pages, self.mesh.size)
            pages_j = put_global(pages, pages_sharding(self.mesh))
            return (n, [fn(pages_j) for _, fn in self.groups])
        # single chip: crop scan strips on host, upload only those bytes as
        # ONE flat buffer (filled in place — no second memcpy), run every row
        # group in one device call
        B = pages.shape[0]
        sizes = [B * len(g.ys) * g.crop_h * self.crop_w for g, _ in self.groups]
        flat = np.empty(sum(sizes), dtype=np.uint8)
        off = 0
        for (grp, _), sz in zip(self.groups, sizes):
            view = flat[off : off + sz].reshape(B, len(grp.ys), grp.crop_h, self.crop_w)
            crop_strips(pages, grp.ys, grp.crop_h, self.x0, self.crop_w, out=view)
            off += sz
        return (n, self._combined_fn(jnp.asarray(flat), B=B))

    def _finish(self, outs) -> list[list[DecodedLine]]:
        """Force one batch's device results and assemble text lines."""
        from focr_jax.parallel.mesh import fetch_global

        n, group_outs = outs
        # one transfer for every group; under multi-host, non-addressable
        # shards come back via the §5.8 gather (fetch_global) instead of a
        # bare device_get that would throw on them
        fetched = fetch_global(group_outs)
        per_row: dict[int, tuple[np.ndarray, np.ndarray]] = {}  # y -> (ids [B,C], white [B])
        for (grp, _), (ids, white) in zip(self.groups, fetched):
            # mesh padding: trim white filler pages back off the batch
            ids, white = ids[:n], white[:n]
            for ri, y in enumerate(grp.ys):
                per_row[y] = (ids[:, ri], white[:, ri])
        ys_sorted = sorted(per_row)
        ids_all = np.stack([per_row[y][0] for y in ys_sorted], axis=1)  # [B, R, C]
        white_all = np.stack([per_row[y][1] for y in ys_sorted], axis=1)  # [B, R]
        return self._assemble(ids_all, white_all, ys_sorted)

    def _assemble(
        self, ids_all: np.ndarray, white_all: np.ndarray, ys_sorted: list[int]
    ) -> list[list[DecodedLine]]:
        """Map glyph ids to text lines, skipping all-white rows
        (main.rs:208-211). Vectorized: the whole batch's ids are translated to
        character codes in one take; ASCII alphabets decode rows via a single
        bytes() pass per page."""
        B = ids_all.shape[0]
        codes = self._codes[ids_all]  # [B, R, C] u32 of unicode codepoints
        ys_arr = np.asarray(ys_sorted)
        out: list[list[DecodedLine]] = []
        for b in range(B):
            keep = ~white_all[b]
            rows = codes[b][keep]
            if self._ascii:
                blob = rows.astype(np.uint8).tobytes().decode("ascii")
                C = rows.shape[1]
                texts = [blob[i * C : (i + 1) * C] for i in range(rows.shape[0])]
            else:
                texts = ["".join(map(chr, r)) for r in rows]
            out.append(
                [DecodedLine(text=t, y=int(y)) for t, y in zip(texts, ys_arr[keep])]
            )
        return out


_DECODER_CACHE: OrderedDict[tuple, GridDecoder] = OrderedDict()
_DECODER_CACHE_MAX = 16


def _cached_decoder(face, alphabet, dopts, ropts, shape, mesh) -> GridDecoder:
    """Reuse GridDecoders across decode_pages calls: a fresh instance would
    re-trace and re-compile its jitted closures even though the template
    banks are disk-cached. LRU-evicted so a
    mixed-shape corpus never drops its hot (dominant-bucket) decoder."""
    # the mesh keys by VALUE (jax.sharding.Mesh hashes devices + axis names):
    # an id() key could silently reuse a decoder compiled for a dead mesh
    # whose address a different mesh later reuses
    key = (face.path, alphabet, dopts, ropts, shape, mesh)
    dec = _DECODER_CACHE.get(key)
    if dec is None:
        dec = GridDecoder(face, alphabet, dopts, ropts, shape, mesh=mesh)
        while len(_DECODER_CACHE) >= _DECODER_CACHE_MAX:
            _DECODER_CACHE.popitem(last=False)  # evict least recently used
        _DECODER_CACHE[key] = dec
    else:
        _DECODER_CACHE.move_to_end(key)
    return dec


def decode_pages(
    pages: list[np.ndarray],
    face: Face,
    alphabet: str,
    dopts: DecodeOptions,
    ropts: RenderOptions,
    batch_size: int = 16,
    mesh=None,
) -> list[list[DecodedLine]]:
    """Decode a heterogeneous page list: bucket by shape, batch, reassemble.

    Replaces the rayon page fan-out (main.rs:442-471); page order is restored
    exactly as the reference's sort-by-index does (main.rs:468). ``mesh``
    shards each batch over a device mesh (multi-chip DP/TP)."""
    from focr_jax.io.images import bucket_pages

    results: list[list[DecodedLine] | None] = [None] * len(pages)
    for bucket in bucket_pages(pages):
        dec = _cached_decoder(face, alphabet, dopts, ropts, bucket.shape, mesh)
        arr = bucket.pages
        for s, decoded in decode_stream(dec, arr, batch_size):
            for j, lines in enumerate(decoded):
                results[bucket.indices[s + j]] = lines
    return results  # type: ignore[return-value]


def decode_single_stream(dec: GridDecoder, page: np.ndarray, rows_per_chunk: int = 16):
    """Yield DecodedLine for ONE page in row order, streaming each row chunk
    as its device results land.

    Mirrors the reference's single-image fast path, which prints every line
    to stdout the moment it is decoded (main.rs:427-440) instead of buffering
    the page. Rows are dispatched in fixed-size chunks (padded with white
    strips, which the all-white skip drops) so every distinct crop height
    compiles exactly once; all chunks are enqueued asynchronously up front and
    fetched in row order, so early lines reach the caller while later rows are
    still in flight. Output is bit-identical to ``decode_batch(page[None])[0]``
    — same kernels, same assembly."""
    if dec.mesh is not None or not dec.monospace or dec.crop_w == 0 or not dec.groups:
        for lines in dec.decode_batch(page[None]):
            yield from lines
        return
    from collections import deque
    from itertools import islice

    def dispatch_chunks():
        for gi, (grp, _) in enumerate(dec.groups):
            jfn = dec._stream_fn(gi)
            for s in range(0, len(grp.ys), rows_per_chunk):
                ys = grp.ys[s : s + rows_per_chunk]
                strips = np.full(
                    (1, rows_per_chunk, grp.crop_h, dec.crop_w), 255, dtype=np.uint8
                )
                crop_strips(
                    page[None], ys, grp.crop_h, dec.x0, dec.crop_w,
                    out=strips[:, : len(ys)],
                )
                yield ys, jfn(jnp.asarray(strips))

    # groups are ordered full-height-first = ascending y (partial rows are at
    # the page bottom), so in-order fetch is row order. Dispatch depth is
    # bounded to a small in-flight window: a pathologically tall page would
    # otherwise enqueue hundreds of chunks up front.
    it = dispatch_chunks()
    pending = deque(islice(it, 8))
    while pending:
        ys, outs = pending.popleft()
        nxt = next(it, None)
        if nxt is not None:
            pending.append(nxt)
        ids, white = jax.device_get(outs)
        yield from dec._assemble(ids[:, : len(ys)], white[:, : len(ys)], list(ys))[0]


def decode_stream(dec: GridDecoder, arr: np.ndarray, batch_size: int):
    """Yield (start_index, decoded_lines) per batch, pipelining the next
    batch's host crop + upload behind the current batch's result fetch +
    assembly (SURVEY.md §7 "Host↔device pipeline")."""
    import concurrent.futures as cf

    if arr.shape[0] == 0:
        return
    if not dec.groups or not dec.monospace or dec.crop_w == 0:
        for s in range(0, arr.shape[0], batch_size):
            yield s, dec.decode_batch(arr[s : s + batch_size])
        return
    starts = list(range(0, arr.shape[0], batch_size))
    with cf.ThreadPoolExecutor(max_workers=1) as pool:
        pending = pool.submit(dec._dispatch, arr[starts[0] : starts[0] + batch_size])
        for i, s in enumerate(starts):
            outs = pending.result()
            if i + 1 < len(starts):
                nxt = starts[i + 1]
                pending = pool.submit(dec._dispatch, arr[nxt : nxt + batch_size])
            yield s, dec._finish(outs)
