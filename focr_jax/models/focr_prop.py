"""Sequential greedy focr decode for proportional fonts — on device.

The reference's cursor advance is data-dependent (main.rs:176-178: the cursor
moves by the CHOSEN glyph's advance), so proportional fonts cannot use the
static-grid batch path. SURVEY.md §7 hard part 4 prescribes the shape
this module implements: a ``lax.scan`` over cursor steps, each step one
batched matmul over the alphabet for EVERY line of every page in the batch
simultaneously — sequential in cells, massively parallel across lines.

Bit-exactness (not an approximation): FreeType quantizes the rasterization
translation to 1/64 px (round(t*64), fonts/ft.py::_to_f26dot6) and pixel
shifts are coverage-exact, so glyph bitmaps at cursor t are the 64-entry
phase bank (fonts/bank.py::PropBank) shifted by round(t*64)//64 px. The scan
replicates the reference's f32 arithmetic op-for-op (pos accumulation,
ox+pos, the pos<w loop bound — all IEEE f32 on any backend; the one
multiply-add, s*64+0.5, is exact with or without FMA contraction because
s*64 is), scores with
exact integer SSD (the ‖I‖²-cancelling expansion of ops/ssd.py), reproduces
canvas edge clipping via per-column ‖T‖² cumsums, and keeps the first-min
tie-break. Property-tested char-for-char against the oracle.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from focr_jax.fonts.bank import PropBank
from focr_jax.ops.ssd import exact_corr_mat


def max_steps(bank: PropBank, crop_w: int) -> int:
    """Upper bound on emitted cells per line (loop runs while pos < w)."""
    min_adv = float(bank.advances.min())
    if min_adv <= 0:
        raise ValueError("non-positive glyph advance: sequential decode would not terminate")
    return int(np.ceil(crop_w / min_adv)) + 1


_CHUNK = 16  # scan steps per early-exit check
_END_ID = 255  # u8 sentinel for "cursor passed the width bound"

# process-wide count of full-buffer refetches (the decode_lines under-guess
# miss path): a slow corpus rep that refetched paid a second fetch of its
# own making (bench.py records the delta per rep)
refetch_total = 0


def make_prop_forward(bank: PropBank, crop_w: int, n_steps: int):
    """Build fn(strips [L, crop_h, crop_w] u8-valued inverted lines) ->
    (ids [n_chunks*_CHUNK, L] u8 glyph ids in step-major order, _END_ID
    sentinel past end-of-line; n_chunks_run i32 — the number of _CHUNK-step
    slices that actually executed before every cursor passed the width
    bound). The caller fetches only the executed prefix ids[:n_chunks_run *
    _CHUNK] — the early-exit typically leaves ~40% of the worst-case buffer
    dead, and fetching it would be wasted transfer.

    Intermediate dtypes are pinned (i32/f32) — the package enables
    jax_enable_x64, and silent i64/f64 promotion would both slow the device
    path and break f32 parity with the reference.

    Two throughput structures (bit-parity unaffected — the per-step math is
    op-identical):
      * the scan runs in _CHUNK-step slices under a while_loop that stops
        once EVERY line's cursor passed the width bound — n_steps is the
        worst case (ceil(w/min_advance)), real text advances ~2x faster, so
        ~40% of the steps never execute;
      * the clipped ‖T‖² is precomputed per FreeType-quantized cursor value
        into a [t64, G] table (t64 = round(64·(ox+pos)) determines both the
        subpixel phase and the canvas clip range), turning the per-step
        [L, G, wbank+1] cumsum gather + two take_along_axis into one [L]-row
        table take.
    """
    G, P, crop_h, wbank = bank.templates.shape
    K = crop_h * wbank
    # u8 ids on the wire: 4x less fetch than i32 (glyph counts are tiny —
    # the reference's alphabets are <= ~80 chars; fail loudly at the bound)
    assert G < _END_ID, f"{G} glyphs exceed the u8 id wire format ({_END_ID - 1})"
    # the i32 score combine (tsq - 2*accp below) is exact only while the
    # worst-case |score| bound 3*K*255^2 fits i32; a larger window with
    # dense ink could silently wrap — fail loudly instead (mirrors the
    # ssd_metric promotion and the colsq_cum assert in fonts/bank.py)
    assert 3 * K * 65025 < 2**31, (
        f"prop window of {K} px exceeds the exact-i32 score bound (11008)"
    )
    tmat = jnp.asarray(bank.templates.reshape(G * P, K))
    adv = jnp.asarray(bank.advances)  # [G] f32
    ox = jnp.float32(bank.ox)
    w_f = jnp.float32(crop_w)

    # ‖T‖² clipped to the canvas, indexed by the quantized cursor t64:
    # k = t64>>6 is the window column, p = t64&63 the subpixel phase, and
    # template cols c are in-canvas iff 0 <= (k - base) + c < crop_w. Cursor
    # values stay < w + max_advance (inactive lines freeze), bounding t64.
    t_cap = int(np.floor((float(bank.ox) + crop_w + float(bank.advances.max()))
                         * 64.0 + 0.5)) + 2
    tks = np.arange(t_cap) >> 6
    tps = np.arange(t_cap) & 63
    tlo = np.clip(bank.base - tks, 0, wbank)
    thi = np.clip(crop_w - tks + bank.base, 0, wbank)
    tsq_tab = jnp.asarray(
        (bank.colsq_cum[:, tps, thi] - bank.colsq_cum[:, tps, tlo]).T
    )  # [t_cap, G] i32

    def fn(strips: jax.Array):
        L = strips.shape[0]
        # zero padding on both sides: windows never go out of bounds, and
        # padded pixels are 0 = inverted white, contributing nothing to I·T
        # (the clipped ‖T‖² handles the T side of canvas clipping exactly)
        pad_r = wbank  # k <= round((ox + w)/1) < w + ox + 1 <= crop_w + base
        strips_p = jnp.pad(
            strips.astype(jnp.uint8),
            ((0, 0), (0, 0), (bank.base, pad_r + int(np.ceil(float(bank.ox))) + 2)),
        )

        def slice_one(st, kk):
            return jax.lax.dynamic_slice(st, (jnp.int32(0), kk), (crop_h, wbank))

        def step(pos, _):
            s = ox + pos  # [L] f32 — same op order as the oracle
            # ties away from zero, matching _to_f26dot6 (s >= 0 here, so
            # floor(x + 0.5); s*64 < 2^23 keeps both ops exact in f32)
            t64 = jnp.floor(s * jnp.float32(64.0) + jnp.float32(0.5)).astype(jnp.int32)
            k = t64 >> 5 >> 1  # floor(t64/64); t64 >= 0 since ox, pos >= 0
            p = t64 & jnp.int32(63)
            start = k  # window col in padded strip = (k - base) + base
            win = jax.vmap(slice_one)(strips_p, start)  # [L, crop_h, wbank]
            acc = exact_corr_mat(win.reshape(L, K), tmat)  # [L, G*P] i32
            accp = jnp.take_along_axis(
                acc.reshape(L, G, P), p[:, None, None].astype(jnp.int32), axis=2
            )[..., 0]  # [L, G]
            tsq = jnp.take(tsq_tab, t64, axis=0)  # [L, G] clipped ‖T‖²
            score = tsq - jnp.int32(2) * accp  # ‖I‖² cancels in the argmin
            g = jnp.argmin(score, axis=1).astype(jnp.int32)  # first minimum
            active = pos < w_f  # the reference loop bound (main.rs:158)
            ids = jnp.where(active, g, jnp.int32(_END_ID)).astype(jnp.uint8)
            pos_next = jnp.where(active, pos + adv[g], pos)
            return pos_next, ids

        n_chunks = -(-n_steps // _CHUNK)

        def body(carry):
            pos, buf, ci = carry
            pos, ids = jax.lax.scan(step, pos, None, length=_CHUNK)
            buf = jax.lax.dynamic_update_slice(buf, ids, (ci * _CHUNK, jnp.int32(0)))
            return pos, buf, ci + jnp.int32(1)

        def cond(carry):
            pos, _, ci = carry
            # stop early once every cursor passed w: the skipped steps would
            # only ever emit the sentinel (what buf is initialized with)
            return (ci < n_chunks) & jnp.any(pos < w_f)

        pos0 = jnp.zeros((L,), jnp.float32)
        buf0 = jnp.full((n_chunks * _CHUNK, L), _END_ID, jnp.uint8)
        _, buf, ci = jax.lax.while_loop(cond, body, (pos0, buf0, jnp.int32(0)))
        return buf, ci

    return fn


class PropDecoder:
    """Device-side sequential decoder for one (crop_h, crop_w) line shape.

    With a mesh, the line batch shards across every device (each line's scan
    is independent, so this is pure data parallelism over the L axis);
    padding lines added for divisibility decode to junk that the [:L] trim
    below discards before any caller sees it."""

    def __init__(self, bank: PropBank, crop_w: int, mesh=None):
        import focr_jax

        focr_jax.enable_compile_cache()
        self.bank = bank
        self.crop_w = crop_w
        self.n_steps = max_steps(bank, crop_w)
        self.mesh = mesh if (mesh is not None and mesh.size > 1) else None
        self._fn = jax.jit(make_prop_forward(bank, crop_w, self.n_steps))
        # fetch-prefix guess (step rows, a POWER-OF-TWO chunk multiple):
        # starts at the full buffer, then tracks the longest observed line +
        # one chunk of margin rounded up to the next power of two — the
        # pow-2 ladder bounds the distinct prefix-slice shapes to
        # log2(n_chunks), and every rung is pre-compiled the first time a
        # buffer shape appears (see decode_lines), so a guess change never
        # lands a fresh compile inside a timed corpus run
        self._n_chunks = -(-self.n_steps // _CHUNK)
        self._guess = self._n_chunks * _CHUNK
        self._warmed: set[tuple] = set()  # buf shapes with the ladder compiled
        self.n_refetches = 0  # full-buffer refetches (under-guess misses)

    def decode_lines(self, strips: np.ndarray) -> list[str]:
        """strips: [L, crop_h, crop_w] INVERTED line crops -> decoded texts."""
        L = strips.shape[0]
        if self.mesh is not None:
            # explicit sharded upload (same pattern as GridDecoder._dispatch):
            # the batch lands pre-split across devices instead of relying on
            # constraint propagation from one chip, and it is the form that
            # works on multi-host meshes
            from focr_jax.parallel.mesh import pages_sharding

            pad = (-L) % self.mesh.size
            if pad:
                strips = np.concatenate(
                    [strips, np.zeros((pad, *strips.shape[1:]), strips.dtype)]
                )
            strips_j = jax.device_put(
                jnp.asarray(strips), pages_sharding(self.mesh)
            )
        else:
            strips_j = jnp.asarray(strips)
        buf, _ci = self._fn(strips_j)  # buf [n_chunks*_CHUNK, Lp] u8 step-major
        # fetch a GUESSED prefix with no synchronous round trip: rows past
        # the executed chunks (and past each line's end) are _END_ID-filled
        # by construction (buf0 fill + the early-exit cond), so over-fetching
        # is parity-neutral and an under-fetch is DETECTABLE host-side — a
        # real row with no _END_ID inside the prefix may continue, so refetch
        # (rare: only when a line outgrows all history). Reading the
        # executed-prefix length ci first would cost a scalar fetch plus a
        # fresh slice executable per new ci value before every batch's
        # transfer.
        total = buf.shape[0]
        if buf.shape not in self._warmed:
            # pre-compile EVERY prefix-slice executable this buffer shape can
            # ever use (the pow-2 ladder; dispatch-only, nothing fetched): a
            # guess change mid-corpus then reuses a warm executable instead
            # of compiling inside a timed corpus run
            c = 1
            while c * _CHUNK < total:
                buf[: c * _CHUNK]
                c *= 2
            self._warmed.add(buf.shape)
        guess = min(self._guess, total)
        pref = buf[:guess] if guess < total else buf
        ids = np.asarray(pref).T[:L]  # [L, guess]
        if guess < total and not (ids == _END_ID).any(axis=1).all():
            # under-guess: refetch the WHOLE buffer — a plain transfer with
            # no slice executable at all, so the miss path never compiles
            # (a guess-to-end remainder slice would have a fresh shape)
            global refetch_total
            refetch_total += 1
            self.n_refetches += 1
            ids = np.asarray(buf).T[:L]
        if L:
            row_ends = ids == _END_ID
            if row_ends.any(axis=1).all():
                longest = int(row_ends.argmax(axis=1).max()) + 1
            else:  # some line consumed every step
                longest = ids.shape[1]
            chunks = -(-longest // _CHUNK) + 1  # + one chunk of margin
            c = 1
            while c < chunks:
                c *= 2
            self._guess = min(total, c * _CHUNK)
        alphabet = self.bank.alphabet
        out = []
        for row in ids:
            ends = row == _END_ID
            n = int(np.argmax(ends)) if ends.any() else len(row)
            out.append("".join(alphabet[g] for g in row[:n]))
        return out
