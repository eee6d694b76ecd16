"""On-card smoke run: the main paths at the canonical workload, checked bit
for bit against the host references.

The workload is the README grid (-t 13 -x 45 -y 39 -w 608 --line-height 12
--line-advance 15) on letter pages of 792x662, 48 lines of base64-style
characters per page:

  focr   GridDecoder/decode_stream, DejaVu Sans Mono, 64 pages: text equals
         the synthesized truth on every page and focr_oracle on 2 pages
  prop   decode_pages through PropDecoder, DejaVu Sans, 16 pages: text
         equals focr_oracle.decode_image on every page; no page decoded on
         the host (GridDecoder.n_host_pages == 0)
  ncc    NccMatcher(x_bits=2) with the 74-letter default alphabet (296
         needles) through get_hits_many(post=...), 64 pages: hits
         bit-identical (letter, x, y, f32 similarity) to get_hits_native on
         every page and to get_hits_oracle on 1 page; no needle searched on
         the host (NccMatcher.n_host_overflow == 0)
  cli    the focr and ncc CLIs in-process on 4 page files: stdout equals
         the library output
  exact  correlate and window_stats for every needle group, exact_corr for
         the grid bank and exact_corr_mat for the prop bank, at the
         canonical widths: equal to int64 NumPy

Each device phase runs a warm pass (compile included), then a steady pass
whose wall time it prints beside the number of executables built inside it
(0 expected).

  python chip_smoke.py          one card: the phases above
  python chip_smoke.py --four   four cards: the sharded focr (4x1 and 2x2
                                meshes), ncc and prop paths, each compared
                                with the single-device result on device 0

Fails unless JAX's first device is a GPU. The last line of stdout is one
JSON object: {"ok": true, "device": {"platform", "kind", "count"}}.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import multiprocessing
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ProcessPoolExecutor
from dataclasses import dataclass

REPO = os.path.dirname(os.path.abspath(__file__))
BACKEND_COMPILE_EVENT = "/jax/core/compile/backend_compile_duration"


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


@dataclass(frozen=True)
class Workload:
    """Page shape, scan grid and corpus sizes of one smoke run."""

    shape: tuple[int, int] = (792, 662)
    grid: tuple[int, int, int, int, int] = (45, 39, 12, 15, 608)  # x y lh la w
    size: float = 13.0
    lines: int = 48
    chars: int = 77
    prop_chars: int = 60
    focr_pages: int = 64
    prop_pages: int = 16
    ncc_pages: int = 64
    cli_pages: int = 4
    focr_oracle_pages: int = 2
    ncc_oracle_pages: int = 1
    batch: int = 16
    workers: int = 12  # host reference processes

    def dopts(self):
        from focr_jax.models.types import DecodeOptions

        x, y, lh, la, w = self.grid
        return DecodeOptions(x_start=x, y_start=y, line_height=lh, line_advance=la, width=w)

    def ropts(self):
        from focr_jax.models.types import RenderOptions

        return RenderOptions(size=self.size)

    def focr_cli_args(self) -> list[str]:
        x, y, lh, la, w = self.grid
        return ["-t", str(self.size), "-x", str(x), "-y", str(y), "-w", str(w),
                "--line-height", str(lh), "--line-advance", str(la)]


CANONICAL = Workload()


@dataclass
class Corpus:
    mono_truth: list[list[str]]
    mono_pages: object  # np.ndarray [N, H, W] u8
    prop_pages: list
    ncc_pages: list


def text_alphabet() -> str:
    """The focr alphabet with ' ' and '>' swapped out: base64-style text."""
    from focr_jax.models.types import FOCR_DEFAULT_ALPHABET

    return FOCR_DEFAULT_ALPHABET.replace(" ", "A").replace(">", "B")


def make_corpus(w: Workload, seed: int = 0) -> Corpus:
    import numpy as np

    from focr_jax.fonts import DEJAVU_MONO, DEJAVU_SANS
    from focr_jax.fonts.ft import Face
    from focr_jax.io.synth import random_text_lines, synthesize_page
    from focr_jax.models.types import FOCR_DEFAULT_ALPHABET, NCC_DEFAULT_ALPHABET

    rng = np.random.default_rng(seed)
    mono, sans = Face(DEJAVU_MONO), Face(DEJAVU_SANS)
    dopts, ropts, talpha = w.dopts(), w.ropts(), text_alphabet()
    truth = [random_text_lines(rng, talpha, w.lines, w.chars) for _ in range(w.focr_pages)]
    mono_pages = np.stack([
        synthesize_page(mono, t, dopts, ropts, FOCR_DEFAULT_ALPHABET, w.shape) for t in truth
    ])
    prop_pages = [
        synthesize_page(sans, random_text_lines(rng, talpha, w.lines, w.prop_chars),
                        dopts, ropts, talpha, w.shape)
        for _ in range(w.prop_pages)
    ]
    ncc_pages = [
        synthesize_page(mono, random_text_lines(rng, NCC_DEFAULT_ALPHABET, w.lines, w.chars),
                        dopts, ropts, NCC_DEFAULT_ALPHABET, w.shape)
        for _ in range(w.ncc_pages)
    ]
    return Corpus(truth, mono_pages, prop_pages, ncc_pages)


class CompileCounter:
    """Counts executables JAX builds (persistent-cache hits included)."""

    def __init__(self):
        self.n = 0

    def __call__(self, event: str, duration: float, **kwargs) -> None:
        if event == BACKEND_COMPILE_EVENT:
            self.n += 1


def two_pass(name: str, counter: CompileCounter, fn, n_pages: int, key=lambda r: r):
    """Warm pass (compile included), then a timed steady pass; both must
    agree under ``key`` (applied outside the timed region). Every ``fn``
    here returns host values, so its wall time includes the device work."""
    t0 = time.perf_counter()
    warm = fn()
    t1 = time.perf_counter()
    n0 = counter.n
    steady = fn()
    t2 = time.perf_counter()
    compiles = counter.n - n0
    check(key(warm) == key(steady), f"{name}: warm and steady passes differ")
    print(f"[{name}] compile_s {t1 - t0:.3f} (first pass) | steady_s {t2 - t1:.3f} "
          f"for {n_pages} pages | compiles_in_steady {compiles}", flush=True)
    return steady


def hit_keys(hits) -> list[tuple]:
    import numpy as np

    return [(h.letter, h.x, h.y, np.float32(h.similarity).tobytes()) for h in hits]


def struct_keys(structs) -> list[tuple]:
    """Byte-exact fingerprint of get_hits_many(struct=True) pages."""
    return [(s.needle_id.tobytes(), s.x.tobytes(), s.y.tobytes(), s.sim.tobytes())
            for s in structs]


def lines_of(decoded) -> list[list[tuple[str, int]]]:
    return [[(ln.text, ln.y) for ln in page] for page in decoded]


# -- host references, run in worker processes that never touch the card ----


def _host_only() -> None:
    os.environ["JAX_PLATFORMS"] = "cpu"


def reference_job(kind: str, page, w: Workload):
    """One page through a host oracle: 'mono'/'prop' -> focr_oracle lines,
    'ncc' -> get_hits_oracle hit keys."""
    from focr_jax.fonts import DEJAVU_MONO, DEJAVU_SANS
    from focr_jax.fonts.ft import Face
    from focr_jax.models.types import FOCR_DEFAULT_ALPHABET, NCC_DEFAULT_ALPHABET

    if kind == "ncc":
        from focr_jax.models.ncc import NccMatcher

        m = NccMatcher(Face(DEJAVU_MONO), NCC_DEFAULT_ALPHABET, w.ropts(), x_bits=2)
        return hit_keys(m.get_hits_oracle(page))
    from focr_jax.oracle.focr_oracle import decode_image

    face, alpha = (
        (Face(DEJAVU_MONO), FOCR_DEFAULT_ALPHABET) if kind == "mono"
        else (Face(DEJAVU_SANS), text_alphabet())
    )
    return lines_of([decode_image(page, face, alpha, w.dopts(), w.ropts())])[0]


# -- one-card phases ----------------------------------------------------------


def phase_focr(w: Workload, corpus: Corpus, counter: CompileCounter):
    from focr_jax.fonts import DEJAVU_MONO
    from focr_jax.fonts.ft import Face
    from focr_jax.models.focr import GridDecoder, decode_stream
    from focr_jax.models.types import FOCR_DEFAULT_ALPHABET

    dec = GridDecoder(Face(DEJAVU_MONO), FOCR_DEFAULT_ALPHABET, w.dopts(), w.ropts(), w.shape)

    def run():
        out = []
        for _, decoded in decode_stream(dec, corpus.mono_pages, w.batch):
            out.extend(decoded)
        return lines_of(out)

    got = two_pass("focr", counter, run, w.focr_pages)
    bad = [i for i, (page, truth) in enumerate(zip(got, corpus.mono_truth))
           if [t.rstrip() for t, _ in page] != truth]
    check(not bad, f"focr: pages {bad[:8]} differ from the synthesized truth")
    return got, dec


def phase_prop(w: Workload, corpus: Corpus, counter: CompileCounter):
    from focr_jax.fonts import DEJAVU_SANS
    from focr_jax.fonts.ft import Face
    from focr_jax.models.focr import _cached_decoder, decode_pages

    face = Face(DEJAVU_SANS)
    got = two_pass("prop", counter, lambda: lines_of(decode_pages(
        corpus.prop_pages, face, text_alphabet(), w.dopts(), w.ropts(), batch_size=w.batch,
    )), w.prop_pages)
    dec = _cached_decoder(face, text_alphabet(), w.dopts(), w.ropts(), w.shape, None)
    check(bool(dec.prop_groups), "prop: no device decoder was built")
    print(f"[prop] pages decoded on the host: {dec.n_host_pages}", flush=True)
    check(dec.n_host_pages == 0, "prop: pages fell back to the host oracle")
    return got, dec


def phase_ncc(w: Workload, corpus: Corpus, counter: CompileCounter):
    import jax
    import numpy as np

    from focr_jax.fonts import DEJAVU_MONO
    from focr_jax.fonts.ft import Face
    from focr_jax.models import ncc as ncc_mod
    from focr_jax.models.post import process_hits_text
    from focr_jax.models.types import NCC_DEFAULT_ALPHABET
    from focr_jax.ops import ncc as ncc_ops

    m = ncc_mod.NccMatcher(Face(DEJAVU_MONO), NCC_DEFAULT_ALPHABET, w.ropts(), x_bits=2)
    print(f"[ncc] needles {len(m.needles)} in groups "
          f"{[(g.nh, g.nw, len(g.needle_ids)) for g in m.groups]}", flush=True)

    # the CLI's text path (post fused into the pipeline workers), keeping
    # each page's hits beside its text for the parity checks
    out = two_pass("ncc", counter, lambda: m.get_hits_many(
        corpus.ncc_pages, struct=True,
        post=lambda hs: (hs, process_hits_text(hs, 0.95, 5)),
    ), w.ncc_pages, key=lambda r: (struct_keys(hs for hs, _ in r), [t for _, t in r]))
    got = [(hit_keys(hs.to_objects()), text) for hs, text in out]
    print(f"[ncc] needles searched on the host: {m.n_host_overflow}", flush=True)
    check(m.n_host_overflow == 0, "ncc: candidates overflowed to the host search")

    # the per-page step as compiled, at the ink-crop shape the pipeline sweeps
    inv = np.stack([255 - p for p in corpus.ncc_pages[:8]]).astype(np.uint8)
    _, _, Hc, Wc = ncc_mod._ink_crop(inv, *w.shape, m.groups)
    for grp, (bank, s_n, s2_n, thr) in zip(m.groups, m._device_groups()):
        compiled = ncc_ops.ncc_candidates.lower(
            jax.ShapeDtypeStruct((Hc, Wc), np.uint8), bank, s_n, s2_n, thr,
            nw=grp.nw, nh=grp.nh, cap=ncc_mod._CAP,
        ).compile()
        ma = compiled.memory_analysis()
        print(f"[ncc] memory_analysis group {grp.nh}x{grp.nw} T={len(grp.needle_ids)} "
              f"page {Hc}x{Wc}: temp {ma.temp_size_in_bytes} argument "
              f"{ma.argument_size_in_bytes} output {ma.output_size_in_bytes} | "
              f"wave model _page_bytes {ncc_mod._page_bytes(grp, Hc, Wc)}", flush=True)
    return got, m


def phase_cli(w: Workload, corpus: Corpus, counter: CompileCounter, focr_lines, ncc_got):
    from focr_jax.cli import focr as focr_cli
    from focr_jax.cli import ncc as ncc_cli
    from focr_jax.fonts import DEJAVU_MONO
    from focr_jax.io.images import save_gray

    def stdout_of(main, argv) -> str:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            check(main(argv) == 0, f"cli: {argv[:2]} exited non-zero")
        return buf.getvalue()

    n = w.cli_pages
    with tempfile.TemporaryDirectory(dir=REPO, prefix=".smoke_pages_") as d:
        mono = [os.path.join(d, f"focr-{i}.png") for i in range(n)]
        nccp = [os.path.join(d, f"ncc-{i}.png") for i in range(n)]
        for i in range(n):
            save_gray(mono[i], corpus.mono_pages[i])
            save_gray(nccp[i], corpus.ncc_pages[i])
        focr_out = two_pass("cli focr", counter, lambda: stdout_of(
            focr_cli.main, ["-i", *mono, "-f", DEJAVU_MONO, *w.focr_cli_args()]), n)
        ncc_out = two_pass("cli ncc", counter, lambda: stdout_of(
            ncc_cli.main, ["-i", *nccp, "-f", DEJAVU_MONO, "-t", str(w.size), "--x-bits", "2"]), n)
    want_focr = "".join(f"{t}\n" for page in focr_lines[:n] for t, _ in page)
    want_ncc = "".join(f"{t}\n" for _, text in ncc_got[:n] for t in text)
    check(focr_out == want_focr, "cli: focr stdout differs from the library decode")
    check(ncc_out == want_ncc, "cli: ncc stdout differs from the library text")
    print(f"[cli] parity ok: focr and ncc stdout == library output on {n} page files",
          flush=True)


def phase_exact(w: Workload, corpus: Corpus, matcher, grid_dec, prop_dec) -> None:
    """Tolerance 0: every device quantity here is an integer."""
    import jax.numpy as jnp
    import numpy as np

    from focr_jax.ops import ncc as ncc_ops
    from focr_jax.ops import ssd

    rng = np.random.default_rng(5)
    pages = {
        "dense": (255 - corpus.ncc_pages[0]).astype(np.uint8),
        "noise": rng.integers(0, 256, w.shape, dtype=np.uint8),
    }
    for label, inv in pages.items():
        for g in matcher.groups:
            T, nh, nw = g.bank.shape
            win = np.lib.stride_tricks.sliding_window_view(inv.astype(np.int64), (nh, nw))
            Hs, Ws = win.shape[:2]
            # int64 reference through f64 BLAS: every product and sum is an
            # integer below n·255² < 2⁵³, so the f64 arithmetic is exact
            want = (win.reshape(Hs * Ws, nh * nw).astype(np.float64)
                    @ g.bank.reshape(T, -1).astype(np.float64).T).T.astype(np.int64)
            got = np.asarray(ncc_ops.correlate(jnp.asarray(inv), jnp.asarray(g.bank)))
            check(np.array_equal(got.reshape(T, -1).astype(np.int64), want),
                  f"exact: correlate {label} group {nh}x{nw}")
            sp, s2p = ncc_ops.window_stats(jnp.asarray(inv), nw, nh)
            check(np.array_equal(np.asarray(sp), win.sum(axis=(2, 3)))
                  and np.array_equal(np.asarray(s2p), (win * win).sum(axis=(2, 3))),
                  f"exact: window_stats {label} group {nh}x{nw}")
    bank = grid_dec.banks[0]
    C, G, p, q = bank.templates.shape
    wins = rng.integers(0, 256, (2, 4, C, p, q), dtype=np.uint8)
    got = np.asarray(ssd.exact_corr(jnp.asarray(wins.astype(np.int32)), jnp.asarray(bank.templates)))
    want = np.einsum("brcpq,cgpq->brcg", wins.astype(np.int64), bank.templates.astype(np.int64))
    check(np.array_equal(got.astype(np.int64), want), "exact: exact_corr (grid bank)")
    pbank = prop_dec.prop_groups[0][1].bank
    tm = pbank.templates.reshape(-1, pbank.templates.shape[2] * pbank.templates.shape[3])
    wl = rng.integers(0, 256, (2048, tm.shape[1]), dtype=np.uint8)
    got = np.asarray(ssd.exact_corr_mat(jnp.asarray(wl.astype(np.int32)), jnp.asarray(tm)))
    want = wl.astype(np.int64) @ tm.astype(np.int64).T
    check(np.array_equal(got.astype(np.int64), want), "exact: exact_corr_mat (prop bank)")
    print(f"[exact] parity ok: correlate + window_stats for {len(matcher.groups)} needle "
          f"groups on a dense and a noise {w.shape[0]}x{w.shape[1]} page, exact_corr "
          f"{bank.templates.shape}, exact_corr_mat {tm.shape} == int64 NumPy", flush=True)


def check_references(w: Workload, corpus: Corpus, focr_lines, prop_lines, ncc_got, matcher) -> None:
    """Host references: the oracles in worker processes, the native ncc
    engine here (it is multi-threaded itself)."""
    ctx = multiprocessing.get_context("spawn")
    workers = max(1, min(w.workers, os.cpu_count() or 1))
    with ProcessPoolExecutor(workers, mp_context=ctx, initializer=_host_only) as pool:
        mono_f = [pool.submit(reference_job, "mono", corpus.mono_pages[i], w)
                  for i in range(w.focr_oracle_pages)]
        prop_f = [pool.submit(reference_job, "prop", p, w) for p in corpus.prop_pages]
        ncc_f = [pool.submit(reference_job, "ncc", corpus.ncc_pages[i], w)
                 for i in range(w.ncc_oracle_pages)]
        t0 = time.perf_counter()
        bad = [i for i, page in enumerate(corpus.ncc_pages)
               if hit_keys(matcher.get_hits_native(page)) != ncc_got[i][0]]
        check(not bad, f"ncc: pages {bad[:8]} differ from get_hits_native")
        print(f"[ncc] parity ok: {len(corpus.ncc_pages)}/{len(corpus.ncc_pages)} pages "
              f"bit-identical to get_hits_native ({time.perf_counter() - t0:.1f}s on the host)",
              flush=True)
        bad = [i for i, f in enumerate(mono_f) if f.result() != focr_lines[i]]
        check(not bad, f"focr: pages {bad} differ from focr_oracle")
        print(f"[focr] parity ok: {len(focr_lines)}/{len(focr_lines)} pages == truth, "
              f"{len(mono_f)}/{len(mono_f)} == focr_oracle", flush=True)
        bad = [i for i, f in enumerate(prop_f) if f.result() != prop_lines[i]]
        check(not bad, f"prop: pages {bad} differ from focr_oracle")
        print(f"[prop] parity ok: {len(prop_f)}/{len(prop_f)} pages == focr_oracle",
              flush=True)
        bad = [i for i, f in enumerate(ncc_f) if f.result() != ncc_got[i][0]]
        check(not bad, f"ncc: pages {bad} differ from get_hits_oracle")
        print(f"[ncc] parity ok: {len(ncc_f)}/{len(ncc_f)} pages bit-identical to "
              f"get_hits_oracle", flush=True)


def run_one_card(w: Workload, counter: CompileCounter) -> None:
    corpus = make_corpus(w)
    focr_lines, grid_dec = phase_focr(w, corpus, counter)
    prop_lines, prop_dec = phase_prop(w, corpus, counter)
    ncc_got, matcher = phase_ncc(w, corpus, counter)
    phase_cli(w, corpus, counter, focr_lines, ncc_got)
    phase_exact(w, corpus, matcher, grid_dec, prop_dec)
    check_references(w, corpus, focr_lines, prop_lines, ncc_got, matcher)


# -- four-card phases ---------------------------------------------------------


def run_four_cards(w: Workload, counter: CompileCounter, devices: list) -> None:
    """The paths `--mesh auto` takes on a four-card host, each compared with
    the single-device result on devices[0] in this process."""
    from focr_jax.fonts import DEJAVU_MONO, DEJAVU_SANS
    from focr_jax.fonts.ft import Face
    from focr_jax.models.focr import decode_pages
    from focr_jax.models.ncc import NccMatcher
    from focr_jax.models.types import FOCR_DEFAULT_ALPHABET, NCC_DEFAULT_ALPHABET
    from focr_jax.parallel.mesh import page_mesh

    corpus = make_corpus(w)
    mono, sans = Face(DEJAVU_MONO), Face(DEJAVU_SANS)
    dopts, ropts = w.dopts(), w.ropts()
    mono_pages = list(corpus.mono_pages)

    def focr(mesh):
        return lines_of(decode_pages(mono_pages, mono, FOCR_DEFAULT_ALPHABET, dopts, ropts,
                                     batch_size=w.batch, mesh=mesh))

    def prop(mesh):
        return lines_of(decode_pages(corpus.prop_pages, sans, text_alphabet(), dopts, ropts,
                                     batch_size=w.batch, mesh=mesh))

    single = focr(None)
    for glyph_shards in (1, 2):
        mesh = page_mesh(devices, glyph_shards=glyph_shards)
        shape = f"{mesh.shape['pages']}x{mesh.shape['glyphs']}"
        got = two_pass(f"four focr {shape}", counter, lambda: focr(mesh), w.focr_pages)
        check(got == single, f"four: focr {shape} mesh differs from one device")
        print(f"[four focr {shape}] parity ok: {len(got)} pages == single device", flush=True)

    mesh = page_mesh(devices, glyph_shards=1)
    m = NccMatcher(mono, NCC_DEFAULT_ALPHABET, ropts, x_bits=2)
    single = struct_keys(m.get_hits_many(corpus.ncc_pages, struct=True))
    got = two_pass("four ncc", counter, lambda: m.get_hits_many_sharded(
        corpus.ncc_pages, mesh, struct=True), w.ncc_pages, key=struct_keys)
    check(struct_keys(got) == single, "four: sharded ncc differs from one device")
    check(m.n_host_overflow == 0, "four: ncc candidates overflowed to the host search")
    print(f"[four ncc] parity ok: {len(got)} pages bit-identical to single device", flush=True)

    single = prop(None)
    got = two_pass("four prop", counter, lambda: prop(mesh), w.prop_pages)
    check(got == single, "four: sharded prop differs from one device")
    print(f"[four prop] parity ok: {len(got)} pages == single device", flush=True)


def main(argv: list[str] | None = None, workload: Workload = CANONICAL) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run the four-card sharded paths, and nothing else")
    args = ap.parse_args(argv)

    sys.path.insert(0, REPO)
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {devices[0].platform}", file=sys.stderr)
        return 2
    if args.four and len(devices) < 4:
        print(f"chip_smoke: --four needs 4 GPUs, JAX found {len(devices)}", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    print(smi.stdout.strip(), flush=True)

    counter = CompileCounter()
    jax.monitoring.register_event_duration_secs_listener(counter)
    t0 = time.perf_counter()
    if args.four:
        run_four_cards(workload, counter, devices[:4])
        used = devices[:4]
    else:
        run_one_card(workload, counter)
        used = devices[:1]
    for d in used:
        print(f"[{d}] peak_bytes_in_use {d.memory_stats()['peak_bytes_in_use']}", flush=True)
    print(f"total_s {time.perf_counter() - t0:.1f}", flush=True)
    d = devices[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind, "count": len(devices),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
