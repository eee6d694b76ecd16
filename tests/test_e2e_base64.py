"""End-to-end oracle: the reference's canonical workload is a base64-encoded
attachment rendered as quoted text lines; correctness is byte-exact recovery
of the attachment from the decoded stdout (README.md:16-21, 56-58 —
`focr ... | sed 's/> //' | base64 -d`). This test replicates that pipeline
against synthesized pages for both engines."""

import base64

import numpy as np
import pytest

from focr_jax.models.types import DecodeOptions, FOCR_DEFAULT_ALPHABET, RenderOptions


@pytest.fixture(scope="module")
def corpus(mono_font_path):
    from focr_jax.fonts.ft import Face
    from focr_jax.io.synth import synthesize_page

    rng = np.random.default_rng(7)
    payload = rng.integers(0, 256, 900, dtype=np.uint8).tobytes()
    b64 = base64.b64encode(payload).decode()
    width = 60
    lines = ["> " + b64[i : i + width] for i in range(0, len(b64), width)]

    face = Face(mono_font_path)
    ropts = RenderOptions(size=11.0)
    dopts = DecodeOptions(x_start=8, y_start=10, line_height=13, line_advance=15, width=430)
    per_page = 10
    pages = [
        synthesize_page(
            face,
            lines[i : i + per_page],
            dopts,
            ropts,
            FOCR_DEFAULT_ALPHABET,
            (10 + per_page * 15 + 13, 450),
        )
        for i in range(0, len(lines), per_page)
    ]
    return payload, lines, pages, face, ropts, dopts


def _reassemble(decoded_lines: list[str]) -> bytes:
    # the README pipeline: strip the "> " quote prefix, concatenate, b64 -d
    joined = "".join(t.rstrip()[2:] for t in decoded_lines if t.rstrip())
    return base64.b64decode(joined)


def test_focr_roundtrip_device(corpus):
    from focr_jax.models.focr import decode_pages

    payload, lines, pages, face, ropts, dopts = corpus
    results = decode_pages(pages, face, FOCR_DEFAULT_ALPHABET, dopts, ropts)
    texts = [ln.text for res in results for ln in res]
    assert _reassemble(texts) == payload


def test_focr_roundtrip_oracle(corpus):
    from focr_jax.oracle.focr_oracle import decode_image

    payload, lines, pages, face, ropts, dopts = corpus
    texts = [
        ln.text
        for p in pages
        for ln in decode_image(p, face, FOCR_DEFAULT_ALPHABET, dopts, ropts)
    ]
    assert _reassemble(texts) == payload


def test_ncc_roundtrip_device(corpus):
    from focr_jax.models.ncc import NccMatcher
    from focr_jax.models.post import process_hits

    payload, lines, pages, face, ropts, dopts = corpus
    m = NccMatcher(face, "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789=+<>/",
                   ropts, x_bits=2)
    texts = []
    for p in pages:
        hits = m.get_hits(p)
        for line in process_hits(hits, 0.95, 5):
            texts.append("".join(h.letter for h in line))
    # ncc's alphabet has no space: lines come out as ">XXXX"; drop the ">"
    joined = "".join(t[1:] for t in texts if t)
    assert base64.b64decode(joined) == payload
