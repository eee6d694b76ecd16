"""Regenerate tests/fixtures/ft_goldens.npz (run from the repo root).

Freeze the font layer's observable outputs for the matrix in
ft_golden_common. Commit the npz; test_ft_goldens.py compares live renders
against it field-by-field. Regenerate ONLY when a deliberate font-layer
semantic change is made — the diff then documents exactly what changed.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from focr_jax.fonts.ft import Face
from tests.ft_golden_common import (
    available_fonts, entry_key, iter_matrix, render_entry,
)


def main() -> None:
    fonts = available_fonts()
    keys: list[str] = []
    gids, advances = [], []
    typos, bounds = [], []
    shapes, blobs = [], []
    faces = {k: Face(p) for k, p in fonts.items()}
    for font_key, _path, size, hint, off, ch in iter_matrix():
        if font_key not in faces:
            print(f"skip (font missing): {font_key}", file=sys.stderr)
            continue
        e = render_entry(faces[font_key], size, hint, off, ch)
        keys.append(entry_key(font_key, size, hint, off, ch))
        gids.append(e["gid"])
        advances.append(e["advance"])
        typos.append(e["typo"])
        bounds.append(e["bounds"])
        shapes.append(e["bitmap"].shape)
        blobs.append(e["bitmap"].ravel())
    out = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures", "ft_goldens.npz")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    np.savez_compressed(
        out,
        keys=np.array(json.dumps(keys)),
        gid=np.array(gids, dtype=np.int32),
        advance=np.array(advances, dtype=np.float64),
        typo=np.stack(typos),
        bounds=np.stack(bounds),
        shape=np.array(shapes, dtype=np.int32),
        blob=np.concatenate(blobs) if blobs else np.zeros(0, np.uint8),
        blob_off=np.cumsum([0] + [b.size for b in blobs]).astype(np.int64),
    )
    print(f"wrote {out}: {len(keys)} entries", file=sys.stderr)


if __name__ == "__main__":
    main()
