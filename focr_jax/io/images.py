"""Image I/O: PNG/PNM loading, grayscale conversion, page batching.

Reference counterpart: the `image` crate with png+pnm features
(Cargo.toml:10; image::open at main.rs:448, ncc.rs:575). Grayscale conversion
replicates the image crate's integer Rec.709 luma
(luma = (2126*r + 7152*g + 722*b) / 10000, truncating) so RGB inputs decode
identically.

Batching: pages are grouped into same-shape buckets and padded to a batch with
white (255) pages — white pages decode to zero lines (every row hits the
all-white skip, main.rs:208-211) so padding is harmless.

Pillow is imported inside the functions that read or write files, so the
device path, which takes page arrays, never needs it.
"""

from __future__ import annotations

import concurrent.futures as _futures
from dataclasses import dataclass

import numpy as np


def load_gray(path: str) -> np.ndarray:
    """Load an image as u8 grayscale [H, W] with image-crate-equivalent luma."""
    from PIL import Image

    with Image.open(path) as im:
        if im.mode in ("L",):
            return np.asarray(im, dtype=np.uint8)
        if im.mode in ("I;16", "I"):
            arr = np.asarray(im)
            return (arr >> 8).astype(np.uint8)
        if im.mode == "1":
            return (np.asarray(im, dtype=np.uint8) * 255).astype(np.uint8)
        rgb = np.asarray(im.convert("RGB"), dtype=np.uint32)
    luma = (2126 * rgb[..., 0] + 7152 * rgb[..., 1] + 722 * rgb[..., 2]) // 10000
    return luma.astype(np.uint8)


def load_gray_many(paths: list[str], max_workers: int = 8) -> list[np.ndarray]:
    """Threaded page loader (PIL releases the GIL during decode).

    Replaces the reference's rayon page fan-out for the I/O stage
    (main.rs:442-448); device batching replaces it for compute.
    """
    if len(paths) <= 1:
        return [load_gray(p) for p in paths]
    with _futures.ThreadPoolExecutor(max_workers=max_workers) as ex:
        return list(ex.map(load_gray, paths))


def load_gray_many_isolated(
    paths: list[str], max_workers: int = 8
) -> tuple[list[np.ndarray | None], list[tuple[int, str]]]:
    """Fault-isolating page loader (SURVEY.md §5.3): a bad PNG yields None for
    its slot plus an (index, error) record instead of killing the whole batch
    (the reference panics on the first unreadable page, main.rs:448)."""

    def one(path: str):
        try:
            return load_gray(path), None
        except Exception as e:  # noqa: BLE001 - isolate any per-page failure
            return None, f"{type(e).__name__}: {e}"

    with _futures.ThreadPoolExecutor(max_workers=max_workers) as ex:
        results = list(ex.map(one, paths))
    pages = [r[0] for r in results]
    errors = [(i, r[1]) for i, r in enumerate(results) if r[1] is not None]
    return pages, errors


def _save(path: str, img: np.ndarray, mode: str) -> None:
    from PIL import Image

    Image.fromarray(img, mode=mode).save(path)


def save_gray(path: str, img: np.ndarray) -> None:
    _save(path, img, "L")


def save_rgb(path: str, img: np.ndarray) -> None:
    _save(path, img, "RGB")


def save_rgba(path: str, img: np.ndarray) -> None:
    _save(path, img, "RGBA")


@dataclass(frozen=True)
class Bucket:
    """Pages sharing one (H, W) shape, batched into a single array."""

    shape: tuple[int, int]
    indices: list[int]  # original page indices, in order
    pages: np.ndarray  # [B, H, W] u8


def bucket_pages(pages: list[np.ndarray]) -> list[Bucket]:
    """Group pages by shape to avoid XLA recompiles (SURVEY.md §7 stage 6)."""
    groups: dict[tuple[int, int], list[int]] = {}
    for i, p in enumerate(pages):
        groups.setdefault(p.shape, []).append(i)
    buckets = []
    for shape, idxs in groups.items():
        arr = np.stack([pages[i] for i in idxs], axis=0)
        buckets.append(Bucket(shape=shape, indices=idxs, pages=arr))
    return buckets
