"""Shared datatypes mirroring the reference's option/result structs.

Reference structs: RenderOptions (main.rs:16-23, ncc.rs:52-58), DecodeOptions
(main.rs:25-32), DecodedLine (main.rs:34-38), BoxSize (ncc.rs:33-50),
Match/MatchWithLetter (ncc.rs:60-90).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

from focr_jax.fonts.ft import HintingOptions

# Default alphabets (main.rs:13-14; ncc.rs:28-29)
FOCR_DEFAULT_ALPHABET = "> =ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789+/"
NCC_DEFAULT_ALPHABET = "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789=+<>(){};:/-"

# Hard cap on matches per (letter, offset) search (ncc.rs:31)
MAX_MATCHES = 1024


@dataclass(frozen=True)
class RenderOptions:
    """Rasterization parameters (always A8 + grayscale AA in the reference)."""

    size: float
    hinting: HintingOptions = field(default_factory=HintingOptions)
    kern_x: float = 1.0  # focr-only advance scaler (main.rs:22)


@dataclass(frozen=True)
class DecodeOptions:
    """The focr scan grid (main.rs:25-32)."""

    x_start: int = 0
    y_start: int = 0
    line_height: int = 0
    line_advance: int = 0
    width: int = 0


@dataclass(frozen=True)
class DecodedLine:
    text: str
    y: int


class BoxSize(enum.Enum):
    """Template canvas sizing policy (ncc.rs:33-50)."""

    FONT = "font"
    ALPHABET = "alphabet"
    CHAR = "char"

    @classmethod
    def parse(cls, s: str) -> "BoxSize":
        try:
            return cls(s)
        except ValueError:
            raise ValueError(f"invalid box size {s!r}; expected font|alphabet|char") from None


@dataclass(frozen=True)
class Match:
    """One NCC hit: integer rect + f32 similarity (ncc.rs:60-64)."""

    x: int
    y: int
    w: int
    h: int
    similarity: float  # stored as f32, compared as f32 downstream

    @property
    def center(self) -> tuple[float, float]:
        # RectI::to_f32().center() — f32 midpoint (ncc.rs:682)
        return (self.x + self.w / 2.0, self.y + self.h / 2.0)


@dataclass(frozen=True, slots=True)  # slots: dense pages build ~10^5 of these
class MatchWithLetter:
    letter: str
    x: int
    y: int
    w: int
    h: int
    similarity: float

    @property
    def center(self) -> tuple[float, float]:
        return (self.x + self.w / 2.0, self.y + self.h / 2.0)
