"""Moving windows over token streams.

Reference: ``deeplearning4j-nlp/.../text/movingwindow/Windows.java`` +
``Window.java`` (sliding, edge-padded context windows feeding window-based
models).  Padding uses the reference's <s>/</s> edge markers.

The port's copy of ``deeplearning4j_tpu/nlp/windows.py``: no framework,
so its outputs equal the reference's exactly.
"""

from __future__ import annotations

import dataclasses
from typing import List

BEGIN = "<s>"
END = "</s>"


@dataclasses.dataclass
class Window:
    words: List[str]
    focus_index: int

    @property
    def focus_word(self) -> str:
        return self.words[self.focus_index]

    def as_list(self) -> List[str]:
        return list(self.words)


def windows(tokens: List[str], window_size: int = 5) -> List[Window]:
    """One Window per token, edge-padded so every window has exactly
    ``window_size`` words.  Odd sizes center the focus word; even sizes put
    it RIGHT of center (focus index ``window_size // 2``: e.g. size 4 gives
    2 words before, 1 after)."""
    if window_size < 1:
        raise ValueError("window_size must be >= 1")
    half = window_size // 2
    padded = [BEGIN] * half + list(tokens) + [END] * (window_size - half - 1)
    out = []
    for i in range(len(tokens)):
        out.append(Window(words=padded[i:i + window_size], focus_index=half))
    return out
