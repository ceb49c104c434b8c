"""How a window's tokens become segments (faster-whisper ``transcribe.py``,
``_split_segments_by_timestamps``), frozen here: with two timestamps in a
row the tokens are cut there into segments timed by their first and last
timestamp, and the tokens after the last such pair are dropped unless the
tokens end on a lone timestamp; otherwise the window is one segment,
ending at its last timestamp if it has one."""

from typing import List, Tuple

TIME_PRECISION = 0.02


def consecutive(tokens: List[int], tsb: int) -> List[int]:
    return [i for i in range(1, len(tokens)) if tokens[i] >= tsb and tokens[i - 1] >= tsb]


def split(tokens: List[int], tsb: int, offset: float, duration: float) -> List[Tuple[float, float, List[int]]]:
    """(start, end, tokens) of each segment the rule makes of a window's
    whole hypothesis ``tokens``, at ``offset`` seconds, ``duration`` long."""
    cuts = consecutive(tokens, tsb)
    if not cuts:
        stamps = [t for t in tokens if t >= tsb]
        if stamps and stamps[-1] != tsb:
            duration = (stamps[-1] - tsb) * TIME_PRECISION
        return [(offset, offset + duration, list(tokens))]
    if len(tokens) >= 2 and tokens[-2] < tsb <= tokens[-1]:
        cuts.append(len(tokens))
    out, last = [], 0
    for b in cuts:
        piece = tokens[last:b]
        out.append((offset + (piece[0] - tsb) * TIME_PRECISION, offset + (piece[-1] - tsb) * TIME_PRECISION,
                    list(piece)))
        last = b
    return out
