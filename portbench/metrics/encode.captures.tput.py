"""Captures of the encoder's CUDA graphs inside the window: the program's ``encode.capture`` spans, one at each (rows, window bucket) met for the first time; None for a program whose backend counts no ``encode_captures`` (an eager encode)."""

from portbench.core import spans as S


def read(run):
    asr = getattr(run.ctx, "asr", None)
    if "encode_captures" not in getattr(asr, "counters", {}):
        return None
    groups = S.window_spans(run)
    if groups is None:
        return None
    return float(sum(s.name == "encode.capture" for g in groups.values() for s in g))
