"""What the work counts of every model family share: one int8 product
(``Gemm``), a dispatch's work (``DispatchWork``) and the least time a list of
products needs (``roofline_s``). A family's ``work(cfg, rec, dispatch)``
(``families/<family>.py``) fills a ``DispatchWork`` from its configuration
and the dispatch's rows, steps and tokens; the readers of ``core/readers.py``
read it.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Gemm:
    """One int8 product: M rows of K inputs against an (N, K) weight."""

    m: int
    k: int
    n: int

    @property
    def ops(self) -> int:
        return 2 * self.m * self.k * self.n

    @property
    def bytes(self) -> int:  # int8 weight and input read once, int32 output written once
        return self.n * self.k + self.m * self.k + 4 * self.m * self.n


@dataclasses.dataclass
class DispatchWork:
    """One dispatch's work, as its family counts it."""

    did: int
    rows_real: int
    rows_encoded: int
    frames: int  # encoder positions of the bucket
    new_tokens: int  # tokens served past the prefix and forced tokens, EOT included
    steps: int  # decode steps the loop needs
    flops: int  # model FLOPs the rows need
    gemms: list  # the int8 products the rows need
    logmel_bytes: int  # K1's launches (one a row encoded): audio read, mel written


def roofline_s(gemms: list, peak_ops: float, bw: float) -> float:
    """The least time the products could take: each one's larger of ops at
    the peak rate and bytes at the memory's bandwidth."""
    return sum(max(g.ops / peak_ops, g.bytes / bw) for g in gemms)
