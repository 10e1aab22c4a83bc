"""Panel-grid geometry (``cuda_qr_tpu/utils/geometry.py``).

``ceildiv``/``round_up`` size the blocked driver's padded grid.  The source
paper computes its sliding-panel grid in ``getPanelDims`` (qr.cu:49-55,
qr.c:45-53) and repeats the per-column reflector extent (vstart/vend, the
four bottom/top panel cases) in several places (qr.cu:104-132, 225-249,
363-389; qr.c:108-141); ``PanelGrid`` and ``reflector_extent`` hold that
geometry once.  Only the C oracle's sliding panels use it: the blocked
factorizations here factor full-height panels and have no panel cases.
"""

from __future__ import annotations

import dataclasses


def ceildiv(a: int, b: int) -> int:
    """qr.cu:28."""
    return -(-a // b)


def round_up(x: int, m: int) -> int:
    return ceildiv(x, m) * m


@dataclasses.dataclass(frozen=True)
class PanelGrid:
    """Sliding-panel grid of the source algorithm (qr.cu:49-55).

    ``col_panels`` = ceil(n / pc); ``row_panels`` = 1 + ceil((m - pr)/(pr - pc))
    for m > pr (one panel otherwise).  tau is laid out
    ``tau[(row_panels * pc_idx + pr_idx) * pc + col]`` (qr.cu:517).
    """

    m: int
    n: int
    pr: int
    pc: int

    def __post_init__(self):
        if self.pc >= self.pr:
            raise ValueError(f"panel cols {self.pc} must be < panel rows {self.pr}")
        if self.n > self.m:
            raise ValueError(f"need n <= m, got {self.m}x{self.n}")

    @property
    def col_panels(self) -> int:
        return ceildiv(self.n, self.pc)

    @property
    def row_panels(self) -> int:
        if self.m <= self.pr:
            return 1
        return 1 + ceildiv(self.m - self.pr, self.pr - self.pc)

    @property
    def tau_len(self) -> int:
        return self.row_panels * self.col_panels * self.pc

    def tau_index(self, pc_idx: int, pr_idx: int, col: int) -> int:
        """qr.cu:517 / qr.cu:616."""
        return (self.row_panels * pc_idx + pr_idx) * self.pc + col

    def aligned(self) -> bool:
        """The source algorithm's precondition (SURVEY.md S4): m on the
        sliding grid and n a multiple of pc.  Misaligned sizes corrupt the
        source's factorization; the C oracle rejects them."""
        m_ok = self.m == self.pr or (
            self.m > self.pr and (self.m - self.pr) % (self.pr - self.pc) == 0)
        return m_ok and self.n % self.pc == 0

    def panel_row_starts(self) -> list[int]:
        """Bottom-to-top panel start rows for one column block (qr.cu:508)."""
        starts = []
        pr_start = self.m - self.pr
        while pr_start > 0:
            starts.append(pr_start)
            pr_start -= self.pr - self.pc
        starts.append(0)
        return starts


def reflector_extent(pr_start: int, col: int, pc_idx: int, pr: int, pc: int,
                     m: int) -> tuple[int, int]:
    """vstart/vend of reflector ``col`` within the panel at row ``pr_start``.

    The four panel cases of qr.cu:104-132, in one place: the bottom panel
    (pr_start == m - pr) runs each reflector to the panel's bottom; every
    other panel stops it early, leaving the pc x pc triangle that the next,
    overlapping panel reduces again.  The top panel (one that crosses the
    diagonal, pr_start <= pc_idx * pc) starts it at the diagonal row.
    Returns (vstart, vend), half-open, in panel-local rows.
    """
    pcol = pc_idx * pc
    bottom = pr_start == m - pr
    top = pr_start <= pcol
    vstart = (pcol - pr_start + col) if top else col
    vend = pr if bottom else (pr - pc + col + 1)
    return vstart, vend
