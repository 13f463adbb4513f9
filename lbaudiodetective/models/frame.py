"""Frame: a spectrogram tile with Haar decomposition and sign extraction.

Array-backed analogue of the reference's private LBAudioDetectiveFrame
(LBAudioDetectiveFrame.{h,m}): a max-128-row x 32-col Float32 matrix built row
by row, decomposed in place by the 2-D Haar transform, from which a
subfingerprint's boolean buffer is extracted.  The device pipeline never uses
this class (frames are just tensor reshapes there); it exists for API parity,
for white-box tests mirroring the reference's, and for host-side tooling.

Supports the reference's non-power-of-two decomposition behaviour (the
recursion halves until odd; trailing elements keep their 1/sqrt(n) scale —
exercised by the reference's own 3x4 smoke test, LBAudioDetectiveTests.m:157).
"""

from __future__ import annotations

import numpy as np

from lbaudiodetective.oracle.pipeline import haar_decompose_frame


class Frame:
    def __init__(self, max_rows: int):
        self.max_rows = int(max_rows)
        self.rows: list[np.ndarray] = []
        self.row_length = 0

    # -- reference API (LBAudioDetectiveFrame.h) ----------------------------

    @property
    def number_of_rows(self) -> int:
        return len(self.rows)

    def full(self) -> bool:
        return len(self.rows) >= self.max_rows

    def set_row(self, row: np.ndarray, index: int | None = None) -> bool:
        """Append a row (the reference stores by index but counts appends;
        LBAudioDetectiveFrame.m:86-105)."""
        if self.full():
            return False
        row = np.ascontiguousarray(row, np.float32)
        self.rows.append(row)
        self.row_length = (row.shape[0] if self.row_length == 0
                           else min(self.row_length, row.shape[0]))
        return True

    def get_value(self, row: int, col: int) -> float:
        return float(self.rows[row][col])

    def get_row(self, row: int) -> np.ndarray:
        """The stored row buffer (LBAudioDetectiveFrameGetRow, m:71-73)."""
        return self.rows[row]

    @property
    def fingerprint_length(self) -> int:
        """Boolean count a full extraction buffer holds:
        ``numberOfRows * rowLength * 2`` (m:159-161)."""
        return self.number_of_rows * self.row_length * 2

    @property
    def fingerprint_size(self) -> int:
        """Byte size of that buffer (sizeof(Boolean) == 1; m:155-157)."""
        return self.fingerprint_length

    def clear(self) -> None:
        """Dispose analogue: release the rows (m:33-43)."""
        self.rows = []
        self.row_length = 0

    def as_matrix(self) -> np.ndarray:
        return np.stack([r[: self.row_length] for r in self.rows])

    def copy(self) -> "Frame":
        out = Frame(self.max_rows)
        for r in self.rows:
            out.set_row(r.copy())
        return out

    def decompose(self) -> None:
        """In-place 2-D Haar decomposition (rows then columns)."""
        m = haar_decompose_frame(self.as_matrix())
        self.rows = [m[i].copy() for i in range(m.shape[0])]

    def extract_fingerprint(self, number_of_wavelets: int) -> np.ndarray:
        """Boolean buffer of 2*number_of_wavelets entries: bit 2i = sign+,
        bit 2i+1 = sign- of the i-th largest-|value| coefficient
        (LBAudioDetectiveFrame.m:165-191, stable flat-index tie-break)."""
        flat = self.as_matrix().reshape(-1)
        order = np.argsort(-np.abs(flat), kind="stable")[:number_of_wavelets]
        out = np.zeros(2 * number_of_wavelets, np.uint8)
        vals = flat[order]
        out[0::2] = vals > 0
        out[1::2] = vals < 0
        return out

    def __eq__(self, other) -> bool:
        if not isinstance(other, Frame):
            return NotImplemented
        if (self.row_length != other.row_length
                or self.number_of_rows != other.number_of_rows):
            return False
        return all(np.array_equal(a[: self.row_length], b[: self.row_length])
                   for a, b in zip(self.rows, other.rows))

    __hash__ = None
