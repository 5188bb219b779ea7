"""Spec-literal constant tables (round 4, VERDICT r3 ask #4).

The published HEVC/VVC DCT-II matrices (VTM:CommonLib/Rom.cpp g_aiT4..32;
VVC reuses the HEVC DCT2 values for 4..32) are reconstructed here exactly:
every entry is round(64*sqrt(2)*cos(pi*k*(2n+1)/(2N))) snapped to the
published magnitude alphabet — the handful of half-way entries (e.g. the
32-point [1][1] = 89.53 -> 90) resolve to the published value because the
alphabet spacing exceeds the rounding perturbation.  The known quarter-row
anchors are asserted at import, so a wrong reconstruction fails loudly.

Activation: ``VVCTPU_SPEC_TABLES=1`` installs them into
``rom.TR_MATRIX_OVERRIDE`` at import of this module (io/cli wiring), or
call ``install()`` explicitly.  Default remains the generated tables this
round: flipping the default invalidates every stream the round-4 ladder
was measured on — the A/B + flip is queued for round 5 (STATUS.md).
"""
from __future__ import annotations

import math

import numpy as np

from . import rom

# union of the published DCT-II magnitudes for N = 4..32
_ALPHABET = np.array(
    [0, 4, 9, 13, 18, 22, 25, 31, 36, 38, 43, 46, 50, 54, 57, 61, 64, 67,
     70, 73, 75, 78, 80, 82, 83, 85, 87, 88, 89, 90], np.int64)

# published quarter-row anchors (HEVC g_aiT tables; VVC-identical for
# DCT2 4..32): first odd basis row of each size
_ANCHORS = {
    4: (83, 36),
    8: (89, 75, 50, 18),
    16: (90, 87, 80, 70, 57, 43, 25, 9),
    32: (90, 90, 88, 85, 82, 78, 73, 67, 61, 54, 46, 38, 31, 22, 13, 4),
}


def dct2_literal(n: int) -> np.ndarray:
    """(n, n) int64 spec-literal DCT-II matrix (rows = basis functions)."""
    k = np.arange(n)[:, None].astype(np.float64)
    j = np.arange(n)[None, :].astype(np.float64)
    c = 64.0 * math.sqrt(2.0) * np.cos(math.pi * k * (2 * j + 1) / (2 * n))
    c[0, :] = 64.0
    mags = _ALPHABET[np.argmin(
        np.abs(np.abs(c)[..., None] - _ALPHABET[None, None, :]), axis=-1)]
    return (np.sign(np.round(c * 64) / 64) * mags).astype(np.int64)


def _check() -> None:
    for n, row1 in _ANCHORS.items():
        m = dct2_literal(n)
        assert tuple(m[1, :n // 2]) == row1, (n, tuple(m[1, :n // 2]))
        assert (m[0] == 64).all()
        # published matrices are near-orthogonal: G = M M^T has dominant
        # diagonal 64^2*n within ~2%
        g = m @ m.T
        d = np.diag(g).astype(np.float64)
        assert np.all(np.abs(d - 4096 * n) < 0.02 * 4096 * n), n


_check()


def _refresh_kernels() -> None:
    """Drop every memoised copy of the transform matrices: the rom cache,
    the device engine's module-level constant stacks (which snapshot
    rom.tr_matrix at import), and the jax jit caches whose traced graphs
    baked the old constants in.  Required after ANY TR_MATRIX_OVERRIDE
    change at runtime — install and uninstall both route through here
    (VERDICT r4 weak #3: clearing only the rom cache leaves _TX_CONST and
    compiled jits on the old tables)."""
    import sys
    rom.tr_matrix.cache_clear()
    kt = sys.modules.get("vvctpu.kernels.transform")
    if kt is not None:
        for key in list(kt._MATS):
            kt._MATS[key] = np.asarray(rom.tr_matrix(*key), np.int32)
        kt._TX_CONST.clear()
    jax = sys.modules.get("jax")
    if jax is not None:
        jax.clear_caches()


def install() -> None:
    """Install the literal DCT2 matrices into rom.TR_MATRIX_OVERRIDE."""
    for n in (4, 8, 16, 32):
        rom.TR_MATRIX_OVERRIDE[(rom.DCT2, n)] = dct2_literal(n)
    _refresh_kernels()


def uninstall() -> None:
    """Remove the literal matrices and restore the generated defaults."""
    for n in (4, 8, 16, 32):
        rom.TR_MATRIX_OVERRIDE.pop((rom.DCT2, n), None)
    _refresh_kernels()


def installed() -> bool:
    return (rom.DCT2, 4) in rom.TR_MATRIX_OVERRIDE

