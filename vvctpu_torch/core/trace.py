"""Syntax trace — the dtrace equivalent (VTM:CommonLib/dtrace*.cpp).

The reference's standard method for debugging encoder/decoder desync: both
sides emit an identical text trace of coded syntax; the first diverging line
pinpoints the first mismatching syntax element (SURVEY.md §5, --TraceFile /
--TraceRule).  Channels mirror the reference's (D_SYNTAX, D_MODE, D_RESID,
D_HEADER); rules select "CHANNEL:poc_predicate", e.g. "D_SYNTAX:poc>=0" or
"D_MODE:poc==2".

Both the spec codec and the pipeline entropy walker call the same hooks with
the same formatting, so traces also diff cleanly *across engines*.
Zero overhead when disabled (module-level fast-path flag).
"""
from __future__ import annotations

import re

enabled = False
_fh = None
_channels: set[str] = set()
_poc_pred = None
_poc = -1

CHANNELS = ("D_HEADER", "D_SYNTAX", "D_MODE", "D_RESID")


def open_trace(path: str, rule: str = "D_SYNTAX,D_MODE,D_RESID:poc>=0"):
    """rule: comma-separated channels, ':', poc predicate (==N, >=N, <=N)."""
    global enabled, _fh, _channels, _poc_pred
    chans, _, pred = rule.partition(":")
    _channels = {c.strip() for c in chans.split(",") if c.strip()}
    bad = _channels - set(CHANNELS)
    if bad:
        raise ValueError(f"unknown trace channels {bad}")
    m = re.fullmatch(r"poc\s*(==|>=|<=)\s*(\d+)", pred.strip() or "poc>=0")
    if not m:
        raise ValueError(f"bad poc predicate {pred!r}")
    op, n = m.group(1), int(m.group(2))
    _poc_pred = {"==": lambda p: p == n, ">=": lambda p: p >= n,
                 "<=": lambda p: p <= n}[op]
    _fh = open(path, "w")
    enabled = True


def close_trace():
    global enabled, _fh
    if _fh:
        _fh.close()
    _fh = None
    enabled = False


def set_poc(poc: int):
    global _poc
    _poc = poc


def msg(channel: str, text: str):
    if not enabled:
        return
    if channel in _channels and _poc_pred(_poc):
        _fh.write(f"{channel} poc={_poc} {text}\n")


def diff_traces(path_a: str, path_b: str):
    """Returns (line_no, line_a, line_b) of first divergence or None."""
    with open(path_a) as fa, open(path_b) as fb:
        for i, (la, lb) in enumerate(zip(fa, fb)):
            if la != lb:
                return i + 1, la.rstrip(), lb.rstrip()
        ra, rb = fa.readline(), fb.readline()
        if ra or rb:
            return -1, ra.rstrip(), rb.rstrip()
    return None


# shared formatting helpers: spec codec and pipeline walker call these so
# the two engines' traces are byte-identical by construction
def t_split(x, y, s, flag):
    if enabled:
        msg("D_SYNTAX", f"split x={x} y={y} s={s} f={int(flag)}")


def t_leaf_intra(x, y, s, mode):
    if enabled:
        msg("D_MODE", f"leaf x={x} y={y} s={s} intra mode={int(mode)}")


def t_leaf_inter(x, y, s, mv):
    if enabled:
        msg("D_MODE", f"leaf x={x} y={y} s={s} inter mv=({int(mv[0])},"
            f"{int(mv[1])})")


def t_cbf(comp, x, y, s, flag):
    if enabled:
        msg("D_RESID", f"cbf c={comp} x={x} y={y} s={s} f={int(flag)}")
