"""ctypes bindings for the native CABAC packer/decoder (native/cabac.c).

Byte-identical to the Python engine; loaded lazily, with a documented Python
fallback when the .so has not been built (``make -C native``).
"""
from __future__ import annotations

import ctypes
import os

import numpy as np

from . import contexts as C

_LIB = None
_TRIED = False
_SO = os.path.join(os.path.dirname(__file__), "..", "..", "native",
                   "libvvctpu_cabac.so")


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    try:
        lib = ctypes.CDLL(os.path.abspath(_SO))
    except OSError:
        _LIB = None
        return None
    i32p = ctypes.POINTER(ctypes.c_int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.vvc_pack_bins.restype = ctypes.c_int64
    lib.vvc_pack_bins.argtypes = [i32p, i32p, i32p, ctypes.c_int64,
                                  i32p, i32p, i32p, i32p,
                                  u8p, ctypes.c_int64]
    lib.vvc_dec_sizeof.restype = ctypes.c_int64
    lib.vvc_dec_init.restype = None
    lib.vvc_dec_init.argtypes = [ctypes.c_void_p, u8p, ctypes.c_int64]
    # raw-address args: creating ctypes POINTER objects per call costs
    # ~5us x 4 args; cached .ctypes.data ints with c_void_p are ~free
    for name in ("vvc_dec_bin",):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int32
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int32, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.vvc_dec_bypass.restype = ctypes.c_int32
    lib.vvc_dec_bypass.argtypes = [ctypes.c_void_p]
    lib.vvc_dec_bypass_bits.restype = ctypes.c_int32
    lib.vvc_dec_bypass_bits.argtypes = [ctypes.c_void_p, ctypes.c_int32]
    lib.vvc_dec_terminate.restype = ctypes.c_int32
    lib.vvc_dec_terminate.argtypes = [ctypes.c_void_p]
    # hot per-TB entry points: raw-address args (ctypes POINTER casts cost
    # ~5us per argument per call; passing .ctypes.data ints is ~free)
    vp = ctypes.c_void_p
    lib.vvc_tb_bins.restype = ctypes.c_int64
    lib.vvc_tb_bins.argtypes = [vp, ctypes.c_int, ctypes.c_int,
                                ctypes.c_int, vp, vp, vp, vp, vp,
                                ctypes.c_int64, vp]
    lib.vvc_tb_parse.restype = None
    lib.vvc_tb_parse.argtypes = [vp, vp, vp, vp, vp, ctypes.c_int,
                                 ctypes.c_int, ctypes.c_int, vp, vp, vp,
                                 vp]
    _LIB = lib
    return lib


def available() -> bool:
    return _load() is not None


def _i32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def pack_bins(arr: np.ndarray, slice_type: int, qp: int) -> bytes:
    """arr: (N, 3) int32 [kind, ctx, bin].  Returns the codeword bytes."""
    lib = _load()
    st = C.make_ctx_state(slice_type, qp)
    kinds = np.ascontiguousarray(arr[:, 0])
    ctxs = np.ascontiguousarray(arr[:, 1])
    bins = np.ascontiguousarray(arr[:, 2])
    n = len(arr)
    out = np.zeros(n + 4096, np.uint8)
    wrote = lib.vvc_pack_bins(
        _i32p(kinds), _i32p(ctxs), _i32p(bins), n,
        _i32p(st.p0), _i32p(st.p1), _i32p(st.sh0), _i32p(st.sh1),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(out))
    if wrote < 0:
        raise RuntimeError("native packer overflow")
    return out[:wrote].tobytes()


class NativeDecoder:
    """CabacDecoder-compatible wrapper over the C decode engine."""

    def __init__(self, ctx_state, data: bytes):
        self.lib = _load()
        self.ctx = ctx_state
        self._data = np.frombuffer(data, np.uint8).copy()
        self._dec = ctypes.create_string_buffer(
            int(self.lib.vvc_dec_sizeof()))
        self.lib.vvc_dec_init(
            self._dec, self._data.ctypes.data_as(
                ctypes.POINTER(ctypes.c_uint8)), len(self._data))
        # cached raw addresses of the (fixed) context-state arrays
        self._addrs = (ctx_state.p0.ctypes.data, ctx_state.p1.ctypes.data,
                       ctx_state.sh0.ctypes.data, ctx_state.sh1.ctypes.data)
        self._bin = self.lib.vvc_dec_bin

    def bin(self, ctx_id: int) -> int:
        a = self._addrs
        return self._bin(self._dec, ctx_id, a[0], a[1], a[2], a[3])

    def bypass(self) -> int:
        return int(self.lib.vvc_dec_bypass(self._dec))

    def bypass_bits(self, n: int) -> int:
        return int(self.lib.vvc_dec_bypass_bits(self._dec, n))

    def terminate(self) -> int:
        return int(self.lib.vvc_dec_terminate(self._dec))


def pack_bins_state(arr: np.ndarray, st, snap_idx: int = -1):
    """Pack with an explicit CtxState (mutated in place).  Returns
    (payload_bytes, (snap_p0, snap_p1) | None) — snapshot taken after
    consuming ``snap_idx`` bins (WPP context inheritance)."""
    lib = _load()
    lib2 = getattr(lib, "vvc_pack_bins_snap", None)
    kinds = np.ascontiguousarray(arr[:, 0])
    ctxs = np.ascontiguousarray(arr[:, 1])
    bins = np.ascontiguousarray(arr[:, 2])
    n = len(arr)
    out = np.zeros(n + 4096, np.uint8)
    nctx = len(st.p0)
    sp0 = np.zeros(nctx, np.int32)
    sp1 = np.zeros(nctx, np.int32)
    if lib2 is None:
        raise RuntimeError("rebuild native lib for WPP support")
    lib2.restype = ctypes.c_int64
    wrote = lib2(
        _i32p(kinds), _i32p(ctxs), _i32p(bins), ctypes.c_int64(n),
        _i32p(st.p0), _i32p(st.p1), _i32p(st.sh0), _i32p(st.sh1),
        ctypes.c_int64(snap_idx), ctypes.c_int32(nctx),
        _i32p(sp0), _i32p(sp1),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int64(len(out)))
    if wrote < 0:
        raise RuntimeError("native packer overflow")
    snap = (sp0, sp1) if snap_idx >= 0 else None
    return out[:wrote].tobytes(), snap


_RES_CFG = None


def _res_cfg():
    global _RES_CFG
    if _RES_CFG is None:
        _RES_CFG = np.asarray(
            [C.LAST_X.offset, C.LAST_Y.offset, C.CG_FLAG.offset,
             C.SIG_FLAG.offset, C.GT1_FLAG.offset,
             C.PAR_FLAG.offset, C.GT3_FLAG.offset,
             C.SIG_CHROMA_BASE, C.GTX_CHROMA_BASE], np.int32)
    return _RES_CFG


# reusable per-THREAD workspace for the hot per-TB calls (returned arrays
# are always fresh copies, so reuse is safe).  Addresses are cached as raw
# ints: numpy's .ctypes property allocates a helper object per access.
# Thread-local because ctypes releases the GIL during the C call and
# dist/subpic + dist/gop run entropy coding on concurrent threads — a
# process-global workspace would be silently corrupted by parallel calls.
import threading

_WS_TLS = threading.local()


def _workspace():
    ws = getattr(_WS_TLS, "ws", None)
    if ws is None:
        cap = 16 * 1024 + 256          # max TB is 32x32
        ks = np.empty(cap, np.int32)
        cs = np.empty(cap, np.int32)
        bs = np.empty(cap, np.int32)
        wk = np.empty(3 * 1024 + 64, np.int32)
        lv = np.empty(1024, np.int32)
        ws = (ks, cs, bs, wk, lv, ks.ctypes.data, cs.ctypes.data,
              bs.ctypes.data, wk.ctypes.data, lv.ctypes.data)
        _WS_TLS.ws = ws
    return ws


_SCAN_ADDR: dict = {}


def _scan_addr(log2_w, log2_h):
    key = (log2_w, log2_h)
    if key not in _SCAN_ADDR:
        _SCAN_ADDR[key] = _scan(log2_w, log2_h).ctypes.data
    return _SCAN_ADDR[key]


_RES_ADDR = None


def _res_addr():
    global _RES_ADDR
    if _RES_ADDR is None:
        _RES_ADDR = _res_cfg().ctypes.data
    return _RES_ADDR


_SCANS: dict = {}


def _scan(log2_w, log2_h):
    key = (log2_w, log2_h)
    if key not in _SCANS:
        from ..core import rom
        _SCANS[key] = np.ascontiguousarray(
            rom.scan_order(log2_w, log2_h).astype(np.int32))
    return _SCANS[key]


def tb_bins_c(levels: np.ndarray, log2_w: int, log2_h: int,
              is_chroma: bool) -> np.ndarray:
    """(n, 3) int32 bins for one TB via the C binarizer (== binarize.tb_bins
    output order)."""
    lib = _load()
    (kinds, ctxs, bins, _, lev, ka, ca, ba, wa, la) = _workspace()
    n = levels.size
    np.copyto(lev[:n].reshape(levels.shape), levels, casting="unsafe")
    wrote = lib.vvc_tb_bins(
        la, log2_w, log2_h, int(is_chroma),
        _scan_addr(log2_w, log2_h), _res_addr(),
        ka, ca, ba, len(kinds), wa)
    out = np.empty((wrote, 3), np.int32)
    out[:, 0] = kinds[:wrote]
    out[:, 1] = ctxs[:wrote]
    out[:, 2] = bins[:wrote]
    return out


def native_parse_tb(dec: "NativeDecoder", log2_w: int, log2_h: int,
                    is_chroma: bool) -> np.ndarray:
    """Parse one TB directly in C through the native decode engine."""
    lib = _load()
    w, h = 1 << log2_w, 1 << log2_h
    out = np.empty(w * h, np.int32)
    ws = _workspace()
    a = dec._addrs
    lib.vvc_tb_parse(
        ctypes.addressof(dec._dec), a[0], a[1], a[2], a[3], log2_w, log2_h,
        int(is_chroma), _scan_addr(log2_w, log2_h),
        _res_addr(), out.ctypes.data, ws[8])
    return out.reshape(h, w)
