"""Build, load and launch the hand-written CUDA kernels (``repro_torch/csrc``).

Route: ``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared`` into a
shared library with a plain C interface, loaded with ``ctypes``.  The
build runs at first use into ``build/kernels/`` at the repository root
(listed in ``.gitignore``), named by a hash of the sources and flags, so
a fresh checkout builds once and later processes reuse the library.
Nothing here runs at import time: CPU-only machines import every module
and never call into CUDA.

A missing ``nvcc``, a failed build or a nonzero ``cudaGetLastError()``
from a launch raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
SOURCES = (CSRC / "hstu_rank_attn.cu",)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIB = None
BUILD_LOG = ""        # nvcc's output (ptxas registers / shared memory / spills)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME:
        path = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(path):
            return path
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels of "
                       "repro_torch are built from source at first use")


def build() -> Path:
    """Compile the sources (once per content hash) and return the
    library's path."""
    global BUILD_LOG
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        h.update(src.read_bytes())
    lib = BUILD_DIR / f"hstu_rank_attn-{h.hexdigest()[:16]}.so"
    log = lib.with_suffix(".log")
    if lib.exists():
        BUILD_LOG = log.read_text() if log.exists() else ""
        return lib
    nvcc = _nvcc()                  # raises before anything is written
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, *map(str, SOURCES)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    BUILD_LOG = proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{BUILD_LOG}")
    log.write_text(BUILD_LOG)
    os.replace(tmp, lib)      # atomic: concurrent builders never see half a file
    return lib


class RankAttnParams(ctypes.Structure):
    """Mirror of ``struct RankAttnParams`` in ``csrc/hstu_rank_attn.cu``."""
    _Strides = ctypes.c_longlong * 3
    _fields_ = [
        ("q", ctypes.c_void_p), ("q_stride", _Strides),
        ("k_new", ctypes.c_void_p), ("kn_stride", _Strides),
        ("v_new", ctypes.c_void_p), ("vn_stride", _Strides),
        ("k_pre", ctypes.c_void_p), ("kp_stride", _Strides),
        ("v_pre", ctypes.c_void_p), ("vp_stride", _Strides),
        ("k_pool", ctypes.c_void_p), ("v_pool", ctypes.c_void_p),
        ("k_table", ctypes.c_void_p), ("v_table", ctypes.c_void_p),
        ("kt_stride", ctypes.c_longlong), ("vt_stride", ctypes.c_longlong),
        ("prefix_lens", ctypes.c_void_p),
        ("out", ctypes.c_void_p), ("o_stride", _Strides),
        ("B", ctypes.c_int), ("H", ctypes.c_int), ("Sq", ctypes.c_int),
        ("D", ctypes.c_int), ("n_prefix", ctypes.c_int),
        ("n_incr", ctypes.c_int), ("page_tokens", ctypes.c_int),
        ("paged", ctypes.c_int), ("scale", ctypes.c_float),
        ("n_total", ctypes.c_float),
    ]


def library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        lib.hstu_rank_attn_f32.argtypes = [ctypes.POINTER(RankAttnParams),
                                           ctypes.c_void_p]
        lib.hstu_rank_attn_f32.restype = ctypes.c_int
        lib.hstu_rank_attn_error.argtypes = [ctypes.c_int]
        lib.hstu_rank_attn_error.restype = ctypes.c_char_p
        lib.hstu_rank_attn_struct_size.restype = ctypes.c_int
        if lib.hstu_rank_attn_struct_size() != ctypes.sizeof(RankAttnParams):
            raise RuntimeError("RankAttnParams layout differs between "
                               "Python and the CUDA source")
        _LIB = lib
    return _LIB


# --- launch -------------------------------------------------------------------

HEAD_DIMS = (32, 64, 128)


def _view(t: torch.Tensor, name: str, device) -> torch.Tensor:
    """A (B, H, S, D) float32 view the kernel can read: unit stride on D,
    16-byte aligned rows.  Anything else is refused, never copied."""
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: the CUDA kernel computes in float32 only, "
                        f"got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dim() != 4 or t.stride(3) != 1 or any(s % 4 for s in t.stride()[:3]) \
            or t.data_ptr() % 16:
        raise ValueError(f"{name}: need a 4-d view with unit last stride and "
                         f"16-byte aligned rows, got shape {tuple(t.shape)} "
                         f"strides {t.stride()}")
    return t


def _strides(t):
    return RankAttnParams._Strides(*t.stride()[:3])


def rank_attn(q, k_new, v_new, *, n_incr: int, n_total: float,
              prefix=None, pages=None) -> torch.Tensor:
    """Launch the HSTU rank kernel on q's CUDA device and stream.

    q, k_new, v_new: (B, H, Sq, D) float32 views.
    prefix: optional dense (k_pre, v_pre), each (B, H, P, D).
    pages:  optional (k_pool, v_pool, k_table, v_table, prefix_lens) with
            pools (N + 1, page_tokens, H, D), tables (B, n_pages) int32
            (any row stride, unit column stride), prefix_lens (B,) int32.
    Returns out (B, H, Sq, D) float32, a view of a (B, Sq, H, D) tensor.
    The caller counts the launch."""
    device = q.device
    if device.type != "cuda":
        raise ValueError(f"rank_attn launches on CUDA tensors, got {device}")
    B, H, Sq, D = q.shape
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not compiled (have {HEAD_DIMS})")
    q = _view(q, "q", device)
    k_new, v_new = _view(k_new, "k_new", device), _view(v_new, "v_new", device)
    for name, t in (("k_new", k_new), ("v_new", v_new)):
        if tuple(t.shape) != (B, H, Sq, D):
            raise ValueError(f"{name} shape {tuple(t.shape)} != q's")
    # written through strides in the model layout (B, Sq, H, D), so the
    # caller's swap back to it is a view and the next reshape is free
    out = torch.empty((B, Sq, H, D), dtype=torch.float32,
                      device=device).transpose(1, 2)
    p = RankAttnParams(
        q=q.data_ptr(), q_stride=_strides(q), k_new=k_new.data_ptr(),
        kn_stride=_strides(k_new), v_new=v_new.data_ptr(),
        vn_stride=_strides(v_new), out=out.data_ptr(), o_stride=_strides(out),
        B=B, H=H, Sq=Sq, D=D, n_incr=int(n_incr), n_prefix=0,
        page_tokens=1, paged=0, scale=1.0 / float(D) ** 0.5,
        n_total=float(n_total))
    if prefix is not None:
        kp, vp = (_view(t, n, device) for t, n in zip(prefix, ("k_pre", "v_pre")))
        if kp.shape != vp.shape or tuple(kp.shape[:2]) != (B, H) \
                or kp.shape[3] != D:
            raise ValueError(f"prefix shapes {tuple(kp.shape)} / "
                             f"{tuple(vp.shape)} do not match q {(B, H, Sq, D)}")
        p.k_pre, p.kp_stride = kp.data_ptr(), _strides(kp)
        p.v_pre, p.vp_stride = vp.data_ptr(), _strides(vp)
        p.n_prefix = kp.shape[2]
    elif pages is not None:
        k_pool, v_pool, k_table, v_table, plens = pages
        for name, t in (("k_pool", k_pool), ("v_pool", v_pool)):
            if t.dtype != torch.float32 or t.device != device \
                    or not t.is_contiguous() or t.dim() != 4 \
                    or tuple(t.shape[2:]) != (H, D) or t.data_ptr() % 16:
                raise ValueError(f"{name}: need a contiguous float32 "
                                 f"(N + 1, page_tokens, {H}, {D}) pool on "
                                 f"{device}, got {tuple(t.shape)} {t.dtype}")
        if k_pool.shape[1] != v_pool.shape[1]:
            raise ValueError("K and V pools differ in page_tokens")
        for name, t in (("k_table", k_table), ("v_table", v_table),
                        ("prefix_lens", plens)):
            if t.dtype != torch.int32 or t.device != device:
                raise ValueError(f"{name}: need int32 on {device}, got "
                                 f"{t.dtype} on {t.device}")
        if k_table.shape != v_table.shape or k_table.dim() != 2 \
                or k_table.shape[0] != B or k_table.stride(1) != 1 \
                or v_table.stride(1) != 1 or tuple(plens.shape) != (B,) \
                or not plens.is_contiguous():
            raise ValueError(f"page tables {tuple(k_table.shape)} / "
                             f"{tuple(v_table.shape)} and prefix_lens "
                             f"{tuple(plens.shape)} do not fit batch {B}")
        pt = k_pool.shape[1]
        p.k_pool, p.v_pool = k_pool.data_ptr(), v_pool.data_ptr()
        p.k_table, p.kt_stride = k_table.data_ptr(), k_table.stride(0)
        p.v_table, p.vt_stride = v_table.data_ptr(), v_table.stride(0)
        p.prefix_lens = plens.data_ptr()
        p.n_prefix, p.page_tokens, p.paged = k_table.shape[1] * pt, pt, 1
    lib = library()
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = lib.hstu_rank_attn_f32(ctypes.byref(p), ctypes.c_void_p(stream))
    if err:
        raise RuntimeError(f"hstu_rank_attn launch failed: "
                           f"{lib.hstu_rank_attn_error(err).decode()}")
    return out
