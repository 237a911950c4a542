"""Build, load and launch the hand-written CUDA kernels (``repro_torch/csrc``).

Route: each unit -- a source, and the rank and SSD sources once per
input type (``-DREPRO_KERNEL_TYPE=0`` float32, ``1`` bfloat16) -- is
compiled by its own ``nvcc -gencode arch=compute_90a,code=sm_90a -O3
-c`` (all started together), and the objects are linked into one shared
library with a plain C interface,
loaded with ``ctypes``.  The build runs at first use into
``build/kernels/`` at the repository root (listed in ``.gitignore``),
named by a hash of the sources and flags, so a fresh checkout builds
once and later processes reuse the library.  Nothing here runs at import
time: CPU-only machines import every module and never call into CUDA.

A missing ``nvcc``, a failed build or a nonzero ``cudaGetLastError()``
from a launch raises; there is no fallback.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
SOURCES = (CSRC / "hstu_rank_attn.cu", CSRC / "ssd_chunk.cu",
           CSRC / "decode_attn.cu")
# (source, object name, flags): the templated sources once per input
# type, so the two halves compile in parallel
UNITS = tuple((src, f"{src.stem}_{t}", (f"-DREPRO_KERNEL_TYPE={i}",))
              for src in SOURCES[:2] for i, t in enumerate(("f32", "bf16"))
              ) + ((SOURCES[2], SOURCES[2].stem, ()),)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

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


def _run_all(cmds):
    """Run the commands in parallel; return (rc, output) of each."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]    # drains each pipe fully
    return [(p.returncode, out) for p, out in zip(procs, outs)]


def build() -> Path:
    """Compile the sources (once per content hash) and return the
    library's path."""
    global BUILD_LOG
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update(repr([(name, flags) for _, name, flags in UNITS]).encode())
    for src in SOURCES:
        h.update(src.read_bytes())
    lib = BUILD_DIR / f"repro_kernels-{h.hexdigest()[:16]}.so"
    log = lib.with_suffix(".log")
    if lib.exists():
        BUILD_LOG = log.read_text() if log.exists() else ""
        return lib
    nvcc = _nvcc()                  # raises before anything is written
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, name + ".o") for _, name, _ in UNITS]
        cmds = [[nvcc, *NVCC_FLAGS, *flags, "-c", "-o", o, str(src)]
                for (src, _, flags), o in zip(UNITS, objs)]
        so = os.path.join(tmp, "lib.so")
        results = _run_all(cmds)
        if all(rc == 0 for rc, _ in results):
            cmds.append([nvcc, *ARCH, "-shared", "-o", so, *objs])
            results += _run_all(cmds[-1:])
        BUILD_LOG = "".join(f"$ {' '.join(c)}\n{out}"
                            for c, (_, out) in zip(cmds, results))
        if any(rc != 0 for rc, _ in results):
            raise RuntimeError(f"nvcc failed:\n{BUILD_LOG}")
        log.write_text(BUILD_LOG)
        os.replace(so, lib)   # atomic: another process never sees half a file
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
        ("page_pos", ctypes.c_void_p), ("pp_stride", ctypes.c_longlong),
        ("page_valid", ctypes.c_void_p), ("pv_stride", ctypes.c_longlong),
        ("q_pos", ctypes.c_void_p), ("qp_stride", ctypes.c_longlong),
        ("segment", ctypes.c_int),
        ("q_rows", ctypes.c_int), ("cluster", ctypes.c_int),
        ("kpool_stride", _Strides), ("vpool_stride", _Strides),
        ("kpool_pages", ctypes.c_longlong), ("vpool_pages", ctypes.c_longlong),
    ]


class SsdParams(ctypes.Structure):
    """Mirror of ``struct SsdParams`` in ``csrc/ssd_chunk.cu``."""
    _S3 = ctypes.c_longlong * 3
    _S4 = ctypes.c_longlong * 4
    _fields_ = [
        ("C", ctypes.c_void_p), ("c_stride", _S3),
        ("Bm", ctypes.c_void_p), ("b_stride", _S3),
        ("x", ctypes.c_void_p), ("x_stride", _S4),
        ("cum", ctypes.c_void_p), ("cum_stride", _S4),
        ("dt", ctypes.c_void_p), ("dt_stride", _S4),
        ("out", ctypes.c_void_p), ("o_stride", _S4),
        ("B", ctypes.c_int), ("nc", ctypes.c_int), ("Q", ctypes.c_int),
        ("H", ctypes.c_int), ("N", ctypes.c_int), ("P", ctypes.c_int),
        ("heads_per_block", ctypes.c_int), ("out_bf16", ctypes.c_int),
    ]


class DecodeParams(ctypes.Structure):
    """Mirror of ``struct DecodeParams`` in ``csrc/decode_attn.cu``."""
    _S2 = ctypes.c_longlong * 2
    _S3 = ctypes.c_longlong * 3
    _fields_ = [
        ("q", ctypes.c_void_p), ("q_stride", _S2),
        ("k", ctypes.c_void_p), ("k_stride", _S3),
        ("v", ctypes.c_void_p), ("v_stride", _S3),
        ("out", ctypes.c_void_p), ("o_stride", _S2),
        ("lse", ctypes.c_void_p), ("lse_stride", ctypes.c_longlong),
        ("B", ctypes.c_int), ("H", ctypes.c_int), ("KV", ctypes.c_int),
        ("S", ctypes.c_int), ("D", ctypes.c_int), ("n_split", ctypes.c_int),
        ("keys_per_split", ctypes.c_int), ("heads_per_block", ctypes.c_int),
        ("dtype", ctypes.c_int), ("scale", ctypes.c_float),
    ]


# the input types the rank and SSD kernels take, by the suffix of their C
# launchers (``hstu_rank_attn_bf16``, ``ssd_chunk_state_f32``, ...): the
# Pallas kernels take either float type and widen it to float32 on load
TYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}

# (C launcher, params struct, name of its sizeof export)
_LAUNCHERS = {
    **{f"hstu_rank_attn_{t}": (RankAttnParams, "hstu_rank_attn_struct_size")
       for t in TYPES.values()},
    **{f"ssd_chunk_{kind}_{t}": (SsdParams, "ssd_chunk_struct_size")
       for kind in ("intra", "state") for t in TYPES.values()},
    "decode_attn": (DecodeParams, "decode_attn_struct_size"),
}


def library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        for fn, (struct, size_fn) in _LAUNCHERS.items():
            getattr(lib, fn).argtypes = [ctypes.POINTER(struct),
                                         ctypes.c_void_p]
            getattr(lib, fn).restype = ctypes.c_int
            getattr(lib, size_fn).restype = ctypes.c_int
            if getattr(lib, size_fn)() != ctypes.sizeof(struct):
                raise RuntimeError(f"{struct.__name__} layout differs "
                                   f"between Python and the CUDA source")
        lib.hstu_rank_attn_error.argtypes = [ctypes.c_int]
        lib.hstu_rank_attn_error.restype = ctypes.c_char_p
        for fn, value in (("decode_attn_max_splits", DECODE_MAX_SPLITS),
                          ("hstu_rank_attn_max_cluster", RANK_MAX_CLUSTER),
                          ("hstu_rank_attn_max_q_rows", RANK_MAX_Q_ROWS)):
            getattr(lib, fn).restype = ctypes.c_int
            if getattr(lib, fn)() != value:
                raise RuntimeError(f"{fn}() differs from the Python constant")
        _LIB = lib
    return _LIB


def _launch(fn: str, params, device):
    """Call C launcher ``fn`` on ``device``'s current stream; raise on a
    nonzero CUDA error (a refused launch never runs)."""
    lib = library()
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = getattr(lib, fn)(ctypes.byref(params), ctypes.c_void_p(stream))
    if err:
        raise RuntimeError(f"{fn} launch failed ({err}): "
                           f"{lib.hstu_rank_attn_error(err).decode()}")


# --- HSTU rank attention -------------------------------------------------------

HEAD_DIMS = (32, 64, 128)
RANK_KEY_TILE = 64          # keys per tile (BK in the source)
RANK_MAX_Q_ROWS = 128       # one block: 8 warps of 16 query rows (MAX_Q_ROWS)
RANK_LONG_Q_ROWS = 64       # the q-tile once Sq exceeds one block
RANK_MAX_CLUSTER = 8        # what the kernel takes (MAX_CLUSTER, portable)
# the plan's cluster: about RANK_TILES_PER_BLOCK key tiles a block, at
# most RANK_PLAN_CLUSTER blocks: an H100 holds 30 clusters of 8 blocks of
# the Sq-80 rank at once and 32 of 7, so the batched rank's 32 (B 8 x
# H 4) take two waves at 8 and one at 7 (tools/rank_plan_sweep.py)
RANK_TILES_PER_BLOCK = 5
RANK_PLAN_CLUSTER = 7


@functools.lru_cache(maxsize=256)
def rank_launch_plan(n_prefix: int, Sq: int) -> tuple[int, int]:
    """(q_rows, cluster) for a rank launch over ``n_prefix`` prefix keys
    and ``Sq`` new tokens.  A block holds q_rows queries, 16 per warp: all
    of Sq when Sq <= RANK_MAX_Q_ROWS (every prefix tile is then read once
    per (b, h)), else RANK_LONG_Q_ROWS.  ``cluster`` blocks share each
    (b, h, q-tile) and take its key tiles in turn: enough that each takes
    about RANK_TILES_PER_BLOCK of the tiles a q-tile multiplies (a causal
    q-tile of several sees about half the new-token tiles), at most
    RANK_PLAN_CLUSTER.  A function of (n_prefix, Sq) only -- never of the
    batch or the data -- so a row's summation order ignores its batch,
    and dense, paged and segment launches at equal padded length split
    alike."""
    if n_prefix < 0 or Sq < 1:
        raise ValueError(f"rank_launch_plan needs n_prefix >= 0 and Sq >= 1, "
                         f"got n_prefix={n_prefix} Sq={Sq}")
    new_tiles = -(-Sq // RANK_KEY_TILE)
    if Sq <= RANK_MAX_Q_ROWS:
        q_rows, work = 16 * -(-Sq // 16), new_tiles
    else:
        q_rows, work = RANK_LONG_Q_ROWS, -(-new_tiles // 2)
    work += -(-n_prefix // RANK_KEY_TILE)
    cluster = min(RANK_PLAN_CLUSTER, -(-work // RANK_TILES_PER_BLOCK))
    return q_rows, cluster


def _dtype(t: torch.Tensor, name: str, kernel: str) -> torch.dtype:
    """t's type if ``kernel`` takes it (float32 or bfloat16), else a
    TypeError."""
    if t.dtype not in TYPES:
        raise TypeError(f"{name}: the {kernel} kernel takes float32 or "
                        f"bfloat16, got {t.dtype}")
    return t.dtype


def _view(t: torch.Tensor, name: str, device, dtype,
          dims: int = 4) -> torch.Tensor:
    """A ``dims``-d view of the launch's ``dtype`` on ``device`` that a
    kernel can read: a unit last stride, and rows that start on 16 bytes
    (the first element and every outer stride, counted in bytes; a
    strided bf16 slice of the model's xBC qualifies where its offset and
    row stride do).  Anything else is refused, never copied."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: need the launch's {dtype}, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    esz = t.element_size()
    if t.dim() != dims or t.stride(-1) != 1 or t.data_ptr() % 16 \
            or any(st * esz % 16 for st in t.stride()[:-1]):
        raise ValueError(f"{name}: need a {dims}-d view with unit last "
                         f"stride and 16-byte aligned rows, got shape "
                         f"{tuple(t.shape)} strides {t.stride()} ({t.dtype})")
    return t


def _strides(t):
    return RankAttnParams._Strides(*t.stride()[:3])


# TMA's rules for a tensor map and its box (cuTensorMapEncodeTiled) as the
# paged loader uses them: dims (D, H, page_tokens, N + 1) innermost first,
# one box (IN, 1, page_tokens, 1) per page and column block, written
# through a W-byte swizzle, W = min(128, D x the value's bytes)
TMA_MAX_BOX = 256            # each box dimension
TMA_MAX_DIM = 1 << 32        # each tensor dimension
TMA_MAX_STRIDE = 1 << 40     # each stride, in bytes
TMA_SMEM_ALIGN = 128         # a box's destination in shared memory


def tma_pool_geometry(shape, strides, dtype, data_ptr: int,
                      name: str = "pool") -> dict:
    """The TMA boxes through which the paged rank kernel loads a page
    pool of ``shape`` (N + 1, page_tokens, H, D), ``strides`` in values,
    ``dtype`` float32 or bfloat16, starting at ``data_ptr``: a dict of
    ``swizzle`` (W, the bytes of a box row), ``inner`` (the values of a
    box row), ``boxes`` (column blocks a page, for K or V), ``box`` (the
    box dims, innermost first) and ``page_bytes`` (one page's bytes of
    one head, K or V).  A pool that TMA cannot take raises a ValueError
    that names the rule it breaks."""
    if data_ptr % 16:
        raise ValueError(f"{name}: TMA needs a 16-byte aligned global "
                         f"address, got one {data_ptr % 16} bytes past it")
    return dict(_pool_geometry(tuple(shape), tuple(strides), dtype, name))


@functools.lru_cache(maxsize=64)
def _pool_geometry(shape, strides, dtype, name):
    """``tma_pool_geometry`` but the address, once per pool layout."""
    if len(shape) != 4 or len(strides) != 4:
        raise ValueError(f"{name}: need a 4-d (N + 1, page_tokens, H, D) "
                         f"pool, got shape {tuple(shape)}")
    n1, pt, H, D = (int(x) for x in shape)
    tma_strides(shape, strides, dtype, name, ("page", "token", "head"))
    if not 1 <= n1 <= TMA_MAX_DIM:
        raise ValueError(f"{name}: TMA dimensions must lie in [1, 2**32], "
                         f"the pool has {n1} pages")
    return tma_page_box(pt, D, dtype, name)


@functools.lru_cache(maxsize=64)
def tma_strides(shape, strides, dtype, name: str, dims) -> None:
    """TMA's rules for the strides of a tensor map over a 4-d view of
    ``shape`` whose innermost dim (D) is read: that dim contiguous, and
    each outer stride (``dims`` names them, outermost first) a multiple
    of 16 bytes below 2**40, and not 0 where its dim holds more than one
    row (a size-1 dim's stride is never used).  A ValueError names the
    rule a view breaks (every argument hashable: checked once a layout).
    """
    esz = torch.finfo(dtype).bits // 8
    if strides[3] != 1:
        raise ValueError(f"{name}: TMA reads the innermost dimension (D) "
                         f"contiguously, need stride 1, got {strides[3]}")
    for dim, n, st in zip(dims, shape[:3], strides[:3]):
        if st * esz % 16 or st < 0:
            raise ValueError(f"{name}: TMA strides must be multiples of 16 "
                             f"bytes, the {dim} stride is {st * esz} bytes "
                             f"(strides {tuple(strides)})")
        if st * esz >= TMA_MAX_STRIDE:
            raise ValueError(f"{name}: TMA strides must be below 2**40 "
                             f"bytes, the {dim} stride is {st * esz}")
        if st == 0 and n > 1:
            raise ValueError(f"{name}: TMA strides must be positive, the "
                             f"{dim} stride is 0 over {n} rows (an "
                             f"expanded view; strides {tuple(strides)})")


def tma_page_box(page_tokens: int, head_dim: int, dtype,
                 name: str = "pool") -> dict:
    """The TMA box of one page of one head (``page_tokens`` rows of
    ``head_dim`` values of ``dtype``) as the paged loader writes it to
    shared memory; the geometry part of ``tma_pool_geometry``, which
    ``core.paging.PageLayout`` asks when a page size is chosen.  A page
    size the loader cannot take raises a ValueError naming the rule."""
    esz = torch.finfo(dtype).bits // 8
    pt, D = int(page_tokens), int(head_dim)
    if pt < 1 or RANK_KEY_TILE % pt:
        raise ValueError(f"{name}: page_tokens {pt} must divide the "
                         f"{RANK_KEY_TILE}-key tile (1, 2, 4, 8, 16, 32 "
                         f"or 64): the tile is whole pages")
    w = min(128, D * esz)
    inner = w // esz
    box = (inner, 1, pt, 1)
    if max(box) > TMA_MAX_BOX:
        raise ValueError(f"{name}: each TMA box dimension must be <= "
                         f"{TMA_MAX_BOX}, got box {box}")
    if pt * w % TMA_SMEM_ALIGN:
        raise ValueError(f"{name}: a TMA box's shared-memory destination "
                         f"must be {TMA_SMEM_ALIGN}-byte aligned: "
                         f"page_tokens x {w}-byte rows = {pt * w} bytes "
                         f"per page box is not a multiple of it")
    return dict(swizzle=w, inner=inner, boxes=D * esz // w, box=box,
                page_bytes=pt * D * esz)


def _int_rows(t, name: str, shape, device):
    """An int32 (rows, n) table on ``device`` with a unit column stride
    (any row stride); anything else is refused."""
    if t.dtype != torch.int32 or t.device != device:
        raise ValueError(f"{name}: need int32 on {device}, got {t.dtype} "
                         f"on {t.device}")
    if tuple(t.shape) != tuple(shape) or t.stride(1) != 1:
        raise ValueError(f"{name}: need shape {tuple(shape)} with a unit "
                         f"column stride, got {tuple(t.shape)} strides "
                         f"{t.stride()}")
    return t


def rank_attn(q, k_new, v_new, *, n_incr: int, n_total: float,
              prefix=None, pages=None, spans=None) -> torch.Tensor:
    """Launch the HSTU rank kernel on q's CUDA device and stream.

    q, k_new, v_new: (B, H, Sq, D) views, float32 or bfloat16; every
            K/V input (prefix, pools) has q's type.
    prefix: optional dense (k_pre, v_pre), each (B, H, P, D).
    pages:  optional (k_pool, v_pool, k_table, v_table, prefix_lens) with
            pools (N + 1, page_tokens, H, D) that TMA can read
            (``tma_pool_geometry``; page_tokens divides 64), tables
            (B, n_pages) int32
            (any row stride, unit column stride), prefix_lens (B,) int32,
            or None with ``spans``.
    spans:  with pages, the segment mode: (page_pos, page_valid, q_pos),
            the first two (B, n_pages) int32, q_pos (B, Sq) int32, each
            with a unit column stride.
    Returns out (B, H, Sq, D) in q's type, a view of a (B, Sq, H, D)
    tensor.  The caller counts the launch."""
    device = q.device
    if device.type != "cuda":
        raise ValueError(f"rank_attn launches on CUDA tensors, got {device}")
    B, H, Sq, D = q.shape
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not compiled (have {HEAD_DIMS})")
    dtype = _dtype(q, "q", "rank")
    q = _view(q, "q", device, dtype)
    k_new = _view(k_new, "k_new", device, dtype)
    v_new = _view(v_new, "v_new", device, dtype)
    for name, t in (("k_new", k_new), ("v_new", v_new)):
        if tuple(t.shape) != (B, H, Sq, D):
            raise ValueError(f"{name} shape {tuple(t.shape)} != q's")
    # written through strides in the model layout (B, Sq, H, D), so the
    # caller's swap back to it is a view and the next reshape is free
    out = torch.empty((B, Sq, H, D), dtype=dtype,
                      device=device).transpose(1, 2)
    p = RankAttnParams(
        q=q.data_ptr(), q_stride=_strides(q), k_new=k_new.data_ptr(),
        kn_stride=_strides(k_new), v_new=v_new.data_ptr(),
        vn_stride=_strides(v_new), out=out.data_ptr(), o_stride=_strides(out),
        B=B, H=H, Sq=Sq, D=D, n_incr=int(n_incr), n_prefix=0,
        page_tokens=1, paged=0, scale=1.0 / float(D) ** 0.5,
        n_total=float(n_total))
    if spans is not None and pages is None:
        raise ValueError("the segment mode reads its spans from pages")
    if prefix is not None:
        kp, vp = (_view(t, n, device, dtype)
                  for t, n in zip(prefix, ("k_pre", "v_pre")))
        if kp.shape != vp.shape or tuple(kp.shape[:2]) != (B, H) \
                or kp.shape[3] != D:
            raise ValueError(f"prefix shapes {tuple(kp.shape)} / "
                             f"{tuple(vp.shape)} do not match q {(B, H, Sq, D)}")
        p.k_pre, p.kp_stride = kp.data_ptr(), _strides(kp)
        p.v_pre, p.vp_stride = vp.data_ptr(), _strides(vp)
        p.n_prefix = kp.shape[2]
    elif pages is not None:
        k_pool, v_pool, k_table, v_table, plens = pages
        if (plens is None) == (spans is None):
            raise ValueError("a paged launch takes prefix_lens or spans, "
                             "exactly one")
        for name, t in (("k_pool", k_pool), ("v_pool", v_pool)):
            if t.dtype != dtype:
                raise TypeError(f"{name}: need {dtype} as q, got {t.dtype}")
            if t.device != device or t.dim() != 4 \
                    or tuple(t.shape[2:]) != (H, D):
                raise ValueError(f"{name}: need a {dtype} "
                                 f"(N + 1, page_tokens, {H}, {D}) pool on "
                                 f"{device}, got {tuple(t.shape)} {t.dtype} "
                                 f"on {t.device}")
            tma_pool_geometry(t.shape, t.stride(), dtype, t.data_ptr(), name)
        # the new K and V are read through tensor maps of their own
        for name, t in (("k_new", k_new), ("v_new", v_new)):
            tma_strides(tuple(t.shape), t.stride(), dtype, name,
                        ("batch", "head", "token"))
        if k_pool.shape[1] != v_pool.shape[1]:
            raise ValueError("K and V pools differ in page_tokens")
        if k_table.dim() != 2 or k_table.shape[0] != B:
            raise ValueError(f"page table {tuple(k_table.shape)} does not "
                             f"fit batch {B}")
        rows = tuple(k_table.shape)
        for name, t in (("k_table", k_table), ("v_table", v_table)):
            _int_rows(t, name, rows, device)
        pt = k_pool.shape[1]
        p.k_pool, p.v_pool = k_pool.data_ptr(), v_pool.data_ptr()
        p.kpool_stride, p.vpool_stride = _strides(k_pool), _strides(v_pool)
        p.kpool_pages, p.vpool_pages = k_pool.shape[0], v_pool.shape[0]
        p.k_table, p.kt_stride = k_table.data_ptr(), k_table.stride(0)
        p.v_table, p.vt_stride = v_table.data_ptr(), v_table.stride(0)
        p.n_prefix, p.page_tokens, p.paged = k_table.shape[1] * pt, pt, 1
        if spans is None:
            if plens.dtype != torch.int32 or plens.device != device \
                    or tuple(plens.shape) != (B,) or not plens.is_contiguous():
                raise ValueError(f"prefix_lens: need a contiguous int32 "
                                 f"({B},) on {device}, got {plens.dtype} "
                                 f"{tuple(plens.shape)} on {plens.device}")
            p.prefix_lens = plens.data_ptr()
        else:
            page_pos, page_valid, q_pos = spans
            _int_rows(page_pos, "page_pos", rows, device)
            _int_rows(page_valid, "page_valid", rows, device)
            _int_rows(q_pos, "q_pos", (B, Sq), device)
            p.page_pos, p.pp_stride = page_pos.data_ptr(), page_pos.stride(0)
            p.page_valid, p.pv_stride = (page_valid.data_ptr(),
                                         page_valid.stride(0))
            p.q_pos, p.qp_stride = q_pos.data_ptr(), q_pos.stride(0)
            p.segment = 1
    p.q_rows, p.cluster = rank_launch_plan(p.n_prefix, Sq)
    _launch(f"hstu_rank_attn_{TYPES[dtype]}", p, device)
    return out


# --- SSD chunk stages ----------------------------------------------------------

SSD_HEAD_DIMS = (32, 64, 128)
SSD_MAX_CHUNK = 128
# ssd_chunk_intra: the most heads that share one block's C B^T; 16 keep
# two blocks of 113 KB on an SM at P = N = 64, and beat 8 at the Zamba2
# prefill on the H100 (tools/ssd_intra_sweep.py --plans 8)
SSD_INTRA_HEADS_PER_BLOCK = 16
SSD_STATE_HEADS_PER_BLOCK = 32   # ssd_chunk_state: B and weights shared by 32


def ssd_intra_heads_per_block(H: int) -> int:
    """Heads per ``ssd_chunk_intra`` block: the fewest blocks of at most
    SSD_INTRA_HEADS_PER_BLOCK heads that cover H, each block as small as
    that count allows (H 13 runs as 7 + 6, not 8 + 5).  A function of H
    only, never of the batch or the data, so a row's result does not
    depend on its batch."""
    if H < 1:
        raise ValueError(f"ssd_intra_heads_per_block needs H >= 1, got {H}")
    groups = -(-H // SSD_INTRA_HEADS_PER_BLOCK)
    return -(-H // groups)


def ssd_chunk(kind: str, Cc, Bc, xc, cum, dtc, out_dtype=None) -> torch.Tensor:
    """Launch ``ssd_chunk_intra`` (kind "intra", returns (B, nc, Q, H, P))
    or ``ssd_chunk_state`` (kind "state", ``Cc`` unused, returns
    (B, nc, H, N, P) float32) on xc's CUDA device and stream.  Inputs as
    in ``kernels/ssd_chunk.py``: C, B and x float32 or bfloat16 alike,
    cum and dt float32.  The intra output is ``out_dtype``, xc's type by
    default (float32 from bfloat16 inputs too).  The caller counts the
    launch."""
    device = xc.device
    if device.type != "cuda":
        raise ValueError(f"ssd_chunk launches on CUDA tensors, got {device}")
    dtype = _dtype(xc, "xc", "SSD")
    xc = _view(xc, "xc", device, dtype, 5)
    B, nc, Q, H, P = xc.shape
    Bc = _view(Bc, "Bc", device, dtype)
    N = Bc.shape[3]
    if P not in SSD_HEAD_DIMS:
        raise ValueError(f"head dim P={P} not compiled (have {SSD_HEAD_DIMS})")
    if not (1 <= Q <= SSD_MAX_CHUNK) or N % 16 or not 16 <= N <= 128:
        raise ValueError(f"need chunk Q <= {SSD_MAX_CHUNK} and state width N "
                         f"a multiple of 16 in [16, 128], got Q={Q} N={N}")
    if tuple(Bc.shape) != (B, nc, Q, N):
        raise ValueError(f"Bc shape {tuple(Bc.shape)} != {(B, nc, Q, N)}")
    for name, t in (("cum", cum), ("dtc", dtc)):
        if t.dtype != torch.float32 or t.device != device \
                or tuple(t.shape) != (B, nc, Q, H):
            raise ValueError(f"{name}: need float32 {(B, nc, Q, H)} on "
                             f"{device}, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
    p = SsdParams(Bm=Bc.data_ptr(), b_stride=SsdParams._S3(*Bc.stride()[:3]),
                  x=xc.data_ptr(), x_stride=SsdParams._S4(*xc.stride()[:4]),
                  cum=cum.data_ptr(), cum_stride=SsdParams._S4(*cum.stride()),
                  dt=dtc.data_ptr(), dt_stride=SsdParams._S4(*dtc.stride()),
                  B=B, nc=nc, Q=Q, H=H, N=N, P=P,
                  heads_per_block=ssd_intra_heads_per_block(H) if kind == "intra"
                  else min(H, SSD_STATE_HEADS_PER_BLOCK))
    if kind == "intra":
        Cc = _view(Cc, "Cc", device, dtype)
        if Cc.shape != Bc.shape:
            raise ValueError(f"Cc shape {tuple(Cc.shape)} != Bc's")
        out_dtype = out_dtype or dtype
        if out_dtype not in (dtype, torch.float32):
            raise TypeError(f"ssd_chunk_intra writes float32 or xc's type "
                            f"{dtype}, not {out_dtype}")
        p.C, p.c_stride = Cc.data_ptr(), SsdParams._S3(*Cc.stride()[:3])
        p.out_bf16 = int(out_dtype == torch.bfloat16)
        out = torch.empty((B, nc, Q, H, P), dtype=out_dtype, device=device)
    elif kind == "state":
        if out_dtype not in (None, torch.float32):
            raise TypeError(f"ssd_chunk_state writes float32, not {out_dtype}")
        out = torch.empty((B, nc, H, N, P), dtype=torch.float32, device=device)
    else:
        raise ValueError(f"kind must be 'intra' or 'state', got {kind!r}")
    p.out, p.o_stride = out.data_ptr(), SsdParams._S4(*out.stride()[:4])
    _launch(f"ssd_chunk_{kind}_{TYPES[dtype]}", p, device)
    return out


# --- flash decode -------------------------------------------------------------

DECODE_HEAD_DIMS = (32, 64, 128)
_DECODE_TYPES = {torch.float32: 0, torch.bfloat16: 1}
DECODE_MAX_SPLITS = 8       # the splits of a row form one cluster (MAX_SPLITS)
# the plan puts at most this many blocks on an SM: at the Zamba2 ring on
# the H100 one block per SM (2 splits) is the only split count that beats
# SDPA, warm and cold (tools/decode_split_sweep.py, PERF.md)
DECODE_BLOCKS_PER_SM = 1
DECODE_KEY_ALIGN = 64       # keys per split is a multiple of this
_SM_COUNT = {}


def decode_heads_per_block(G: int) -> int:
    """Query heads of one kv head that a partial block holds (1, 2 or 4);
    ``ceil(G / that)`` blocks share each (b, kv head, split)."""
    return 1 if G == 1 else 2 if G == 2 else 4


def decode_split_plan(B: int, KV: int, S: int, n_sm: int,
                      head_groups: int = 1) -> tuple[int, int]:
    """(n_split, keys_per_split) for a decode over S keys: split i covers
    keys [i * keys_per_split, min(S, (i + 1) * keys_per_split)).  As many
    splits as keep the B * KV * head_groups rows within
    DECODE_BLOCKS_PER_SM blocks on each of ``n_sm`` SMs (one wave, no SM
    with more runs than another), at most DECODE_MAX_SPLITS,
    keys_per_split a multiple of DECODE_KEY_ALIGN, and no split empty.
    Depends on the shapes and the card only, never on the data."""
    if min(B, KV, S, n_sm, head_groups) < 1:
        raise ValueError(f"decode_split_plan needs positive sizes, got "
                         f"B={B} KV={KV} S={S} n_sm={n_sm} "
                         f"head_groups={head_groups}")
    rows = B * KV * head_groups
    n = max(1, min(DECODE_BLOCKS_PER_SM * n_sm // rows, DECODE_MAX_SPLITS,
                   -(-S // DECODE_KEY_ALIGN)))
    kps = -(-S // n)
    kps = -(-kps // DECODE_KEY_ALIGN) * DECODE_KEY_ALIGN
    return -(-S // kps), kps


def _sm_count(device) -> int:
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _SM_COUNT:
        _SM_COUNT[idx] = torch.cuda.get_device_properties(
            idx).multi_processor_count
    return _SM_COUNT[idx]


@functools.lru_cache(maxsize=64)
def _decode_template(dtype, device, q_meta, k_meta, v_meta):
    """Check a decode call's types, devices, shapes and strides (each
    ``*_meta`` is (dtype, device, shape, strides)) and return its launch
    template: DecodeParams without the pointers.  Raises on what the
    kernel does not take; cached, so a decode loop pays for the checks and
    the plan once per shape."""
    if dtype not in _DECODE_TYPES:
        raise TypeError(f"decode_attn takes float32 or bfloat16, got {dtype}")
    q_shape, k_shape, v_shape = q_meta[2], k_meta[2], v_meta[2]
    if len(q_shape) != 3 or len(k_shape) != 4 or k_shape != v_shape:
        raise ValueError(f"need q (B, H, D) and k, v (B, S, KV, D), got "
                         f"{tuple(q_shape)} / {tuple(k_shape)} / "
                         f"{tuple(v_shape)}")
    B, H, D = q_shape
    _, S, KV, _ = k_shape
    if D not in DECODE_HEAD_DIMS:
        raise ValueError(f"head dim {D} not compiled (have {DECODE_HEAD_DIMS})")
    if k_shape[0] != B or k_shape[3] != D or S < 1 or H % KV:
        raise ValueError(f"cache {tuple(k_shape)} does not fit q "
                         f"{tuple(q_shape)} (need H % KV == 0)")
    vec = 16 // dtype.itemsize
    for name, (t_dtype, t_device, _, stride) in (("q", q_meta), ("k", k_meta),
                                                  ("v", v_meta)):
        if t_dtype != dtype or t_device != device:
            raise ValueError(f"{name}: need {dtype} on {device}, got "
                             f"{t_dtype} on {t_device}")
        if stride[-1] != 1 or any(st % vec for st in stride[:-1]):
            raise ValueError(f"{name}: need a unit last stride and 16-byte "
                             f"aligned rows, got strides {stride}")
    gh = decode_heads_per_block(H // KV)
    n_split, kps = decode_split_plan(B, KV, S, _sm_count(device),
                                     -(-(H // KV) // gh))
    q_stride, k_stride, v_stride = q_meta[3], k_meta[3], v_meta[3]
    tmpl = DecodeParams(
        q_stride=DecodeParams._S2(*q_stride[:2]),
        k_stride=DecodeParams._S3(*k_stride[:3]),
        v_stride=DecodeParams._S3(*v_stride[:3]),
        o_stride=DecodeParams._S2(H * D, D), lse_stride=H, B=B, H=H, KV=KV,
        S=S, D=D,
        n_split=n_split, keys_per_split=kps, heads_per_block=gh,
        dtype=_DECODE_TYPES[dtype], scale=1.0 / float(D) ** 0.5)
    return bytes(tmpl)


def decode_attn(q, k, v, lse: bool = False):
    """Launch the flash-decode kernel: q (B, H, D), cache k, v in the
    model layout (B, S, KV, D), read through strides.  float32 or
    bfloat16 (all three alike); returns (B, H, D) in q's type, and with
    ``lse`` also each row's log-sum-exp of the scaled scores, (B, H)
    float32, written by the same launch.  The caller counts the
    launch."""
    device = q.device
    if device.type != "cuda":
        raise ValueError(f"decode_attn launches on CUDA tensors, got {device}")
    meta = lambda t: (t.dtype, t.device, t.shape, t.stride())
    tmpl = _decode_template(q.dtype, device, meta(q), meta(k), meta(v))
    if (q.data_ptr() | k.data_ptr() | v.data_ptr()) % 16:
        raise ValueError("q, k, v: need 16-byte aligned rows (a view's "
                         "first element is not 16-byte aligned)")
    out = torch.empty(q.shape, dtype=q.dtype, device=device)
    p = DecodeParams.from_buffer_copy(tmpl)
    p.q, p.k, p.v = q.data_ptr(), k.data_ptr(), v.data_ptr()
    p.out = out.data_ptr()
    if lse:
        lse_out = torch.empty(q.shape[:2], dtype=torch.float32, device=device)
        p.lse = lse_out.data_ptr()
    _launch("decode_attn", p, device)
    return (out, lse_out) if lse else out
