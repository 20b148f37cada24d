"""Hand-written CUDA kernels: build from the sources in this directory, bind
with ctypes, launch on PyTorch's current stream.

Each kernel is compiled on first use with `nvcc` alone (no PyTorch headers, no
ninja) into a shared library with a plain C interface, under `_build/` in the
package, keyed by a hash of its source, the headers beside it and the flags
(`build_key`). Nothing here runs at import time, so the CPU-only test suite
can import the package.

`launches` counts, per kernel, the launches made since the last
`reset_launch_counts()`: a run can show which kernels its path went through.
`adamw_sumsq` counts both of AdamW's sums-of-squares kernels (two launches
an update), as the C entry point reports them; `short_conv` and
`short_conv_bwd` count calls of the short conv's forward and backward (the
backward's call is its pass and the taps' sum). `SOURCES` names the sources
(`<name>.cu`) that `build` compiles.
"""

from __future__ import annotations

import array
import ctypes
import functools
import hashlib
import itertools
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import torch

_HERE = Path(__file__).resolve().parent
BUILD_DIR = _HERE.parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

SOURCES = ("flash_attention", "flash_attention_bwd", "masked_similarity", "adamw", "short_conv")
launches = {"flash_attention": 0, "flash_attention_bwd": 0, "masked_similarity": 0, "adamw_sumsq": 0,
            "adamw_update": 0, "short_conv": 0, "short_conv_bwd": 0}
# One build of a kernel at a time within the process: threads of one process
# share the temporary file name, which carries the pid.
_build_locks = {name: threading.Lock() for name in SOURCES}


def reset_launch_counts() -> None:
    for name in launches:
        launches[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")
    return str(path)


def build_key(name: str, src_dir: Optional[Path] = None) -> str:
    """The hash a build of `<name>.cu` is kept under: of that source, of every
    `*.cuh` header in its directory (by name and bytes: the sources include
    them, so a changed header rebuilds every library) and of the flags."""
    src_dir = _HERE if src_dir is None else Path(src_dir)
    digest = hashlib.sha256((src_dir / f"{name}.cu").read_bytes())
    for header in sorted(src_dir.glob("*.cuh")):
        digest.update(header.name.encode() + b"\0" + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return digest.hexdigest()[:16]


def build(name: str) -> Path:
    """Compile `<name>.cu` into `_build/<name>-<build_key>.so` unless it is
    there.

    The library is written under a temporary name and moved into place with
    `os.replace`, so a concurrent build never loads a half-written file. The
    compiler's report (registers, shared memory, spills) is kept beside it as
    `<name>-<build_key>.log`.
    """
    src = _HERE / f"{name}.cu"
    digest = build_key(name)
    lib = BUILD_DIR / f"{name}-{digest}.so"
    with _build_locks[name]:
        if lib.exists():
            return lib
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = BUILD_DIR / f".{name}-{digest}.{os.getpid()}.so"
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            capture_output=True, text=True, check=False,
        )
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed for {src.name}:\n{proc.stdout}{proc.stderr}")
        lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, lib)
        return lib


def _load(name: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build(name)))
    lib.vcp_cuda_error_string.argtypes = [ctypes.c_int]
    lib.vcp_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _raw_stream(device_index: int) -> int:
    """PyTorch's current stream on a device as the raw cudaStream_t: what
    torch.cuda.current_stream(device).cuda_stream gives, without making a
    Stream object on every launch."""
    return torch._C._cuda_getCurrentRawStream(device_index)


def _raise_on(lib: ctypes.CDLL, name: str, err: int) -> None:
    if err:
        raise RuntimeError(f"{name} launch failed: {lib.vcp_cuda_error_string(err).decode()} ({err})")


@functools.lru_cache(maxsize=None)
def _flash_lib() -> ctypes.CDLL:
    lib = _load("flash_attention")
    fn = lib.vcp_flash_attention_fwd
    fn.argtypes = [ctypes.c_void_p, ctypes.c_float]  # 25 packed int64 (see the source), scale
    fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _flash_bwd_lib() -> ctypes.CDLL:
    lib = _load("flash_attention_bwd")
    fn = lib.vcp_flash_attention_bwd
    fn.argtypes = [ctypes.c_void_p, ctypes.c_float]  # 45 packed int64 (see the source), scale
    fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _adamw_lib() -> ctypes.CDLL:
    lib = _load("adamw")
    fn = lib.vcp_adamw_sumsq
    # table, leaves, partials, sq, device, stream, launches made
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                   ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    fn = lib.vcp_adamw_update
    # table, leaves, constants, sq, max_norm, has_wd, device, stream, launches made
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _short_conv_lib() -> ctypes.CDLL:
    lib = _load("short_conv")
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn = lib.vcp_short_conv_fwd
    # h, taps, out, batch, seq, dim, k, dtype, vec, device, stream
    fn.argtypes = [ptr] * 3 + [i32] * 7 + [ptr]
    fn.restype = ctypes.c_int
    fn = lib.vcp_short_conv_bwd
    # h, taps, dout, dh, dtaps, partials, batch, seq, dim, k, dtype, vec, device, stream
    fn.argtypes = [ptr] * 6 + [i32] * 7 + [ptr]
    fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _similarity_lib() -> ctypes.CDLL:
    lib = _load("masked_similarity")
    fn = lib.vcp_masked_similarity
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


_FLASH_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
FLASH_HEAD_DIMS = (32, 64, 96, 128)
FLASH_BWD_HEAD_DIMS = (32, 64, 96, 128)
# Which kernel each input type takes (kernels/flash_attention.cu and, for the
# gradient, kernels/flash_attention_bwd.cu).
FLASH_ROUTES = {torch.bfloat16: "wgmma + TMA, warp-specialised, P V as bf16 hi + lo", torch.float32: "scalar f32"}
FLASH_BWD_ROUTES = {torch.bfloat16: "wgmma + TMA, warp-specialised, dK/dV pass + dQ pass",
                    torch.float32: "scalar f32, dK/dV pass + dQ pass"}


def flash_layout_ok(t: torch.Tensor) -> bool:
    """Whether the kernel reads `t` (B, H, S, D) in place: last dimension
    contiguous, the other strides multiples of 8 elements, the base 16-byte
    aligned (the bf16 routes of the forward and the backward read them
    through TMA tensor maps, whose strides and base need that). A head-split
    view of a (B, S, H * D) projection qualifies."""
    st = t.stride()
    return st[3] == 1 and not (st[0] % 8 or st[1] % 8 or st[2] % 8 or t.data_ptr() % 16)


def _check_flash_operands(q, k, v, kv_len, scale, head_dims) -> tuple:
    """The checks K1's forward and backward share, `head_dims` the kernel's;
    returns (b, h, hkv, sq, sk, d, dtype code)."""
    b, h, sq, d = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"bad k/v shapes {tuple(k.shape)} {tuple(v.shape)} for q {tuple(q.shape)}")
    hkv, sk = k.shape[1], k.shape[2]
    if h % hkv:
        raise ValueError(f"kv heads {hkv} do not divide heads {h}")
    if d not in head_dims:
        raise ValueError(f"head_dim {d} not supported by the kernel (have {head_dims})")
    dtype = _FLASH_DTYPES.get(q.dtype)
    if dtype is None or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"dtypes {q.dtype}/{k.dtype}/{v.dtype}: need one of float32, bfloat16")
    if kv_len is not None and (kv_len.dtype != torch.int32 or kv_len.shape != (b,)
                               or not kv_len.is_contiguous()):
        raise ValueError(f"kv_len must be contiguous int32 of shape ({b},)")
    if not scale > 0:
        raise ValueError(f"scale {scale}: the kernel takes a positive scale")
    dev = q.device
    if dev.type != "cuda" or k.device != dev or v.device != dev or (
        kv_len is not None and kv_len.device != dev
    ):
        raise ValueError("all operands must be CUDA tensors on one device")
    if not (flash_layout_ok(q) and flash_layout_ok(k) and flash_layout_ok(v)):
        raise ValueError("q/k/v need a contiguous last dimension, strides that are multiples of 8 "
                         "and 16-byte aligned data")
    return b, h, hkv, sq, sk, d, dtype


def _check_lse(lse: torch.Tensor, b: int, h: int, sq: int, dev: torch.device) -> None:
    if lse.dtype != torch.float32 or lse.shape != (b, h, sq) or not lse.is_contiguous() or lse.device != dev:
        raise ValueError(f"lse must be a contiguous float32 ({b}, {h}, {sq}) tensor on {dev}")


def flash_attention_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_len: Optional[torch.Tensor],
    causal: bool, scale: float, lse: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Launch the flash-attention kernel: q (B, H, Sq, D), k/v (B, Hkv, Sk, D)
    CUDA tensors on one device in a layout `flash_layout_ok` accepts, kv_len
    (B,) int32 or None (every key valid). Returns O shaped like q, a
    (B, H, Sq, D) view of a contiguous (B, Sq, H, D) tensor. With `lse`, a
    contiguous (B, H, Sq) float32 tensor, the kernel also writes each row's
    log-sum-exp of its scaled, masked scores there (+inf for a row without
    keys), which the backward reads. Raises on anything the kernel does not
    take and on a launch that CUDA refuses."""
    b, h, hkv, sq, sk, d, dtype = _check_flash_operands(q, k, v, kv_len, scale, FLASH_HEAD_DIMS)
    dev = q.device
    if lse is not None:
        _check_lse(lse, b, h, sq, dev)
    lib = _flash_lib()
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=dev)
    params = array.array("q", (
        q.data_ptr(), k.data_ptr(), v.data_ptr(), 0 if kv_len is None else kv_len.data_ptr(), out.data_ptr(),
        b, h, hkv, sq, sk, d, causal, dtype, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        dev.index, _raw_stream(dev.index), 0 if lse is None else lse.data_ptr(),
    ))
    err = lib.vcp_flash_attention_fwd(params.buffer_info()[0], scale)
    _raise_on(lib, "flash_attention", err)
    launches["flash_attention"] += 1
    return out.transpose(1, 2)


def flash_attention_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o: torch.Tensor, g: torch.Tensor,
    lse: torch.Tensor, kv_len: Optional[torch.Tensor], causal: bool, scale: float,
) -> tuple:
    """Launch the flash-attention backward (kernels/flash_attention_bwd.cu):
    q, k, v, kv_len, causal and scale as the forward took them, o its output,
    lse the row log-sum-exp it wrote, g the output gradient (shaped and typed
    like q, in a layout `flash_layout_ok` accepts, as o must be). Returns
    (dq, dk, dv) in the inputs' dtype, shaped like q, k and v: (B, H, S, D)
    views of contiguous (B, S, H, D) tensors, the layout of the projections
    they flow back into. One call, one count, whatever the passes it takes.
    Raises on anything the kernel does not take and on a launch that CUDA
    refuses."""
    b, h, hkv, sq, sk, d, dtype = _check_flash_operands(q, k, v, kv_len, scale, FLASH_BWD_HEAD_DIMS)
    dev = q.device
    for name, t in (("o", o), ("g", g)):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != dev:
            raise ValueError(f"{name} must match q: {tuple(t.shape)} {t.dtype} {t.device}")
        if not flash_layout_ok(t):
            raise ValueError(f"{name} needs a contiguous last dimension, strides that are multiples of 8 "
                             "and 16-byte aligned data")
    _check_lse(lse, b, h, sq, dev)
    lib = _flash_bwd_lib()
    dq = torch.empty((b, sq, h, d), dtype=q.dtype, device=dev).transpose(1, 2)
    dk = torch.empty((b, sk, hkv, d), dtype=q.dtype, device=dev).transpose(1, 2)
    dv = torch.empty((b, sk, hkv, d), dtype=q.dtype, device=dev).transpose(1, 2)
    # Delta and, on the bf16 route, lse * log2(e), each with every head's rows
    # padded to a multiple of 128 (see the source).
    delta = torch.empty(2 * b * h * -(-sq // 128) * 128, dtype=torch.float32, device=dev)
    params = array.array("q", (
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), g.data_ptr(), lse.data_ptr(),
        0 if kv_len is None else kv_len.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), delta.data_ptr(),
        b, h, hkv, sq, sk, d, causal, dtype,
        *(st for t in (q, k, v, o, g, dq, dk, dv) for st in t.stride()[:3]),
        dev.index, _raw_stream(dev.index),
    ))
    err = lib.vcp_flash_attention_bwd(params.buffer_info()[0], scale)
    _raise_on(lib, "flash_attention_bwd", err)
    launches["flash_attention_bwd"] += 1
    return dq, dk, dv


_SIMILARITY_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SIMILARITY_MAX_QUERIES = 8
_SIMILARITY_SMEM_BYTES = 48 * 1024  # the queries, staged in dynamic shared memory under the default limit


def masked_similarity(emb: torch.Tensor, queries: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Launch the masked-similarity kernel: emb (N, D) float32 or bfloat16,
    queries (B, D) float32, mask (N,) float32, all contiguous CUDA tensors on
    one device; returns scores (B, N) float32, -1e30 where mask <= 0. Raises
    on anything the kernel does not take and on a launch that CUDA refuses."""
    if emb.dim() != 2 or queries.dim() != 2 or queries.shape[1] != emb.shape[1]:
        raise ValueError(f"bad shapes emb {tuple(emb.shape)}, queries {tuple(queries.shape)}")
    n, d = emb.shape
    b = queries.shape[0]
    if mask.shape != (n,):
        raise ValueError(f"mask shape {tuple(mask.shape)}, expected ({n},)")
    if not 1 <= b <= SIMILARITY_MAX_QUERIES:
        raise ValueError(f"{b} queries: the kernel takes 1 to {SIMILARITY_MAX_QUERIES}")
    if d % 4 or b * d * 4 > _SIMILARITY_SMEM_BYTES:
        raise ValueError(f"D = {d} not supported: need D % 4 == 0 and B * D * 4 <= 48 KiB")
    if emb.dtype not in _SIMILARITY_DTYPES or queries.dtype != torch.float32 or mask.dtype != torch.float32:
        raise ValueError(f"dtypes emb {emb.dtype}, queries {queries.dtype}, mask {mask.dtype}: "
                         "need emb float32 or bfloat16, queries and mask float32")
    for t in (emb, queries, mask):
        if t.device.type != "cuda" or t.device != emb.device:
            raise ValueError("all operands must be CUDA tensors on one device")
        if not t.is_contiguous():
            raise ValueError("operands must be contiguous")
    if emb.data_ptr() % 16 or queries.data_ptr() % 16:
        raise ValueError("emb and queries must be 16-byte aligned")
    out = torch.empty((b, n), dtype=torch.float32, device=emb.device)
    if n == 0:
        return out
    lib = _similarity_lib()
    stream = torch.cuda.current_stream(emb.device).cuda_stream
    with torch.cuda.device(emb.device):
        err = lib.vcp_masked_similarity(
            emb.data_ptr(), queries.data_ptr(), mask.data_ptr(), out.data_ptr(),
            n, d, b, _SIMILARITY_DTYPES[emb.dtype], stream,
        )
    _raise_on(lib, "masked_similarity", err)
    launches["masked_similarity"] += 1
    return out


# AdamW (kernels/adamw.cu): the chunks, the checks, the calls.
ADAMW_CHUNK = 8192  # elements of a chunk (adamw.cu's CHUNK)
ADAMW_MAX_LEAVES = 700  # leaves of an update: its table fills CUDA's 32,764 bytes of kernel arguments (adamw.cu)
ADAMW_DTYPES = (torch.float32, torch.bfloat16)
ADAMW_CONSTANTS = ("b1", "1 - b1", "b2", "1 - b2", "bc1", "bc2", "eps", "weight_decay", "-lr", "max_norm")
_ADAMW_KIND_BF16, _ADAMW_KIND_ALIGNED = 1, 2
_INT32_MAX = 2**31 - 1


@functools.lru_cache(maxsize=64)
def adamw_chunks(numels: Tuple[int, ...]) -> Tuple[int, ...]:
    """Each leaf's first chunk in an update of leaves of these sizes, and
    one more entry, the update's chunks: a leaf is cut into
    ceil(numel / ADAMW_CHUNK) chunks (none for an empty leaf). Raises
    ValueError on no leaves, on more than ADAMW_MAX_LEAVES, or on more
    chunks than an int32 counts."""
    if not numels:
        raise ValueError("an update of no leaves")
    if len(numels) > ADAMW_MAX_LEAVES:
        raise ValueError(f"an update of {len(numels)} leaves: the kernels take at most {ADAMW_MAX_LEAVES}")
    starts = (0, *itertools.accumulate(-(-n // ADAMW_CHUNK) for n in numels))
    if starts[-1] > _INT32_MAX:
        raise ValueError(f"the leaves make {starts[-1]} chunks, over the kernels' int32 count")
    return starts


def adamw_device(params: List[torch.Tensor], grads: List[torch.Tensor], mu: List[torch.Tensor],
                 nu: List[torch.Tensor]) -> Optional[torch.device]:
    """None where every tensor of the update is on the CPU (the plain
    version's case). Otherwise the CUDA device of an update the kernels
    take: at most ADAMW_MAX_LEAVES leaves, each f32 or bf16 with its
    gradient and moments of its dtype and shape, all contiguous, all on one
    CUDA device; raises ValueError on anything else. One pass of cheap attributes: it runs every step."""
    if not (len(params) == len(grads) == len(mu) == len(nu)) or not params:
        raise ValueError("params, grads, mu and nu must be equal, non-empty lists")
    leaves = list(zip(params, grads, mu, nu))
    if all(t.is_cpu for leaf in leaves for t in leaf):
        return None
    if len(leaves) > ADAMW_MAX_LEAVES:
        raise ValueError(f"an update of {len(leaves)} leaves: the kernels take at most {ADAMW_MAX_LEAVES}")
    index, one_device = params[0].get_device(), True
    for i, leaf in enumerate(leaves):
        dtype, shape = leaf[0].dtype, leaf[0].shape
        for t in leaf:
            if t.dtype is not dtype or dtype not in ADAMW_DTYPES:
                raise ValueError(f"leaf {i}: dtypes {[t.dtype for t in leaf]}: the kernel takes float32 or "
                                 "bfloat16 leaves with gradient and moments of their dtype")
            if t.shape != shape:
                raise ValueError(f"leaf {i}: shapes {[tuple(t.shape) for t in leaf]} differ")
            if not t.is_contiguous():
                raise ValueError(f"leaf {i}: the kernel takes contiguous tensors")
            one_device = one_device and t.is_cuda and t.get_device() == index
    if not one_device:
        raise ValueError(f"all tensors must be on one CUDA device: found "
                         f"{sorted({str(t.device) for leaf in leaves for t in leaf})}")
    return params[0].device


def _adamw_table(starts: Tuple[int, ...], grads, params=None, mu=None, nu=None) -> array.array:
    """adamw.cu's table as int64 words: chunk starts (`adamw_chunks`),
    sizes, kinds (bf16; every pointer 16-byte aligned), then the addresses
    of g, p, mu and nu (0 where not given: the sums of squares read g
    alone)."""
    cols = [[t.data_ptr() for t in ts] if ts is not None else [0] * len(grads) for ts in (grads, params, mu, nu)]
    words = array.array("q", starts)
    words.extend(g.numel() for g in grads)
    words.extend((_ADAMW_KIND_BF16 if g.dtype is torch.bfloat16 else 0)
                 | (0 if (a | b | c | d) & 15 else _ADAMW_KIND_ALIGNED)
                 for g, a, b, c, d in zip(grads, *cols))
    for col in cols:
        words.extend(col)
    return words


def adamw_sumsq(grads: List[torch.Tensor]) -> torch.Tensor:
    """Each gradient's f32 sum of squares, a new (n,) float32 tensor on the
    gradients' device (kernels/adamw.cu's two sums-of-squares kernels: the
    chunks' partial sums, then each leaf's). The order of every sum is
    fixed: the same gradients give the same bits. The gradients must have
    passed adamw_device with their leaves. Counts each launch made."""
    starts = adamw_chunks(tuple(g.numel() for g in grads))
    dev, n, chunks = grads[0].device, len(grads), starts[-1]
    scratch = torch.empty(chunks + n, dtype=torch.float32, device=dev)
    lib, launched = _adamw_lib(), ctypes.c_int(0)
    table = _adamw_table(starts, grads)
    err = lib.vcp_adamw_sumsq(table.buffer_info()[0], n, scratch.data_ptr(), scratch.data_ptr() + 4 * chunks,
                              dev.index, _raw_stream(dev.index), ctypes.byref(launched))
    launches["adamw_sumsq"] += launched.value
    _raise_on(lib, "adamw_sumsq", err)
    return scratch[chunks:]


def adamw_update(params: List[torch.Tensor], grads: List[torch.Tensor], mu: List[torch.Tensor],
                 nu: List[torch.Tensor], constants: dict, max_norm: float, has_wd: bool,
                 sq: Optional[torch.Tensor] = None) -> None:
    """AdamW on every leaf in place (kernels/adamw.cu's update kernel, one
    launch): p, mu and nu written, the gradients read. `constants` maps
    float32 and bfloat16 to the ADAMW_CONSTANTS' values, each rounded to
    that dtype. With `sq` (the leaves' f32 sums of squares, as adamw_sumsq
    and the step's reduction left them) the gradients are first clipped to
    the global norm `max_norm`, which the kernel works out on the card;
    without, not. The leaves must have passed adamw_device. Counts the
    launch where one was made."""
    dev, n = params[0].device, len(params)
    if sq is not None and (sq.dtype != torch.float32 or sq.shape != (n,) or not sq.is_contiguous()
                           or sq.device != dev):
        raise ValueError(f"sq must be a contiguous float32 ({n},) tensor on {dev}")
    starts = adamw_chunks(tuple(p.numel() for p in params))
    consts = array.array("f", (constants[dtype][k] for dtype in ADAMW_DTYPES for k in ADAMW_CONSTANTS))
    lib, launched = _adamw_lib(), ctypes.c_int(0)
    table = _adamw_table(starts, grads, params, mu, nu)
    err = lib.vcp_adamw_update(table.buffer_info()[0], n, consts.buffer_info()[0],
                               0 if sq is None else sq.data_ptr(), max_norm, int(has_wd), dev.index,
                               _raw_stream(dev.index), ctypes.byref(launched))
    launches["adamw_update"] += launched.value
    _raise_on(lib, "adamw_update", err)


# The gated short conv (kernels/short_conv.cu): the taps it takes, and the
# runs of positions its threads walk, which size the taps' partial sums.
SHORT_CONV_TAPS = (2, 3, 4)
SHORT_CONV_RUN = 32  # positions a thread walks (short_conv.cu's RUN)
SHORT_CONV_RUNS_PER_BLOCK = 8  # runs a block (short_conv.cu's RUNS): one f64 partial row each block row
_SHORT_CONV_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_GRID_Y_MAX = 65535


def _short_conv_shape(h: torch.Tensor, taps: torch.Tensor,
                      dout: Optional[torch.Tensor] = None) -> Tuple[int, int, int, int, int]:
    """(batch, seq, dim, k, block rows) of a call the kernels take: h a
    contiguous (B, S, 3 * dim) float32 or bfloat16 tensor, taps a contiguous
    (dim, k) float32 tensor with k in SHORT_CONV_TAPS, dout (the backward's)
    contiguous and shaped and typed as the forward's output, all on one CUDA
    device (checked last). Raises ValueError on anything else."""
    if h.dim() != 3 or h.shape[2] == 0 or h.shape[2] % 3:
        raise ValueError(f"h must be (B, S, 3 * dim) with dim >= 1: got {tuple(h.shape)}")
    b, s, dim = h.shape[0], h.shape[1], h.shape[2] // 3
    if h.dtype not in _SHORT_CONV_DTYPES:
        raise ValueError(f"h is {h.dtype}: the kernels take float32 or bfloat16")
    if taps.dtype != torch.float32 or taps.dim() != 2 or taps.shape[0] != dim or taps.shape[1] not in SHORT_CONV_TAPS:
        raise ValueError(f"taps must be float32 ({dim}, k) with k in {SHORT_CONV_TAPS}: got {taps.dtype} "
                         f"{tuple(taps.shape)}")
    if dout is not None and (dout.shape != (b, s, dim) or dout.dtype != h.dtype):
        raise ValueError(f"dout must be {h.dtype} ({b}, {s}, {dim}): got {dout.dtype} {tuple(dout.shape)}")
    if not all(t.is_contiguous() for t in (h, taps, dout) if t is not None):
        raise ValueError("h, taps and dout must be contiguous")
    rows = -(-b * -(-s // SHORT_CONV_RUN) // SHORT_CONV_RUNS_PER_BLOCK)
    if rows > _GRID_Y_MAX:
        raise ValueError(f"{b} x {s} positions: the kernels take at most "
                         f"{_GRID_Y_MAX * SHORT_CONV_RUNS_PER_BLOCK} runs of {SHORT_CONV_RUN}")
    if h.device.type != "cuda" or any(t.device != h.device for t in (taps, dout) if t is not None):
        raise ValueError(f"h, taps and dout must be on one CUDA device: got "
                         f"{[str(t.device) for t in (h, taps, dout) if t is not None]}")
    return b, s, dim, taps.shape[1], rows


def _short_conv_vec(dim: int, *tensors: torch.Tensor) -> int:
    """1 where the channels go as whole 16-byte vectors: dim fills them and
    every pointer is 16-byte aligned; else 0 (one element a thread)."""
    return int(dim * tensors[0].element_size() % 16 == 0 and not any(t.data_ptr() % 16 for t in tensors))


def short_conv_fwd(h: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """The gated short conv between LFM2's projections (kernels/short_conv.cu):
    h = [B | C | x'] (B, S, 3 * dim), taps (dim, k) float32 (`_short_conv_shape`
    says what it takes) -> C * conv(B * x') (B, S, dim) in h's dtype, bit-equal
    to ShortConv's plain path. Raises on anything the kernel does not take and
    on a launch that CUDA refuses."""
    b, s, dim, k, _ = _short_conv_shape(h, taps)
    dev = h.device
    out = torch.empty((b, s, dim), dtype=h.dtype, device=dev)
    lib = _short_conv_lib()
    err = lib.vcp_short_conv_fwd(h.data_ptr(), taps.data_ptr(), out.data_ptr(), b, s, dim, k,
                                 _SHORT_CONV_DTYPES[h.dtype], _short_conv_vec(dim, h, out), dev.index,
                                 _raw_stream(dev.index))
    _raise_on(lib, "short_conv", err)
    launches["short_conv"] += 1
    return out


def short_conv_bwd(h: torch.Tensor, taps: torch.Tensor, dout: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The short conv's backward (kernels/short_conv.cu) from h and taps as the
    forward took them and dout, the output's gradient (contiguous, shaped and
    typed like the forward's output): (dh, dtaps), the gradient of h as one
    contiguous (B, S, 3 * dim) tensor [dB | dC | dx'] bit-equal to autograd's
    of the plain path, and the taps' (dim, k) float32 gradient, summed in a
    fixed order (the same inputs give the same bits). One call, one count.
    Raises on anything the kernel does not take and on a launch that CUDA
    refuses."""
    b, s, dim, k, rows = _short_conv_shape(h, taps, dout)
    dev = h.device
    dh = torch.empty_like(h)
    dtaps = torch.empty_like(taps)
    partials = torch.empty(rows * dim * k, dtype=torch.float64, device=dev)
    lib = _short_conv_lib()
    err = lib.vcp_short_conv_bwd(h.data_ptr(), taps.data_ptr(), dout.data_ptr(), dh.data_ptr(), dtaps.data_ptr(),
                                 partials.data_ptr(), b, s, dim, k, _SHORT_CONV_DTYPES[h.dtype],
                                 _short_conv_vec(dim, h, dout, dh), dev.index, _raw_stream(dev.index))
    _raise_on(lib, "short_conv_bwd", err)
    launches["short_conv_bwd"] += 1
    return dh, dtaps
