"""Build, load and count the port's hand-written CUDA kernels.

All sources under ``mickey_tpu_torch/csrc/`` have a plain ``extern "C"``
interface. On first use each source is compiled by its own ``nvcc`` process
for ``sm_90a``, all started together, and the objects are linked into a
single shared library under ``mickey_tpu_torch/build/`` (listed in
``.gitignore``), named by a hash of the sources and headers so an edit
rebuilds, and loaded with ``ctypes``. Nothing here runs at import: the CPU
tests import every module, on machines without ``nvcc`` or a GPU.

Every C entry returns ``cudaGetLastError()`` after its launch; ``check``
raises on anything but 0. ``LAUNCHES`` counts each kernel where its wrapper
launches it, and nowhere else.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"
SOURCES = ("flash_attention_packed.cu", "flash_attention_f32.cu", "fused_topk.cu", "hypothesis_scoring.cu",
           "dual_softmax.cu", "svd3x3.cu")
HEADERS = ("hopper.cuh", "corr_tf32.cuh")
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LINK_LIBS = ("-ldl",)  # dlsym of the tensor-map encoder (hopper.cuh)

LAUNCHES = {"flash_attention_packed": 0, "flash_attention": 0, "flash_attention_packed_f32": 0,
            "flash_attention_f32": 0, "flash_attention_packed_upcast": 0, "col_lse": 0, "pair_topk": 0,
            "hypothesis_scores": 0, "pair_softmax": 0, "dual_softmax_bwd_sums": 0,
            "dual_softmax_bwd_grads": 0, "lse_bwd": 0, "col_lse_bf16": 0, "pair_topk_bf16": 0,
            "pair_softmax_bf16": 0, "svd3x3": 0}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_LLP = ctypes.POINTER(ctypes.c_longlong)
_SIGNATURES = {
    "mk_flash_attention_bf16": [_P] * 4 + [_LLP, _I, _F, _P],
    "mk_flash_attention_packed_f32": [_P, _P, _P, _LLP, _I, _I, _I, _F, _P],
    "mk_flash_attention_f32": [_P] * 4 + [_LLP, _P, _LLP] + [_I] * 4 + [_F, _P],
    "mk_flash_attention_packed_upcast_bf16": [_P, _P, _P, _LLP, _I, _I, _I, _I, _F, _P],
    "mk_col_lse_f32": [_P] * 4 + [_LLP] + [_I] * 5 + [_F, _F, _P],
    "mk_col_lse_bf16": [_P] * 4 + [_LLP] + [_I] * 5 + [_F, _F, _P],
    "mk_pair_topk_f32": [_P] * 11 + [_LLP] + [_I] * 6 + [_F, _F, _I, _P],
    "mk_pair_topk_bf16": [_P] * 11 + [_LLP] + [_I] * 6 + [_F, _F, _I, _P],
    "mk_hypothesis_scores_f32": [_P] * 5 + [_I, _I, _I, _F, _P],
    "mk_pair_softmax_f32": [_P] * 6 + [_LLP] + [_I] * 4 + [_F, _F, _P],
    "mk_pair_softmax_bf16": [_P] * 6 + [_LLP] + [_I] * 4 + [_F, _F, _P],
    "mk_dual_softmax_bwd_sums_f32": [_P] * 9 + [_LLP] + [_I] * 4 + [_F, _I, _P],
    "mk_dual_softmax_bwd_grads_f32": [_P] * 11 + [_LLP] + [_I] * 4 + [_F, _I, _P],
    "mk_lse_bwd_f32": [_P] * 10 + [_LLP] + [_I] * 4 + [_F, _I, _P],
    "mk_svd3x3_f32": [_P] * 4 + [ctypes.c_longlong, _P],
}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")
    return found


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _compile(so: Path) -> str:
    """One ``nvcc -c`` per source, all running at once, then one link into
    ``so``. Returns the compilers' ``-Xptxas -v`` output."""
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / f"{s}.o" for s in SOURCES]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(CSRC / s)],
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for s, o in zip(SOURCES, objs)]
        logs = []
        for s, p in zip(SOURCES, procs):
            out, err = p.communicate()
            if p.returncode != 0:
                for other in procs:
                    other.kill()
                    other.wait()
                raise RuntimeError(f"nvcc failed on {s} ({p.returncode}):\n{out}{err}")
            logs.append(err)
        lib = Path(tmp) / so.name
        proc = subprocess.run([nvcc, *ARCH, "-shared", "-o", str(lib), *map(str, objs), *LINK_LIBS],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
        os.replace(lib, so)
    return "".join(logs)


@functools.lru_cache(maxsize=1)
def build() -> tuple:
    """Compile (if needed) and load the kernel library.

    Returns ``(lib, ptxas_log)``; the log holds ``-Xptxas -v``'s register and
    shared-memory report per kernel (empty when the library was already
    built)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = BUILD_DIR / f"libmickey_kernels_{_source_hash()}.so"
    log = "" if so.exists() else _compile(so)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    # the layout queries: sizes and limits, not launches
    lib.mk_dual_softmax_row_blocks.argtypes = [_I]
    lib.mk_dual_softmax_row_blocks.restype = _I
    lib.mk_pair_topk_max_l.argtypes = lib.mk_pair_topk_max_chunks.argtypes = []
    lib.mk_pair_topk_max_l.restype = lib.mk_pair_topk_max_chunks.restype = _I
    lib.mk_pair_topk_work_floats.argtypes = [_I] * 4
    lib.mk_pair_topk_work_floats.restype = ctypes.c_longlong
    return lib, log


def lib():
    return build()[0]


def build_variant(source: str, defines: tuple):
    """``source`` compiled alone with ``-D`` ``defines`` into a library of
    its own, loaded with the entries' signatures set: the timing ablations
    of ``chip_smoke.py --attention``, ``--attention-f32``, ``--matcher``,
    ``--matcher-bwd`` and ``--scoring``. The port itself loads only
    ``lib()``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = hashlib.sha256((_source_hash() + " ".join(defines)).encode()).hexdigest()[:16]
    so = BUILD_DIR / f"lib{Path(source).stem}_{tag}.so"
    if not so.exists():
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, *(f"-D{d}" for d in defines), "-shared", "-o", str(so),
                               str(CSRC / source), *LINK_LIBS], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source} with {defines} ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
    variant = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        if hasattr(variant, name):
            fn = getattr(variant, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return variant


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple, device: torch.device) -> None:
    """The checks every kernel wrapper makes before passing a pointer."""
    if t.device != device or not t.is_cuda:
        raise ValueError(f"{name}: expected a tensor on {device}, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
