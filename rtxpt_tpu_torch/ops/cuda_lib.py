"""Build, load and launch the port's CUDA kernels (``csrc/*.cu``).

The kernels have a plain C interface and are compiled with ``nvcc`` for
``sm_90a`` into one shared library, loaded with ``ctypes`` (route (b):
no PyTorch headers, so a build takes seconds, not minutes). The build
happens on first use into ``rtxpt_tpu_torch/_build/`` (git-ignored),
keyed by a hash of the sources and flags, so a fresh checkout builds
itself and later processes reuse the library.

Flags: no ``--use_fast_math`` (the shade kernel's sqrt/exp/acos/atan2 must
stay IEEE within the shade tolerance) and ``--fmad=false`` (no a*b+c
contraction), so each kernel evaluates the same float32 operations, in
the same order, as the plain PyTorch version beside it.

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; `launch` raises if that is not 0. Each wrapper
that launches a kernel counts its launches (`counted`), so a run can show
which kernels its main path went through.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
SOURCES = ("gather.cu", "mt_dense.cu", "shade_kernel.cu", "bvh8_trace.cu",
           "rng.cu", "relax.cu")
HEADERS = ("common.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "--fmad=false")

P, I, F, U = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_uint32
# C signatures: every entry point returns the cudaError_t of its launch
SIGNATURES = {
    "rtxpt_gather_rows": (P, I, I, P, P, I, I, P),
    "rtxpt_gather_rows_interp": (P, I, I, P, P, P, I, I, P),
    "rtxpt_gather_surface": (P, I, I, P, I, I, P, P, I, I, P, P, P, P, P, P,
                             I, P),
    "rtxpt_mt_dense": (P, P, I, P, P, P, P, P, P, P, P, I, I, P),
    "rtxpt_mt_dense_variant": (P, P, I, P, P, P, P, P, P, P, P, I, I, P),
    "rtxpt_mt_dense_fused": (P, P, I, P, P, P, P, P, P, I, I, I, P),
    "rtxpt_mt_dense_fused_variant": (P, P, I, P, P, P, P, P, P, I, I, I, P),
    "rtxpt_tile_keys": (P, I, P, P, P, P, P, P, P, I, I, P),
    "rtxpt_shade_nee": (P, P, P, I, I, I, I, I, I, F, F, P),
    "rtxpt_shade_nee_fill": (P, P, P, I, I, I, I, I, I, F, F, P),
    "rtxpt_bvh8_trace": (P, I, I, I, P, P, P, P, P, P, P, P, I, I, P),
    "rtxpt_bvh8_trace_sub": (P, I, I, I, I, P, P, P, P, P, P, P, P, P, I, I,
                             P),
    "rtxpt_bvh8_trace_2l": (P, I, I, I, I, P, P, P, I, P, P, P, P, P, P, P,
                            P, P, I, I, P),
    "rtxpt_bvh8_trace_2l_variant": (P, I, I, I, I, P, P, P, I, P, P, P, P, P,
                                    P, P, P, P, I, I, I, P),
    # csrc/rng.cu: each operand (pointer, mode[, scalar value])
    "rtxpt_rng_make": (P, I, U, P, I, U, P, I, U, P, I, U, P, I, U, U, P, P,
                       P, P, P, P, I, P),
    "rtxpt_rng_start_effect": (P, I, P, I, P, I, U, U, U, U, P, P, P, I, P),
    "rtxpt_rng_next": (P, I, P, I, P, I, P, I, I, I, I, P, P, P, I, P),
    # csrc/relax.cu: float32 images, then (h, w) and the passes' parameters
    "rtxpt_relax_temporal": (P, P, P, P, P, P, P, P, P, P, P, P, I, I, F, F,
                             P),
    "rtxpt_relax_variance": (P, P, P, P, I, I, P),
    "rtxpt_relax_atrous": (P, P, P, P, P, P, P, I, I, I, F, F, F, P),
    "rtxpt_taa_resolve": (P, P, P, P, P, I, I, F, F, P),
}

_lib = None
_COUNTED = {}


def counted(name: str):
    """Register a kernel wrapper; it owns a plain ``launches`` integer
    that it increments where it launches its kernel, and nowhere else."""
    def deco(fn):
        fn.launches = 0
        _COUNTED[name] = fn
        return fn
    return deco


def bump(name: str):
    """Add one launch to the counter of wrapper `name`."""
    _COUNTED[name].launches += 1


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in _COUNTED.items()}


def reset_launch_counts():
    for fn in _COUNTED.values():
        fn.launches = 0


def on_cuda(*tensors) -> bool:
    """True for CUDA tensors (launch the kernel), False for CPU tensors
    (plain version); raises on mixed or other devices."""
    dev = tensors[0].device
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError(f"tensors on {dev} and {t.device}")
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {dev}")


def check(t: torch.Tensor, name: str, dtype, shape=None):
    """Validate a kernel argument: dtype, contiguity and shape (None
    entries of `shape` match any extent)."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
    if shape is not None:
        if t.dim() != len(shape) or any(
                s is not None and s != ts for s, ts in zip(shape, t.shape)):
            raise ValueError(f"{name}: shape {tuple(t.shape)}, "
                             f"expected {shape}")


def kernel_operand(t: torch.Tensor, name: str, shape) -> torch.Tensor:
    """`t` as a float32 kernel operand of `shape`, contiguous (a strided
    view is copied), with 32-bit offsets."""
    t = t.contiguous()
    check(t, name, torch.float32, shape)
    if t.numel() >= 2 ** 31:
        raise ValueError(f"{name}: {t.numel()} elements, kernels index "
                         "with 32 bits")
    return t


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                       "the CUDA toolkit's nvcc")


def source_hash(sources=SOURCES, csrc: Path = CSRC) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in HEADERS + tuple(sources):
        h.update(name.encode())
        h.update((csrc / name).read_bytes())
    return h.hexdigest()[:16]


def build(verbose: bool = False, stem: str = "rtxpt_kernels",
          sources=SOURCES, csrc: Path = CSRC) -> Path:
    """Compile `sources` from `csrc` (default: this package's csrc/; one
    nvcc process per file, in parallel) and link them into one .so;
    returns its path. Reuses a library already built from the same
    sources and flags."""
    so = BUILD_DIR / f"lib{stem}_{source_hash(sources, csrc)}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs, procs = [], []
        for src in sources:
            obj = Path(tmp) / (src + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(csrc / src), "-o", str(obj)]
            if verbose:
                cmd.insert(1, "-Xptxas=-v")
            procs.append((src, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
            objs.append(str(obj))
        for src, p in procs:
            out = p.communicate()[0].decode(errors="replace")
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src}:\n{out}")
            if verbose and out:
                print(f"[nvcc {src}]\n{out}", flush=True)
        tmp_so = Path(tmp) / so.name
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", *objs, "-o", str(tmp_so)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n"
                               + link.stdout.decode(errors="replace"))
        os.replace(tmp_so, so)
    return so


def ptxas_report(source: str, csrc: Path = CSRC) -> str:
    """nvcc's ``-Xptxas=-v`` report on `csrc`/`source` compiled with the
    library's flags: each kernel's registers, static shared memory and
    spills."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        p = subprocess.run(
            [_nvcc(), "-Xptxas=-v", *NVCC_FLAGS, "-c", str(csrc / source),
             "-o", str(Path(tmp) / (source + ".o"))],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    out = p.stdout.decode(errors="replace")
    if p.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{out}")
    return out


def load(stem: str, sources, signatures: dict,
         csrc: Path = CSRC) -> ctypes.CDLL:
    """Build (on first use) and load library `stem` from `sources` in
    `csrc`, with the C signatures of its entry points."""
    handle = ctypes.CDLL(str(build(stem=stem, sources=sources, csrc=csrc)))
    for name, args in signatures.items():
        fn = getattr(handle, name)
        fn.argtypes = list(args)
        fn.restype = ctypes.c_int
    return handle


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        _lib = load("rtxpt_kernels", SOURCES, SIGNATURES)
    return _lib


def launch(name: str, *args, library: ctypes.CDLL = None):
    """Call C entry point `name` of `library` (default: `lib()`) on the
    current CUDA stream (appended as the last argument); raises on a
    refused launch. Tensors passed in may be freed when the wrapper
    returns: PyTorch's caching allocator hands their memory out again
    only in stream order, after the launch."""
    stream = torch.cuda.current_stream().cuda_stream
    err = getattr(library or lib(), name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
