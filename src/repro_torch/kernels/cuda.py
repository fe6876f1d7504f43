"""Build, load and launch the hand-written CUDA kernels of ``csrc/``.

The kernels are compiled at first use with ``nvcc`` into a shared
library with a plain C interface and loaded with ``ctypes``, so no
source includes PyTorch's headers and the build takes seconds: one
``nvcc -c`` per source, all started together, then one link.  The
library lands in ``build/torch_ext/`` at the repository
root, named by a hash of the sources and flags, so an edited source
never loads a stale build.  Nothing here runs at import time: the CPU
tests import every module of the package without a compiler.

Every op wrapper of the package calls ``launch(...)`` only for CUDA
tensors; ``launch`` raises on a non-zero ``cudaError_t`` (a refused
launch never runs, and a later ``synchronize`` would not report it) and
counts the launch in ``LAUNCHES``.

A launch through ``ctypes`` is invisible to PyTorch's dispatch, so a
wrapper on a step that ``launch/dryrun.py`` counts reports its kernel's
work itself: ``kernel_work(counter, flops, nbytes, device)`` around the
kernel (or its plain version, or its shapes on ``meta``) tells every
registered ``WorkSink`` the operations and the bytes read once and
written once, and the same call counts the same on every device.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().with_name("csrc")
SOURCES = ("cnn_kernels.cu", "mm_kernels.cu", "mm_tc_kernels.cu",
           "attn_kernels.cu", "attn_tc_kernels.cu", "scan_kernels.cu")
HEADERS = ("cnn_device.cuh", "tc_device.cuh")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_ext"
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xcompiler", "-fPIC")

# dtype codes of the kernels (enum DType of cnn_kernels.cu; mm_kernels.cu,
# mm_tc_kernels.cu and attn_kernels.cu use the same codes; attn_kernels.cu
# hands bf16 flash to attn_tc_kernels.cu; scan_kernels.cu takes f32 only)
DTYPE_CODE = {torch.float32: 0, torch.int8: 1, torch.int32: 2,
              torch.int16: 3, torch.bfloat16: 4}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "cnn_conv2d": (_I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                   _I, _I, _P),
    "cnn_conv1": (_I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                  _I, _I, _P),
    "cnn_pool2d": (_I, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                   _I, ctypes.c_longlong, _P),
    "cnn_activation": (_I, _I, _P, _P, ctypes.c_longlong, _I, _P),
    "cnn_fused": (_I, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                  _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    "cnn_activation_lut": (_I, _P, _P, _P, ctypes.c_longlong, _F, _F, _I,
                           _P),
    "cnn_activation_plan": (_I, _P, _P, ctypes.c_longlong, _I,
                            ctypes.POINTER(ctypes.c_longlong)),
    "cnn_pool2d_im2col": (_I, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                          _I, _I, _I, ctypes.c_longlong, _P),
    "cnn_conv2d_dual": (_I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                        _I, _I, _I, _I, _I, _I, _P),
    "cnn_matmul": (_I, _I, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "cnn_matmul_dual": (_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "mm_tc_matmul": (_I, _P, _P, _P, _I, _I, _I, _I, _P),
    "mm_tc_matmul_dual": (_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    "attn_flash": (_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _P),
    "attn_decode": (_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F,
                    _P),
    "attn_decode_plan": (_I, _I, _I, _I, _I, _I, ctypes.POINTER(_I),
                         ctypes.POINTER(_I),
                         ctypes.POINTER(ctypes.c_longlong)),
    "scan_selective": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                       _I, _I, _I, _I, _I, _P),
    "scan_selective_bwd": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                           _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                           _I, _P),
}

# Launches per kernel since the last reset_launches(): each wrapper adds
# one where it launches its kernel, and nowhere else.  Counter names are
# the wrappers' names: fused_cnn_vpu, fused_cnn_mxu, conv2d_ip1..4,
# pool2d_window, pool2d_im2col, activation_exact, activation_lut,
# mm_mxu, mm_vpu, mm_dual_shared, mm_dual_full, flash_attention,
# flash_decode, selective_scan and selective_scan_bwd.
LAUNCHES: Dict[str, int] = {}

_LIB = None
_LOCK = threading.Lock()


def reset_launches() -> None:
    LAUNCHES.clear()


class WorkSink:
    """Receives the work of kernels run between ``kernel_begin`` and
    ``kernel_end`` (``launch/dryrun.py``'s step counter)."""

    def kernel_begin(self, counter: str, flops: float, nbytes: float,
                     device: torch.device) -> None:
        raise NotImplementedError

    def kernel_end(self, counter: str) -> None:
        raise NotImplementedError


_SINKS: list = []


@contextlib.contextmanager
def work_sink(sink: WorkSink):
    """Register ``sink`` for the kernels run inside."""
    _SINKS.append(sink)
    try:
        yield sink
    finally:
        _SINKS.remove(sink)


@contextlib.contextmanager
def kernel_work(counter: str, flops: float, nbytes: float,
                device: torch.device):
    """The kernel ``counter`` runs inside, doing ``flops`` operations
    and reading and writing ``nbytes`` (each input once, each output
    once) on ``device``."""
    for sink in _SINKS:
        sink.kernel_begin(counter, flops, nbytes, device)
    try:
        yield
    finally:
        for sink in _SINKS:
            sink.kernel_end(counter)


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([Path(home) / "bin" / "nvcc"] if home else []) + [
            Path("/usr/local/cuda/bin/nvcc")]:
        if cand.exists():
            return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built at "
                           "first use and need the CUDA toolkit")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libcnn_kernels_{_digest()}.so"


def _run(cmds) -> str:
    """Run the commands together and wait for all of them; raise if any
    failed, else return their standard error (ptxas's report)."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True))
             for cmd in cmds]
    results = [(cmd, proc.communicate()[1], proc.returncode)
               for cmd, proc in procs]
    failed = [f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{err}"
              for cmd, err, rc in results if rc != 0]
    if failed:
        raise RuntimeError("\n".join(failed))
    return "".join(err for _, err, _ in results)


def build(verbose: bool = False) -> Path:
    """Compile the kernels unless this exact build exists; returns the
    library path.  Each source compiles in its own ``nvcc``, all at
    once, and one more links them; the library is written to a
    temporary name and renamed, so concurrent processes never load a
    half-written file."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    work = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    try:
        nvcc = _nvcc()
        flags = ("-Xptxas=-v",) + NVCC_FLAGS if verbose else NVCC_FLAGS
        objs = [work / f"{Path(s).stem}.o" for s in SOURCES]
        log = _run([[nvcc, *flags, "-c", "-o", str(o), str(CSRC / s)]
                    for s, o in zip(SOURCES, objs)])
        tmp = work / "lib.so"
        _run([[nvcc, "-shared", "-o", str(tmp), *map(str, objs)]])
        if verbose and log:
            print(log)
        os.replace(tmp, out)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            handle = ctypes.CDLL(str(build()))
            for name, args in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = args
                fn.restype = ctypes.c_int
            handle.cnn_error_string.argtypes = (ctypes.c_int,)
            handle.cnn_error_string.restype = ctypes.c_char_p
            _LIB = handle
    return _LIB


def sm_count(device: torch.device) -> int:
    """The number of SMs of ``device``: the one source of the launch
    plans that size a grid to the card (the scan's ``lane_plan``, the
    activations' waves)."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def require_dtype(what: str, dtype: torch.dtype, dtypes) -> None:
    if dtype not in dtypes:
        raise TypeError(f"{what} dtype {dtype} is not supported by the "
                        f"CUDA kernel (have {list(dtypes)})")


def require(t: torch.Tensor, what: str, dtypes=None, ndim=None) -> None:
    """The checks a kernel wrapper makes before handing pointers over."""
    if not t.is_cuda:
        raise ValueError(f"{what} must be a CUDA tensor, got {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")
    if dtypes is not None:
        require_dtype(what, t.dtype, dtypes)
    if ndim is not None and t.dim() != ndim:
        raise ValueError(f"{what} must have {ndim} dims, got "
                         f"{tuple(t.shape)}")


def call(what: str, fn_name: str, device: torch.device, *args) -> None:
    """Call ``fn_name`` with ``device`` current and raise on a non-zero
    ``cudaError_t``; counts nothing (a launcher's plan query)."""
    handle = lib()
    with torch.cuda.device(device):
        err = getattr(handle, fn_name)(*args)
    if err != 0:
        msg = handle.cnn_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA launch failed ({err}): {msg}")


def launch(counter: str, fn_name: str, device: torch.device, *args) -> None:
    """Launch ``fn_name`` on ``device``'s current stream, raise on a
    launch error, and count the launch under ``counter``."""
    stream = torch.cuda.current_stream(device).cuda_stream
    call(counter, fn_name, device, *args, stream)
    LAUNCHES[counter] = LAUNCHES.get(counter, 0) + 1
