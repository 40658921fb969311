"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` for ``sm_90a`` into an object file, all at
once in parallel, and the objects link into one shared library with a plain
C interface, loaded with ``ctypes``. The build goes to
``build/gliclass_kernels-<hash>/`` at the repository root, keyed by a hash of
the sources and flags, so an unchanged tree builds once and a changed one
builds anew. Nothing here runs at import time: :func:`lib` builds on first
use, which only a CUDA tensor reaches.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(_CSRC)))
_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-lineinfo",
]

_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
# C entry points: name -> argtypes (every entry returns a cudaError_t as int).
_SIGNATURES = {
    "gct_flash_disentangled_attention": [
        _I, _P, _I, _I, _I, _P, _P, _I, _I, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P,
    ],
    "gct_fused_ffn_w8a8": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "gct_fused_ffn_w8a8_smem": [_I, _I],
    "gct_fused_ffn_wonly": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "gct_fused_ffn_wonly_smem": [_I, _I],
    "gct_int8_matmul": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "gct_causal_flash_attention": [
        _I, _P, _I, _I, _I, _I, _P, _I, _I, _I, _P, _I, _I, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _P,
    ],
    "gct_abs_pos_table": [_I, _P, _P, _I, _I, _I, _P],
    "gct_bias_fused_attention": [
        _I, _I, _P, _P, _P, _L, _L, _L, _P, _L, _L, _L, _L, _P, _L, _L, _L, _L, _P, _P, _I, _I, _I, _F, _P,
    ],
    "gct_row_disentangled_attention": [_I, _P, _P, _P, _L, _L, _L, _P, _P, _P, _P, _I, _I, _I, _F, _P],
    "gct_windowed_pos_table": [_I, _P, _P, _I, _I, _I, _I, _P],
    "gct_tiled_disentangled_attention": [
        _I, _I, _P, _P, _P, _L, _L, _L, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P,
    ],
    "gct_row_disentangled_attention_tc": [_P, _P, _P, _L, _L, _L, _P, _P, _P, _P, _I, _I, _I, _F, _P],
    "gct_tiled_disentangled_attention_tc": [
        _P, _P, _P, _L, _L, _L, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P,
    ],
    "gct_int8_matmul_tc": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
    "gct_fused_ffn_wonly_tc": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "gct_causal_flash_attention_tc": [
        _P, _I, _I, _I, _I, _P, _I, _I, _I, _P, _I, _I, _I, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _P,
    ],
    "gct_bias_fused_attention_tc": [
        _P, _P, _P, _L, _L, _L, _P, _L, _L, _L, _L, _P, _L, _L, _L, _L, _P, _P, _I, _I, _I, _F, _P,
    ],
    "gct_flash_disentangled_attention_tc": [
        _P, _L, _L, _L, _P, _P, _L, _L, _L, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P,
    ],
    "gct_fused_ffn_w8a8_tc": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "gct_fused_ffn_w8a8_tc_up": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "gct_fused_ffn_w8a8_tc_down": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
}

_LIB = None
_LOCK = threading.Lock()


def _sources() -> list[str]:
    return sorted(
        os.path.join(_CSRC, f) for f in os.listdir(_CSRC) if f.endswith((".cu", ".cuh"))
    )


def _digest() -> str:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for path in _sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernels")


def build(verbose: bool = False) -> str:
    """Compile the kernels (if this tree's build is missing); return the
    library path. Compiles one ``nvcc`` per source in parallel, then links."""
    out_dir = os.path.join(_ROOT, "build", f"gliclass_kernels-{_digest()}")
    lib_path = os.path.join(out_dir, "libgliclass_kernels.so")
    if os.path.exists(lib_path):
        return lib_path
    os.makedirs(out_dir, exist_ok=True)
    nvcc = _nvcc()
    cus = [s for s in _sources() if s.endswith(".cu")]
    objs, procs = [], []
    for src in cus:
        obj = os.path.join(out_dir, os.path.basename(src)[:-3] + ".o")
        cmd = [nvcc, *_FLAGS, "-c", src, "-o", obj]
        if verbose:
            cmd += ["-Xptxas", "-v"]
        procs.append((src, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        objs.append(obj)
    failed = []
    for src, p in procs:
        log, _ = p.communicate()
        if p.returncode != 0:
            failed.append(f"{os.path.basename(src)}:\n{log}")
        elif verbose and log.strip():
            print(f"[nvcc {os.path.basename(src)}]\n{log}", flush=True)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    tmp = lib_path + f".tmp{os.getpid()}"
    link = subprocess.run(
        [nvcc, *_FLAGS, "-shared", *objs, "-o", tmp],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if link.returncode != 0:
        raise RuntimeError("kernel link failed:\n" + link.stdout)
    os.replace(tmp, lib_path)
    return lib_path


def lib(verbose: bool = False) -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            handle = ctypes.CDLL(build(verbose))
            for name, args in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = args
                fn.restype = ctypes.c_int
            _LIB = handle
        return _LIB


def check(rc: int, name: str) -> None:
    """Raise if a kernel entry returned a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc}")


def refuse_grad(name: str, *tensors) -> None:
    """Raise where autograd would record through a kernel: a launch through
    ``ctypes`` returns a tensor with no ``grad_fn``, so gradients would stop
    there without a word (the JAX package cannot differentiate a
    ``pallas_call`` without a VJP either). Under ``torch.no_grad`` or
    ``torch.inference_mode`` (the engine) nothing is checked. Every kernel
    wrapper calls it first, on either device, so a trainer that reaches a
    kernel fails on the CPU as it would on the card."""
    import torch

    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: an input requires grad, and the kernel has no backward; "
            "train through the plain formulations (attn_route 'xla', unquantized weights)"
        )


def stream_ptr(t) -> int:
    """PyTorch's current stream on ``t``'s device, as an address."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
