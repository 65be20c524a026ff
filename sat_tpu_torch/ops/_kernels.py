"""Build and load the port's CUDA kernels.

Every `csrc/*.cu` file is compiled by nvcc for sm_90a into one shared
library with a plain C interface, `build/libsat_kernels.so`, which ctypes
loads. Nothing is built when a module is imported: the first wrapper that
launches a kernel on a CUDA tensor calls `library()`, which builds once per
source hash (a changed source, or changed flags, rebuilds) and loads it.
The sources compile in parallel, one nvcc process each, and link once.

Only the sources in the checkout are built; nothing is downloaded, and
nvcc is looked up on PATH, then under $CUDA_HOME or /usr/local/cuda.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = Path(__file__).resolve().parent / "build"
LIB_NAME = "libsat_kernels.so"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                              "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
# name -> argtypes of every C entry in the library. Pointers and the stream
# are c_void_p: without argtypes ctypes passes Python ints as 32-bit ints
# and cuts the pointer.
SIGNATURES = {
    # x, values, indices, rows, n, k, cluster, workspace, stream
    "sat_topk_f32": (_P, _P, _P, _I, _I, _I, _I, _P, _P),
    # n, k, the address of an int64 that receives a row's workspace bytes
    "sat_topk_workspace_bytes": (_I, _I, _P),
    # keys, feats, u_h, v, b_v, ctx, alpha, images, rows_per_image, L, E, D,
    # stream
    "sat_attention_fwd_f32": (_P, _P, _P, _P, _P, _P, _P,
                              _I, _I, _I, _I, _I, _P),
    # keys, feats, u_h, v, alpha, dctx, dalpha, dkeys, dfeats (or null),
    # du_h, dv_part, dbv_part, images, L, E, D, stream
    "sat_attention_bwd_f32": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                              _P, _I, _I, _I, _I, _P),
}
# The bf16 variants take the same arguments, keys and feats (and dkeys and
# dfeats) in bf16.
SIGNATURES["sat_attention_fwd_bf16"] = SIGNATURES["sat_attention_fwd_f32"]
SIGNATURES["sat_attention_bwd_bf16"] = SIGNATURES["sat_attention_bwd_f32"]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = os.path.join(home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError("nvcc not found on PATH, under $CUDA_HOME or "
                       "/usr/local/cuda: the CUDA kernels cannot be built")


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(COMPILE_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()


def build(force: bool = False) -> str:
    """Compile csrc/*.cu into build/libsat_kernels.so unless a library of
    the same source hash is there. Returns nvcc's output (ptxas register
    and spill report included), "" when nothing was built."""
    digest = source_hash()
    lib = BUILD / LIB_NAME
    stamp = BUILD / (LIB_NAME + ".sha256")
    if (not force and lib.exists() and stamp.exists()
            and stamp.read_text() == digest):
        return ""
    nvcc = nvcc_path()
    BUILD.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD) as tmp:
        procs = []
        for src in sources():
            obj = os.path.join(tmp, src.stem + ".o")
            cmd = [nvcc, *COMPILE_FLAGS, "-c", str(src), "-o", obj]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = [], []
        for src, _, proc in procs:
            out, _ = proc.communicate()
            logs.append(f"== {src.name}\n{out}")
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
        tmp_lib = os.path.join(tmp, LIB_NAME)
        link = subprocess.run(
            [nvcc, *ARCH_FLAGS, "-shared", "-o", tmp_lib,
             *(obj for _, obj, _ in procs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_lib, lib)
        stamp.write_text(digest)
    return "\n".join(logs)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            build()
            lib = ctypes.CDLL(str(BUILD / LIB_NAME))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


_count_lock = threading.Lock()


def count(wrapper, attr: str = "launches") -> None:
    """Add one to a wrapper's launch count. Under a lock: a serving mesh
    launches from one thread a replica, and `+=` on an attribute is a
    read-modify-write."""
    with _count_lock:
        setattr(wrapper, attr, getattr(wrapper, attr) + 1)


def check_launch(name: str, rc: int) -> None:
    """Raise when a C entry reports a CUDA error (cudaGetLastError after the
    launch): a refused launch never runs, and a later synchronize would not
    say so."""
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{rc}")
