"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared library
with a plain C interface, loaded through ``ctypes``; a source that takes
compile-time constants (the head width of the serial and pipelined
branch kernels, of the streaming chunk-pair kernels, of the segment-flash kernels and of the
quantized attention) builds one library per set of ``-D`` defines. The
libraries go to ``build/kernels/`` at the root of the checkout
(``.gitignore`` lists ``build/``), or to
``$XDG_CACHE_HOME/gigapath_tpu_torch/kernels`` (``~/.cache/...``) for an
installed package, named by a hash of the source, the shared
``csrc/*.cuh`` headers, the defines and the flags, so an edited source or
header rebuilds and an unchanged one loads as built. :func:`build_all` starts one ``nvcc`` per
library, all at once, and waits for them together.

Nothing here runs at import: the CPU tests import every module, on
machines that may have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent.parent / "csrc"


def _build_dir() -> Path:
    """``build/kernels`` at the root of the checkout the package sits in;
    for an installed package, a per-user cache directory instead."""
    root = Path(__file__).resolve().parents[2]
    if (root / "pyproject.toml").is_file() and (root / "gigapath_tpu_torch").is_dir():
        return root / "build" / "kernels"
    cache = os.environ.get("XDG_CACHE_HOME") or str(Path.home() / ".cache")
    return Path(cache) / "gigapath_tpu_torch" / "kernels"


BUILD_DIR = _build_dir()
# the libraries the flagship slide encoder (head width 48) runs, forward
# and backward, on the default route and on the direct-pack and
# stream-fusion routes, with the serial and the pipelined branch kernels
FLAGSHIP = (
    ("pack_phases", ()),
    ("dilated_branch_fwd", (("GP_HEAD_DIM", 48),)),
    ("unpack_phases", ()),
    ("dilated_branch_bwd_dq", (("GP_HEAD_DIM", 48),)),
    ("dilated_branch_bwd_dkv", (("GP_HEAD_DIM", 48),)),
    ("pack_phases_direct", ()),
    ("unpack_phases_direct", ()),
    ("fusion_epilogue_fwd", ()),
    ("fusion_epilogue_bwd", ()),
    ("dilated_branch_fwd_pipe", (("GP_HEAD_DIM", 48),)),
    ("dilated_branch_bwd_dq_pipe", (("GP_HEAD_DIM", 48),)),
    ("dilated_branch_bwd_dkv_pipe", (("GP_HEAD_DIM", 48),)),
)
# the libraries the flagship tile encoder's quantized tier (head width 64)
# runs
TILE_FLAGSHIP = (
    ("q_matmul", ()),
    ("q_flash_attention", (("GP_HEAD_DIM", 64),)),
)
# the libraries the flagship slide encoder's streaming chunked prefill (head
# width 48) runs: the chunk-pair forward and its backward
STREAM_FLAGSHIP = (
    ("stream_pair_fwd", (("GP_HEAD_DIM", 48),)),
    ("stream_pair_bwd_dq", (("GP_HEAD_DIM", 48),)),
    ("stream_pair_bwd_dkv", (("GP_HEAD_DIM", 48),)),
)
# the libraries the head-major dilated route and the flash entry points of
# the flagship slide encoder (head width 48) run: the segment-flash forward,
# dq and dkv, each in its segmented and its flat layout
FLASH_FLAGSHIP = (
    ("flash_fwd", (("GP_HEAD_DIM", 48),)),
    ("flash_bwd_dq", (("GP_HEAD_DIM", 48),)),
    ("flash_bwd_dkv", (("GP_HEAD_DIM", 48),)),
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_LLP = ctypes.POINTER(ctypes.c_longlong)
_IP = ctypes.POINTER(ctypes.c_int)
# C signature of each library's one entry point: (symbol, argtypes)
_SIGNATURES = {
    "pack_phases": ("gp_pack_phases", [_P, _P] + [_I] * 10 + [_P]),
    "unpack_phases": ("gp_unpack_phases", [_P, _P] + [_I] * 10 + [_P]),
    "dilated_branch_fwd": (
        "gp_dilated_branch_fwd", [_P] * 6 + [_I] * 6 + [_F, _P],
    ),
    "dilated_branch_bwd_dq": (
        "gp_dilated_branch_bwd_dq", [_P] * 8 + [_I] * 6 + [_F, _F, _P],
    ),
    "dilated_branch_bwd_dkv": (
        "gp_dilated_branch_bwd_dkv", [_P] * 9 + [_I] * 6 + [_F, _F, _P],
    ),
    "pack_phases_direct": ("gp_pack_phases_direct", [_P, _P] + [_I] * 8 + [_P]),
    "unpack_phases_direct": ("gp_unpack_phases_direct", [_P, _P] + [_I] * 8 + [_P]),
    "fusion_epilogue_fwd": ("gp_fusion_epilogue_fwd", [_LLP, _LLP, _IP, _I, _P, _P] + [_I] * 5 + [_P]),
    "fusion_epilogue_bwd": ("gp_fusion_epilogue_bwd", [_P] * 4 + [_I] * 9 + [_P]),
    "dilated_branch_fwd_pipe": ("gp_dilated_branch_fwd_pipe", [_P] * 6 + [_I] * 5 + [_F, _P]),
    "dilated_branch_bwd_dq_pipe": (
        "gp_dilated_branch_bwd_dq_pipe", [_P] * 8 + [_I] * 5 + [_F, _F, _P],
    ),
    "dilated_branch_bwd_dkv_pipe": (
        "gp_dilated_branch_bwd_dkv_pipe", [_P] * 9 + [_I] * 5 + [_F, _F, _P],
    ),
    "q_matmul": ("gp_q_matmul", [_P] * 5 + [_I] * 5 + [_P]),
    "q_flash_attention": ("gp_q_flash_attention", [_P] * 6 + [_I] * 6 + [_LLP, _P]),
    "stream_pair_fwd": ("gp_stream_pair_fwd", [_P] * 5 + [_I] * 3 + [_IP, _I, _LLP, _F, _P]),
    "stream_pair_bwd_dq": (
        "gp_stream_pair_bwd_dq", [_P] * 7 + [_I] * 3 + [_IP, _I, _LLP, _F, _F, _P],
    ),
    "stream_pair_bwd_dkv": (
        "gp_stream_pair_bwd_dkv", [_P] * 8 + [_I] * 3 + [_IP, _I, _LLP, _F, _F, _P],
    ),
    "flash_fwd": ("gp_flash_fwd", [_P] * 6 + [_I] * 9 + [_F, _P]),
    "flash_bwd_dq": ("gp_flash_bwd_dq", [_P] * 8 + [_I] * 9 + [_F, _F, _P]),
    "flash_bwd_dkv": ("gp_flash_bwd_dkv", [_P] * 9 + [_I] * 10 + [_F, _F, _P]),
}

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
# ptxas register / shared-memory report of the builds this process ran
build_log: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_nvcc = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cuda_nvcc):
        return cuda_nvcc
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a machine with the CUDA toolkit")


def _flags(defines) -> List[str]:
    return list(NVCC_FLAGS) + [f"-D{key}={value}" for key, value in defines]


def _label(name: str, defines) -> str:
    return name + "".join(f"-{key}={value}" for key, value in defines)


def _target(name: str, defines=()) -> Path:
    # the shared headers are part of every source's key
    src = b"".join(p.read_bytes() for p in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))])
    digest = hashlib.sha256(src + " ".join(_flags(defines)).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_all(specs=FLAGSHIP) -> List[Path]:
    """Compile every missing library of ``specs`` (``(source name,
    ((define, value), ...))`` pairs) in parallel; returns the library
    paths. Raises with the compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    jobs = []
    for name, defines in specs:
        target = _target(name, defines)
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *_flags(defines), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        jobs.append((_label(name, defines), target, tmp, proc))
    failures = []
    for label, target, tmp, proc in jobs:
        log, _ = proc.communicate()
        build_log[label] = log
        if proc.returncode != 0:
            failures.append(f"--- {label} (nvcc exit {proc.returncode}) ---\n{log}")
            continue
        os.replace(tmp, target)  # atomic: a concurrent loader never sees half a file
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return [_target(name, defines) for name, defines in specs]


def library(name: str, **defines) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` built with ``defines``
    (e.g. ``GP_HEAD_DIM=48``), built on first use, with its entry point's
    argument types declared."""
    spec = tuple(sorted(defines.items()))
    with _lock:
        lib = _loaded.get(_label(name, spec))
        if lib is None:
            target = _target(name, spec)
            if not target.exists():
                build_all(((name, spec),))
            lib = ctypes.CDLL(str(target))
            symbol, argtypes = _SIGNATURES[name]
            fn = getattr(lib, symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _loaded[_label(name, spec)] = lib
        return lib
