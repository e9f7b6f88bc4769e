"""The one place that compiles and loads the CUDA kernels.

Each ``repro_torch/csrc/*.cu`` source is compiled by ``nvcc`` for Hopper
(``sm_90a``) into its own shared library with a plain C interface under
``<checkout>/build/repro_torch/`` at first use, and loaded with
``ctypes``.  A library's file name carries a hash of its source, of the
shared headers and of the flags, so an edited source is rebuilt and an
unchanged one is reused.
:func:`build_all` starts one ``nvcc`` per source, all at once.

Calling convention of every exported function: pointers and the CUDA
stream are ``void*`` (``ctypes.c_void_p`` — without declared ``argtypes``
ctypes would cut a pointer to 32 bits), sizes are integers, and the
return value is ``cudaGetLastError()`` after the launch (0 on success).
Each build prints the compiler's ``-Xptxas -v`` report (registers,
shared memory, spills).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = (pathlib.Path(__file__).resolve().parents[3] / "build"
             / "repro_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_I32 = ctypes.c_int
_F32 = ctypes.c_float

# exported C functions of each source -> their argument types
SIGNATURES = {
    # features: data, cmd, prev_rw, ones, togg, (lines, padded trace
    # length), stream; state: cmd, bank, col, prev_rw, state, (traces,
    # padded trace length), stream
    "features": {
        "repro_features": [_P] * 5 + [_I64, _I64, _P],
        "repro_state": [_P] * 5 + [_I64, _I64, _P],
    },
    # charge kernels: the planes, the output, then (n_traces, n_cmds,
    # n_vendors, cluster, group, phase) and the stream
    "vampire_energy": {
        name: [_P] * 10 + [_I32] * 6 + [_P]
        for name in ("repro_vampire_charge", "repro_vampire_charge_surface")
    },
    "baseline_energy": {
        f"repro_{kind}_charge{sfx}": [_P] * 9 + [_I32] * 6 + [_P]
        for kind in ("micron", "drampower") for sfx in ("", "_surface")
    },
    "line_bits": {
        "repro_line_ones": [_P, _P, _I64, _P],
        "repro_line_toggles": [_P, _P, _P, _I64, _P],
        "repro_line_toggles_seq": [_P, _P, _I64, _P],
    },
    "byte_lut": {
        "repro_apply_lut_lines": [_P, _P, _P, _I64, _P],
    },
    "bdi": {
        "repro_bdi_sizes": [_P, _P, _P, _I64, _P],
    },
    # the forward: q, k, v, out, lse (or null), (bh, bh_kv, sq, skv, d, dv),
    # the scale, (causal, q_offset, is_bf16) and the stream
    "flash_attention": {
        "repro_flash_attention": [_P] * 5 + [_I32] * 6 + [_F32]
        + [_I32] * 3 + [_P],
    },
    # the backward: K0 out, dout, delta, (bh, sq, dv, is_bf16) and the
    # stream; K1 and K2 their tensors, (bh, bh_kv, sq, skv, d, dv), the
    # scale, (causal, is_bf16) and the stream
    "flash_attention_bwd": {
        "repro_flash_bwd_prep": [_P] * 3 + [_I32] * 4 + [_P],
        **{f"repro_flash_bwd_{name}": [_P] * n + [_I32] * 6 + [_F32]
           + [_I32] * 2 + [_P] for name, n in (("dkdv", 8), ("dq", 7))},
    },
}

_LIBS: dict[str, ctypes.CDLL] = {}
nvcc_starts = 0     # nvcc processes started in this process


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def _target(name: str) -> pathlib.Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha1(src + headers + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:12]}.so"


def _start(name: str, target: pathlib.Path) -> subprocess.Popen:
    global nvcc_starts
    nvcc_starts += 1
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _finish(name: str, target: pathlib.Path, proc: subprocess.Popen) -> None:
    out, _ = proc.communicate()
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}.cu:\n{out}")
    os.replace(tmp, target)
    print(f"[build] {name}.cu -> {target.name}", flush=True)
    for line in out.splitlines():
        print(f"[build]   {line.strip()}", flush=True)


def _load(name: str, target: pathlib.Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(target))
    for fn, argtypes in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    _LIBS[name] = lib
    return lib


def build_all() -> dict[str, ctypes.CDLL]:
    """Compile every source that has no library yet (one ``nvcc`` each,
    all started together) and load them all."""
    todo = {}
    for name in SIGNATURES:
        if name in _LIBS:
            continue
        target = _target(name)
        if not target.exists():
            todo[name] = (target, _start(name, target))
    for name, (target, proc) in todo.items():
        _finish(name, target, proc)
    for name in SIGNATURES:
        if name not in _LIBS:
            _load(name, _target(name))
    return dict(_LIBS)


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        target = _target(name)
        if not target.exists():
            _finish(name, target, _start(name, target))
        lib = _load(name, target)
    return lib


def check(rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(device) -> ctypes.c_void_p:
    """The current PyTorch CUDA stream of ``device`` as a ``void*``."""
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
