"""Build and load the hand-written CUDA kernels.

Every ``csrc/*.cu`` is compiled with ``nvcc`` for ``sm_90a`` at first use
(one ``nvcc -c`` per source, all started together, then one link) into a
single shared library with a plain C interface, loaded with ``ctypes``.
The library lands in ``build/repro_torch/<hash of the sources>/`` at the
root of the checkout, so an edited source never loads a stale build and
two processes that build at once never see each other's half-written file.
A build or load failure raises.

``launches`` counts, per kernel, the launches the wrappers made: each
wrapper adds one where it launches its kernel, and nowhere else.
``need`` and ``check`` are the wrappers' guards around a launch.
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
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

launches = {"semiring_spmv": 0, "semiring_spmv_frontier": 0,
            "megastep_semiring": 0, "resident_megastep": 0,
            "outbox_pack": 0, "outbox_compact_plan": 0,
            "flash_attention": 0, "mamba1_scan": 0,
            "flash_attention_bwd": 0, "mamba1_scan_bwd": 0}

_lib = None
_lock = threading.Lock()


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if home and (Path(home) / "bin" / "nvcc").exists():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _sources():
    srcs = sorted(CSRC.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return srcs


def _digest(srcs) -> str:
    h = hashlib.sha256()
    for s in srcs + sorted(CSRC.glob("*.cuh")):
        h.update(s.name.encode())
        h.update(s.read_bytes())
    h.update(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> Path:
    """Compile the sources into ``libkernels.so`` (if this exact build does
    not exist yet) and return its path. ``verbose`` builds anew with
    ``-Xptxas -v`` and prints the compiler's report of registers, spills
    and shared memory per kernel."""
    srcs = _sources()
    out_dir = BUILD_ROOT / _digest(srcs)
    lib_path = out_dir / "libkernels.so"
    if lib_path.exists() and not verbose:
        return lib_path
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        extra = ["-Xptxas", "-v"] if verbose else []
        objs, procs = [], []
        for s in srcs:
            obj = Path(tmp) / (s.stem + ".o")
            objs.append(obj)
            cmd = [nvcc, *ARCH_FLAGS, *NVCC_FLAGS, *extra, "-c", str(s),
                   "-o", str(obj)]
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for cmd, p in procs:
            out, _ = p.communicate()
            if verbose and out:
                print(out, flush=True)
            if p.returncode != 0:
                failed.append(f"{' '.join(cmd)}\n{out}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp_lib = Path(tmp) / "libkernels.so"
        link = [nvcc, *ARCH_FLAGS, "-shared", *map(str, objs), "-o",
                str(tmp_lib)]
        res = subprocess.run(link, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{' '.join(link)}\n"
                               f"{res.stdout}")
        os.replace(tmp_lib, lib_path)
    return lib_path


def _declare(lib) -> None:
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    ip = ctypes.POINTER(ctypes.c_int)
    # (x, nbr, wgt, y, rows, d, semiring, device, stream)
    lib.semiring_spmv_launch.argtypes = [vp] * 4 + [i32] * 4 + [vp]
    lib.semiring_spmv_launch.restype = i32
    # (x, frontier, nbr, wgt, y, row_active, rows, d, semiring, device,
    #  stream)
    lib.semiring_spmv_frontier_launch.argtypes = [vp] * 6 + [i32] * 4 + [vp]
    lib.semiring_spmv_frontier_launch.restype = i32
    # (active, vals, limit, pvals, sids, pinv, counts, over, rows, cap,
    #  ident, device, stream)
    lib.outbox_pack_launch.argtypes = ([vp] * 8 + [i32] * 2
                                       + [ctypes.c_float, i32, vp])
    lib.outbox_pack_launch.restype = i32
    # (active, pfwd, pinv, counts, rows, cap, device, stream)
    lib.outbox_compact_plan_launch.argtypes = [vp] * 4 + [i32] * 3 + [vp]
    lib.outbox_compact_plan_launch.restype = i32
    # (rows, device, stream): an empty kernel on K5's grid
    lib.outbox_launch_floor.argtypes = [i32] * 2 + [vp]
    lib.outbox_launch_floor.restype = i32
    # (out[2]: threads, slots)
    lib.outbox_pack_layout.argtypes = [ip]
    lib.outbox_pack_layout.restype = None
    # (16 inputs, 8 outputs and scratch; n, d, m_lo, m_hi, num_parts,
    #  v_max, unroll, dense_rows, min_plus, device; stream)
    lib.megastep_semiring_launch.argtypes = [vp] * 24 + [i32] * 10 + [vp]
    lib.megastep_semiring_launch.restype = i32
    # (num_parts, min_plus, device, out[8])
    lib.megastep_cluster_shape.argtypes = [i32] * 3 + [ip]
    lib.megastep_cluster_shape.restype = i32
    # (17 inputs, 10 outputs and scratch, the phase timer or NULL; n, d,
    #  m_lo, m_hi, num_parts, v_max, nf, max_steps, dense_rows, list_cap,
    #  min_plus, device; stream)
    lib.resident_megastep_launch.argtypes = [vp] * 28 + [i32] * 12 + [vp]
    lib.resident_megastep_launch.restype = i32
    # (n, num_parts, min_plus, device, out[2])
    lib.resident_grid_shape.argtypes = [i32] * 4 + [ip]
    lib.resident_grid_shape.restype = i32
    # (cluster_blocks, blocks, threads, iters, ns, device, stream)
    lib.barrier_probe_launch.argtypes = [i32] * 4 + [vp, i32, vp]
    lib.barrier_probe_launch.restype = i32
    # (q, k, v, o, B, Sq, Sk, H, KV, dh, causal, window, q_offset, bf16,
    #  scale, device, stream)
    lib.flash_attention_launch.argtypes = ([vp] * 4 + [i32] * 10
                                           + [ctypes.c_float, i32, vp])
    lib.flash_attention_launch.restype = i32
    # (q, k, v, o, B, Sq, Sk, H, KV, dh, causal, window, q_offset, scale,
    #  device, stream)
    lib.flash_attention_sm90_launch.argtypes = ([vp] * 4 + [i32] * 9
                                                + [ctypes.c_float, i32, vp])
    lib.flash_attention_sm90_launch.restype = i32
    # (x, delta, Bv, Cv, A, h0 or NULL, y, h_last or NULL, B, L, D, N,
    #  bf16, y_f32, device, stream)
    lib.mamba1_scan_launch.argtypes = [vp] * 8 + [i32] * 7 + [vp]
    lib.mamba1_scan_launch.restype = i32
    # (out[6]: lanes, channels, steps, stages, unroll, fused)
    lib.mamba1_scan_layout.argtypes = [ip]
    lib.mamba1_scan_layout.restype = None
    # (q, k, v, o, do, dq, dk, dv, stats, B, Sq, Sk, H, KV, dh, causal,
    #  window, q_offset, bf16, scale, device, stream)
    lib.flash_attention_bwd_launch.argtypes = ([vp] * 9 + [i32] * 10
                                               + [ctypes.c_float, i32, vp])
    lib.flash_attention_bwd_launch.restype = i32
    # (x, delta, Bv, Cv, A, h0 or NULL, dy, dh_last or NULL, dx, ddelta,
    #  dB, dC, dA, dh0 or NULL, scratch, B, L, D, N, bf16, dy_f32, device,
    #  stream)
    lib.mamba1_scan_bwd_launch.argtypes = [vp] * 15 + [i32] * 7 + [vp]
    lib.mamba1_scan_bwd_launch.restype = i32
    lib.mamba1_scan_bwd_steps.argtypes = []
    lib.mamba1_scan_bwd_steps.restype = i32
    lib.kernel_error_string.argtypes = [i32]
    lib.kernel_error_string.restype = ctypes.c_char_p


def library():
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            _declare(lib)
            _lib = lib
    return _lib


def need(t, name: str, dtype, device, shape) -> None:
    """Raise unless tensor ``t`` is what a kernel takes: on ``device``, of
    ``dtype`` and ``shape``, and contiguous."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check(err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error (``cudaGetLastError``)."""
    if err != 0:
        msg = library().kernel_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {err} ({msg})")
