"""Build and load the CUDA kernels (`csrc/*.cu`).

nvcc compiles each source to an object for sm_90a (H100), all sources at
once in parallel processes, and links the objects into one shared library
with a plain C interface, in `build/kernels/<hash>/` at the root of the
checkout, keyed by a hash of the sources and flags, at first use.
`ctypes` loads it; every pointer and the stream pass as `c_void_p`, and
every entry point returns `cudaGetLastError()`, which `check` turns into an
exception.  PyTorch's headers are not included, which keeps a build to
seconds.  A missing nvcc or a failed build raises: there is no fallback.

`build_host_library` compiles the same headers with g++ through
`csrc/host_shim.cpp`, so the CPU tests can run the kernels' per-lane code.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "kernels"
KERNEL_SOURCES = (
    "ec_win.cu", "ec_ladder.cu", "fa_tape.cu", "jac_sum.cu", "ntt.cu", "ew.cu", "quotient_tape.cu",
    "msm.cu",
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
LIB_NAME = "libh2a_kernels.so"

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_SIGNATURES = {
    # px, py, pz, scalars, consts, ox, oy, oz, n, threads (0: from n), stream
    "h2a_ec_win": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P],
    # n, threads (out): the block the launcher takes for n lanes
    "h2a_ec_win_block": [_I, _P],
    # px, py, pz, scalars, consts, ox, oy, oz, n, nbits, stream
    "h2a_ec_ladder": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P],
    # n, threads (out): the block the launcher takes for n lanes
    "h2a_ec_ladder_block": [_I, _P],
    # tape, n_instr, consts, n_consts, in, n_in, n_tmp, out_regs, n_out, out,
    # lanes, stream
    "h2a_fa_tape": [_P, _I, _P, _I, _P, _I, _I, _P, _I, _P, _I, _P],
    # px, py, pz, batch_stride, lane_stride, offsets, n_seg, batch, ox, oy, oz,
    # stream
    "h2a_jac_segment_sum": [_P, _P, _P, _L, _L, _P, _I, _I, _P, _P, _P, _P],
    # x, tw, scale (or null), cols, k, s0, r, dif, stream
    "h2a_ntt_pass": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    # dif, tile_bytes, blocks_per_sm (out), sms (out)
    "h2a_ntt_occupancy": [_I, _I, _P, _P],
    # x, col, out, cols, n, stream
    "h2a_ew_mul_col": [_P, _P, _P, _I, _I, _P],
    # x, s, out, total, stream
    "h2a_ew_mul_scalar": [_P, _P, _P, _L, _P],
    # field (0 = Fq, 1 = Fr), a, b, out, n, stream
    "h2a_mont_mul": [_I, _P, _P, _P, _I, _P],
    # field, a, b, out, blocks (of one warp), iters, stream
    "h2a_mul_chain": [_I, _P, _P, _P, _I, _I, _P],
    # tables, squares, k, bitrev, stream
    "h2a_pow_series_tables": [_P, _P, _I, _I, _P],
    # out, tables, k, stream
    "h2a_pow_series_products": [_P, _P, _I, _P],
    # tape, n_instr, consts, in_src, in_rot, n_in, stack, x, uniforms, n,
    # out_reg, out, stream
    "h2a_quotient_tape": [_P, _I, _P, _P, _P, _I, _P, _P, _P, _I, _I, _P, _P],
    # is_signed, xs, ys, digits, n, chunks, order, bsums, partials, wsums,
    # ticket, out, stream
    "h2a_msm": [_I, _P, _P, _P, _I, _I, _P, _P, _P, _P, _P, _P, _P],
    # is_signed, blocks_per_sm (out), sms (out)
    "h2a_msm_occupancy": [_I, _P, _P],
}


def find_nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
        if cand.is_file():
            path = str(cand)
    if path is None:
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels cannot be built"
        )
    return path


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return h.hexdigest()[:16]


def build_library(build_root: Path = BUILD_ROOT) -> Path:
    """Compile the kernels unless this source hash is built already: one
    nvcc process per source, all started together, then one link.
    Returns the library's path; nvcc's ptxas report (registers, spills)
    is kept beside it as `ptxas.log`."""
    out_dir = Path(build_root) / _source_hash()
    lib = out_dir / LIB_NAME
    if lib.is_file():
        return lib
    nvcc = find_nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    t0 = time.perf_counter()
    jobs = []
    for src in KERNEL_SOURCES:
        obj = out_dir / f"{Path(src).stem}.{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, f"-I{CSRC}", "-c", "-o", str(obj), str(CSRC / src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((cmd, obj, proc))
    log, failed = [], []
    for cmd, _, proc in jobs:
        out, _ = proc.communicate()
        log.append(f"# done by {time.perf_counter() - t0:.1f} s: {' '.join(cmd)}\n{out}")
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}")
    if failed:
        raise RuntimeError("\n".join(failed))
    tmp = out_dir / f"{LIB_NAME}.{tag}"
    cmd = [nvcc, "-shared", "-o", str(tmp), *(str(obj) for _, obj, _ in jobs)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{' '.join(cmd)}\n{res.stdout}\n{res.stderr}")
    for _, obj, _ in jobs:
        obj.unlink()
    (out_dir / "ptxas.log").write_text(
        f"# {time.perf_counter() - t0:.1f} s: {len(jobs)} sources in parallel, then link\n" + "".join(log)
    )
    os.replace(tmp, lib)
    return lib


@functools.cache
def load_library() -> ctypes.CDLL:
    """The kernels' library, built on first use, with its signatures set."""
    lib = ctypes.CDLL(str(build_library()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(rc: int, name: str) -> None:
    """Raise on a nonzero cudaError_t returned by an entry point."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def stream_ptr(device) -> int:
    """PyTorch's current CUDA stream on `device`, as a pointer for ctypes."""
    return torch.cuda.current_stream(device).cuda_stream


def build_host_library(out_dir) -> ctypes.CDLL:
    """g++ build of `csrc/host_shim.cpp` (the kernels' headers on the host)
    into `out_dir`, loaded with ctypes."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError("g++ not found")
    so = Path(out_dir) / "libh2a_host_core.so"
    cmd = [
        gxx, "-std=c++17", "-O2", "-Wno-unknown-pragmas", "-shared", "-fPIC",
        f"-I{CSRC}", "-o", str(so), str(CSRC / "host_shim.cpp"),
    ]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed:\n{res.stderr}")
    lib = ctypes.CDLL(str(so))
    sigs = {
        "h2a_host_mont_mul": [_I, _P, _P, _P, _I],
        "h2a_host_mont_mul_cc": [_I, _P, _P, _P, _I],
        "h2a_host_add_sub": [_I, _I, _P, _P, _P, _P, _I],
        "h2a_host_jac_add": [_P, _P, _P, _I],
        "h2a_host_jac_add_mixed": [_P, _P, _P, _P, _I],
        "h2a_host_ec_win": [_P, _P, _P, _P, _P, _P, _P, _P, _I],
        "h2a_host_inv": [_I, _P, _P, _I],
        "h2a_host_glv_split": [_P, _P, _P, _P, _I],
        "h2a_host_jac_segment_sum": [_P, _P, _P, _L, _L, _P, _I, _I, _P, _P, _P],
        "h2a_host_ec_ladder": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I],
        "h2a_host_ec_ladder_rounds": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I],
        "h2a_host_msm_sort": [_I, _P, _I, _I, _I, _P, _P],
        "h2a_host_msm_partials": [_I, _P, _P, _P, _I, _I, _P, _P, _P],
        "h2a_host_msm_horner": [_I, _P, _P],
        "h2a_host_fa_tape": [_P, _I, _P, _P, _I, _P, _P, _I, _P, _I],
        "h2a_host_fa_tape_shared": [_P, _I, _P, _P, _I, _I, _P, _I, _P, _I, _I],
        "h2a_host_ntt_stage": [_P, _P, _I, _I, _I, _I],
        "h2a_host_ntt_pass": [_P, _P, _P, _I, _I, _I, _I, _I],
        "h2a_host_ntt_tile_indices": [_I, _I, _I, _P],
        "h2a_host_pow_series": [_P, _P, _I, _I],
        "h2a_host_quotient_rows": [_P, _I, _P, _P, _P, _I, _P, _P, _P, _I, _I, _P, _I, _P],
    }
    for name, argtypes in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = _I if name in ("h2a_host_msm_sort", "h2a_host_ntt_pass") else None
    return lib
