"""Probe of the bucket MSM (kernels K7 and K9) on one CUDA card.

    python3 -m halo2_aggregation_tpu_torch.tools.msm_probe [--k 21] [--k-small 16]

Counterpart of the JAX package's `tools/msm_probe.py`.  Times
`msm_bucket_s5` and `msm_bucket_u4` (CUDA events, mean of 3 after a
warm-up) over chunk counts around the one `ops/msm.py::choose_chunks`
takes:

* at n = 2^k on the SRS of `kzg.setup(k)` with a random column, for grids
  of 1, 2 and 4 waves of the bucket kernel's occupancy;
* at n = 2^k_small on the SRS's first points, for n / 64 down to n / 512
  chunks.

The chunk count `choose_chunks` takes also gets its time split between the
two launches (bucket pass, combine) by torch.profiler.  Every result is
compared with the native host MSM on the same inputs (equal affine
points), and a mismatch raises.  One JSON object a line.  Exits 1 without
a card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

SEED = 20261016


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps: int = 3) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def launch_split(fn) -> dict:
    """Milliseconds of one call of `fn` by kernel (bucket pass, combine),
    from torch.profiler's device events; empty if it recorded none."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            for key in ("msm_bucket_kernel", "msm_combine_kernel"):
                if key in e.name:
                    out[key] = out.get(key, 0.0) + e.time_range.elapsed_us() / 1e3
    return out


def main() -> int:
    import numpy as np
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--k", type=int, default=21)
    ap.add_argument("--k-small", type=int, default=16)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("msm_probe: torch.cuda.is_available() is False; this run needs a CUDA card", file=sys.stderr)
        return 1

    from ..ops import build

    # the SRS cache stays inside the checkout (build/ is not committed)
    os.environ.setdefault("H2A_PARAMS_CACHE", str(Path(build.BUILD_ROOT).parent / "h2a-params"))
    from ..ops import curve_ops as co
    from ..ops import msm as m
    from ..ops import msm_kernels as mk
    from ..ops.limbs import u64_to_port
    from ..plonk import kzg
    from ..utils import native

    device = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    emit({"card": smi, "torch": torch.__version__, "cuda": torch.version.cuda})
    t0 = time.perf_counter()
    build.load_library()
    emit({"build_s": time.perf_counter() - t0})

    rng = np.random.default_rng(SEED)
    n, ns = 1 << args.k, 1 << args.k_small
    params = kzg.setup(args.k)
    P = kzg.DeviceSRS(params, device).points

    def column(rows):
        a = rng.integers(0, 1 << 63, size=(rows, 4), dtype=np.uint64) * np.uint64(2)
        a[:, 3] &= np.uint64(0x1FFF_FFFF_FFFF_FFFF)
        return a

    cols = {n: column(n), ns: column(ns)}
    t0 = time.perf_counter()
    want = {rows: native.g1_msm_u64(params.g_lagrange_u64[:rows], params.g_lagrange_inf[:rows], col)
            for rows, col in cols.items()}
    emit({"native_host_msm_s": time.perf_counter() - t0})

    def affine(p):
        return co.jac_to_ints(co.JacPoint(*(c[None] for c in p)))[0]

    for signed, kernel, launch in ((True, "msm_s5", mk.msm_bucket_s5), (False, "msm_u4", mk.msm_bucket_u4)):
        blocks_per_sm, sms = mk.occupancy(signed)
        n_win = mk.WINDOWS[signed]
        grids = [(n, (blocks_per_sm * sms * waves // n_win) * mk.BLOCK_THREADS) for waves in (1, 2, 4)]
        grids += [(ns, ns // points) for points in (64, 128, 256, 512) if ns >= points]
        for rows, chunks in grids:
            s = torch.where(P.inf[:rows, None], 0, torch.from_numpy(u64_to_port(cols[rows])).to(device))
            d = m.signed_windows(s) if signed else m.unsigned_windows(s)
            x, y = P.x[:rows], P.y[:rows]
            got = affine(launch(x, y, d, chunks))
            if got != want[rows]:
                raise AssertionError(f"{kernel} n={rows} C={chunks}: {got} != native {want[rows]}")
            blocks = n_win * -(-chunks // mk.BLOCK_THREADS)
            run = {"kernel": kernel, "n": rows, "chunks": chunks, "points_a_chunk": mk.chunk_len(rows, chunks),
                   "blocks": blocks, "blocks_per_sm": blocks_per_sm, "sms": sms,
                   "waves": blocks / (blocks_per_sm * sms),
                   "ms": cuda_ms(lambda: launch(x, y, d, chunks)), "equal_to_native": True}
            if chunks == m.choose_chunks(rows, signed, blocks_per_sm, sms):
                run["chosen"] = True
                run["launch_ms"] = launch_split(lambda: launch(x, y, d, chunks))
            emit(run)
    emit({"ok": True})
    return 0


if __name__ == "__main__":
    sys.exit(main())
