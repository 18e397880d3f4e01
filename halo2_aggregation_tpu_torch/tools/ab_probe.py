"""Times K5's power series and K8 of the port found under a root, so that two
trees can be compared in one call on one card.

    python3 halo2_aggregation_tpu_torch/tools/ab_probe.py [--root DIR]

`--root` is the root of a checkout (default: this file's own); the port
there is imported and its kernels built from its sources.  Prints the
card's name and power limit, then one JSON object: the series at k = 21 in
bit-reversed order (the coset scale of `DeviceQuotient`), its launches on
inputs already on the card and the whole `pow_series` call, and K8 over 256
bits at 4,608 lanes (the verifier's) and at 2^17, each the mean of CUDA-
event-timed launches queued behind a 20 ms spin of the stream.  The inputs
are made from a seed, the same for every root, and the series' hash is
printed so that two trees can be seen to agree (`chip_smoke.py` holds
both kernels to their plain versions).  Exits 1 without a card.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

SEED = 20261016


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def digest(*ts) -> str:
    h = hashlib.sha256()
    for t in ts:
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
    args = ap.parse_args()
    sys.modules["jax"] = None
    sys.modules["halo2_aggregation_tpu"] = None
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("ab_probe: torch.cuda.is_available() is False; this run needs a CUDA card", file=sys.stderr)
        return 1
    from halo2_aggregation_tpu_torch.fields import FR_GENERATOR, R
    from halo2_aggregation_tpu_torch.ops import build
    from halo2_aggregation_tpu_torch.ops import curve_ops as co
    from halo2_aggregation_tpu_torch.ops import ec_kernels as ek
    from halo2_aggregation_tpu_torch.ops import ntt as nt
    from halo2_aggregation_tpu_torch.oracle import curve as oc
    from halo2_aggregation_tpu_torch.utils import native

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    device = torch.device("cuda", 0)
    t0 = time.perf_counter()
    build.load_library()
    out = {"root": root, "build_s": time.perf_counter() - t0}

    k = 21
    shift = FR_GENERATOR * 0x1234_5678 % R
    series = nt.pow_series(shift, k, device, bitrev=True)
    out["series_digest"] = digest(series)
    if hasattr(nt, "pow_series_tables"):  # two launches on the uploaded squares
        sq = nt.pow_series_squares(shift, k, device)
        tables = nt.pow_series_tables(sq, k, True)
        out["series_tables_ms"] = cuda_ms(lambda: nt.pow_series_tables(sq, k, True), reps=20)
        out["series_products_ms"] = cuda_ms(lambda: nt.pow_series_products(tables, k), reps=20)

        def launches():
            nt.pow_series_products(nt.pow_series_tables(sq, k, True), k)
    else:  # one launch on the uploaded start and base
        lib = build.load_library()
        one, b = nt.mont_tensor(1, device), nt.mont_tensor(shift, device)

        def launches():
            build.check(lib.h2a_pow_series(series.data_ptr(), one.data_ptr(), b.data_ptr(), k, 1,
                                           build.stream_ptr(device)), "h2a_pow_series")
    out["series_kernel_ms"] = cuda_ms(launches, reps=20)
    # the whole call, the host's squares and their upload included
    out["series_call_ms"] = cuda_ms(lambda: nt.pow_series(shift, k, device, bitrev=True), reps=20)

    rng = np.random.default_rng(SEED)
    base = native.g1_batch_mul(oc.g1_generator(), [int.from_bytes(rng.bytes(32), "little") % R for _ in range(4608)])
    P0 = co.affine_to_jac(co.affine_from_ints(base, device))
    for n in (4608, 1 << 17):
        idx = torch.arange(n, device=device) % 4608
        P = co.JacPoint(*(c[idx].contiguous() for c in P0))
        raw = rng.integers(0, 1 << 32, size=(n, 8), dtype=np.uint64).astype(np.uint32)
        s = torch.from_numpy(raw.view(np.int32)).to(device)
        key = str(n)
        out["k8_ms_" + key] = [cuda_ms(lambda: ek.scalar_mul_ladder(P, s, 256), reps=3 if n > 4608 else 10)
                               for _ in range(2)]
        if hasattr(ek, "ladder_block"):
            out["k8_block_" + key] = ek.ladder_block(n)
    emit(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
