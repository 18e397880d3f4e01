"""Probe of the fused-pass NTT (kernels K3 and K4) on one CUDA card.

    python3 -m halo2_aggregation_tpu_torch.tools.ntt_probe [--k 21] [--cols 39]

Prints ptxas' report for `csrc/ntt.cu`, what the runtime says of the pass
kernels' occupancy (shared memory a block, blocks an SM), and then, one JSON
object a line:

* K3 and K4 against their plain versions (equal bits) at k = 1, 5, 9, 13 and
  16 on 2 columns and at k on 4 columns, with the launch counts against
  `pass_plan`;
* at `cols` columns of size 2^k: intt(ntt(x)) == x, the first 4 columns
  against the 4-column result, the time of each whole transform and of
  each pass alone (CUDA events, mean of 3 after a warm-up), the products a
  second and the bytes a second each pass reaches;
* one host-clocked call of each plain version on the card: K3 and K4 on
  the `cols` columns, K5's scalar product on 4 columns and its power
  series at 2^k (minutes at the defaults).

A mismatch raises.  Exits 1 without a card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

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


def random_stack(rng, cols: int, n: int, device):
    """(cols, n, 8) int32 canonical values (top limb below r's) on `device`."""
    import numpy as np
    import torch

    a = rng.integers(0, 1 << 32, size=(cols, n, 8), dtype=np.uint32)
    a[..., 7] &= 0x1FFF_FFFF
    return torch.from_numpy(a.view(np.int32)).to(device)


def check_transforms(nt, rng, k: int, cols: int, device) -> dict:
    """K3 and K4 against their plain versions on `cols` random columns."""
    import torch

    tables = nt.NttTables(k, device)
    x = random_stack(rng, cols, 1 << k, device)
    plan = nt.pass_plan(k)
    nt.ntt_batched.launches = nt.intt_batched.launches = 0
    fwd = nt.ntt_batched(x.clone(), tables.fwd)
    inv = nt.intt_batched(x.clone(), tables.inv, tables.n_inv)
    launches = [nt.ntt_batched.launches, nt.intt_batched.launches]
    if launches != [len(plan)] * 2:
        raise AssertionError(f"k = {k}: {launches} launches for a plan of {len(plan)} passes")
    if not torch.equal(fwd, nt.ntt_plain(x, tables.fwd)):
        raise AssertionError(f"K3 != plain at k = {k}")
    if not torch.equal(inv, nt.intt_plain(x, tables.inv, tables.n_inv)):
        raise AssertionError(f"K4 != plain at k = {k}")
    return {"k": k, "columns": cols, "plan": plan, "launches": launches, "equal_to_plain": True}


def host_ms(fn) -> float:
    """Milliseconds of one call on the host clock, synchronised."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def plain_times(nt, tables, x, k: int) -> dict:
    """One call of each plain version on the card at the kernels' shapes:
    K3 and K4 on the whole stack x, K5's scalar product on its first 4
    columns and its power series at 2^k in bit-reversed order."""
    s = nt.mont_tensor(5, x.device)
    return {
        "plain_ms": {
            "ntt": host_ms(lambda: nt.ntt_plain(x, tables.fwd)),
            "intt": host_ms(lambda: nt.intt_plain(x, tables.inv, tables.n_inv)),
            "ew_mul_scalar_4_columns": host_ms(lambda: nt.mul_plain(x[:4], s)),
            "pow_series": host_ms(lambda: nt.pow_series_plain(nt.mont_tensor(1, x.device), s, k, True)),
        },
        "columns": x.shape[0], "k": k,
    }


def main() -> int:
    import numpy as np
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--k", type=int, default=21)
    ap.add_argument("--cols", type=int, default=39)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ntt_probe: torch.cuda.is_available() is False; this run needs a CUDA card", file=sys.stderr)
        return 1

    from ..ops import build
    from ..ops import ntt as nt

    device = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    emit({"card": smi, "torch": torch.__version__, "cuda": torch.version.cuda})
    t0 = time.perf_counter()
    lib_path = build.build_library()
    lib = build.load_library()
    emit({"build_s": time.perf_counter() - t0})
    show = False
    for line in (lib_path.parent / "ptxas.log").read_text().splitlines():
        if line.startswith("#"):
            show = "ntt.cu" in line
            print("ptxas: " + line.strip(), flush=True)
        elif show and ("registers" in line or "spill" in line or "Compiling entry" in line):
            print("ptxas: " + line.strip(), flush=True)

    k, cols = args.k, args.cols
    n = 1 << k
    emit({"occupancy": {"ntt": nt.pass_occupancy(False, k), "intt": nt.pass_occupancy(True, k)}})
    rng = np.random.default_rng(SEED)
    for kk in (1, 5, 9, 13, 16):
        emit(check_transforms(nt, rng, kk, 2, device))
    emit(check_transforms(nt, rng, k, 4, device))

    tables = nt.NttTables(k, device)
    x = random_stack(rng, cols, n, device)
    evals = nt.ntt_batched(x.clone(), tables.fwd)
    if not torch.equal(evals[:4], nt.ntt_batched(x[:4].clone(), tables.fwd)):
        raise AssertionError(f"K3 on {cols} columns != K3 on its first 4")
    if not torch.equal(nt.intt_batched(evals, tables.inv, tables.n_inv), x):
        raise AssertionError("intt(ntt(x)) != x")
    del evals
    stream = build.stream_ptr(device)
    plan = nt.pass_plan(k)
    for dif, name, tw in ((False, "ntt", tables.fwd), (True, "intt", tables.inv)):
        run = (lambda: nt.intt_batched(x, tables.inv, tables.n_inv)) if dif else (lambda: nt.ntt_batched(x, tables.fwd))
        rec = {"kernel": name, "k": k, "columns": cols, "ms": cuda_ms(run), "passes": []}
        for s0, r in plan:
            scale = tables.n_inv.data_ptr() if dif and s0 == 0 else None
            ms = cuda_ms(lambda: build.check(
                lib.h2a_ntt_pass(x.data_ptr(), tw.data_ptr(), scale, cols, k, s0, r, int(dif), stream), "h2a_ntt_pass"))
            products = cols * (r * (n // 2) + (n if scale else 0))
            rec["passes"].append({
                "s0": s0, "r": r, "c": nt.pass_chunk_bits(k, s0, r), "ms": ms,
                "g_products_per_s": products / ms / 1e6, "tb_per_s": 2 * cols * n * 32 / ms / 1e9,
            })
        emit(rec)
    emit(plain_times(nt, tables, x, k))
    emit({"ok": True})
    return 0


if __name__ == "__main__":
    sys.exit(main())
