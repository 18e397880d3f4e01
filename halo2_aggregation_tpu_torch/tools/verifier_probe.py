"""Probe of the verifier's device step (kernels K1, K2, K8 and the segmented
sum) on one CUDA card.

    python3 -m halo2_aggregation_tpu_torch.tools.verifier_probe [--batch 128]

Prints ptxas' report for `csrc/ec_win.cu`, `csrc/fa_tape.cu` and
`csrc/jac_sum.cu`, and then, one JSON object a line:

* the latency of one dependent Montgomery product (one warp an SM, 10,000
  products in series), Fq and Fr;
* K1 at 4,608, 2^14 and 2^17 lanes at the block the launcher chooses (0)
  and at blocks of 32 to 384 threads, each launch equal to the first as a
  group element, with K8 at the same lane counts beside it;
* K2 (the tape with the e-lane's scalar) at batches of 8, 32, 128, 1,024
  and 8,192 synthetic proofs of the simple example at k = 9, each equal to
  its plain version on the first 8 lanes;
* the segmented sum at `batch` proofs of 4, 4, 27 and 1 lanes, and the
  pieces of `fast_device` (`torch.stack` of K2's inputs, the `cat`s, K2, K1,
  the sum) timed one after another.

Times are CUDA events, the mean of 5 launches after a warm-up.  A mismatch
raises.  Exits 1 without a card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

SEED = 20261016
SOURCES = ("ec_win.cu", "fa_tape.cu", "jac_sum.cu")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps: int = 5) -> float:
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


def product_latency(device, rng) -> dict:
    """Nanoseconds a dependent `fe_mul` for Fq and Fr (`ops/ntt.py::mul_chain`)."""
    import torch

    from ..ops import field_ops as fo
    from ..ops.ntt import mul_chain

    sms = torch.cuda.get_device_properties(device).multi_processor_count
    iters = 10_000
    out = {"probe": "latency", "blocks_of_one_warp": sms, "dependent_products": iters}
    for spec in (fo.FQ, fo.FR):
        a, b = (random_elements(rng, sms * 32, device) for _ in range(2))
        ms = cuda_ms(lambda: mul_chain(a, b, iters, spec))
        out[spec.name + "_ns"] = ms * 1e6 / iters
    return out


def random_elements(rng, n: int, device, top: int = 0x1FFF_FFFF):
    """(n, 8) int32 values with the top limb masked by `top` (the default
    keeps them below both moduli)."""
    import numpy as np
    import torch

    a = rng.integers(0, 1 << 32, size=(n, 8), dtype=np.uint32)
    a[:, 7] &= top
    return torch.from_numpy(a.view(np.int32)).to(device)


def probe_scalar_mul(co, ek, native, rng, device) -> None:
    import torch

    from ..fields import R
    from ..oracle import curve as oc

    base = native.g1_batch_mul(
        oc.g1_generator(), [int.from_bytes(rng.bytes(32), "little") % R for _ in range(4608)])
    P0 = co.affine_to_jac(co.affine_from_ints(base, device))
    for n in (4608, 1 << 14, 1 << 17):
        idx = torch.arange(n, device=device) % 4608
        P = co.JacPoint(*(c[idx].contiguous() for c in P0))
        s = random_elements(rng, n, device, top=0xFFFF_FFFF)  # any scalar below 2^256
        ref = ek.scalar_mul_win(P, s)
        rec = {"probe": "k1", "lanes": n, "launcher_block": ek.win_block(n), "ms_by_block": {}}
        for threads in (0, 32, 64, 128, 256, 384):
            out = ek.scalar_mul_win(P, s, threads)
            if not bool(co.jac_eq(out, ref).all()):
                raise AssertionError(f"K1 at {n} lanes, block {threads} != the launcher's choice")
            rec["ms_by_block"][str(threads)] = cuda_ms(lambda: ek.scalar_mul_win(P, s, threads))
        if not bool(co.jac_eq(ek.scalar_mul_ladder(P, s, 256), ref).all()):
            raise AssertionError(f"K8 != K1 at {n} lanes")
        rec["k8_ms"] = cuda_ms(lambda: ek.scalar_mul_ladder(P, s, 256), reps=3)
        emit(rec)


def simple_example_vk():
    from ..models import simple_example as se
    from ..plonk import kzg
    from ..plonk.keygen import keygen

    params = kzg.setup(9)
    cs_e, _, asg_e = se.build(se.MyCircuit(constant=7, a=2, b=3).without_witnesses(), k=9)
    return keygen(params, cs_e, asg_e)[0]


def probe_field_algebra(vk, device) -> None:
    import torch

    from ..plonk import fa_fused as ff
    from ..plonk.verifier_device import synthetic_batch

    tape = ff.fa_tape(vk, e_scalar=True)
    for lanes in (8, 32, 128, 1024, 8192):
        b = synthetic_batch(vk, min(lanes, 128), device, seed=lanes)
        cols = torch.stack(ff.fa_gather(vk, b) + [b.y, b.x])
        inputs = cols.repeat(1, lanes // cols.shape[1], 1).contiguous()
        out = ff.fa_tape_eval(tape, inputs)
        if not torch.equal(out[:, :8], ff.fa_tape_eval_plain(tape, inputs[:, :8].contiguous())):
            raise AssertionError(f"K2 != plain at {lanes} lanes")
        emit({"probe": "k2", "lanes": lanes, "ms": cuda_ms(lambda: ff.fa_tape_eval(tape, inputs)),
              "shared_bytes_a_block": ff.shared_bytes(tape)})


def probe_device_step(vk, co, ek, rng, batch: int, device) -> None:
    """The pieces of `verifier_device.fast_device` on a synthetic batch,
    each timed alone on resident inputs."""
    import torch

    from ..plonk import fa_fused as ff
    from ..plonk.verifier_device import synthetic_batch

    b = synthetic_batch(vk, batch, device, seed=1)
    ms = (4, 4, 27)
    M = sum(ms)
    lanes = [b.h_comms[i % len(b.h_comms)] for i in range(M)]
    lane_pts = co.JacPoint(*(torch.stack([p[c] for p in lanes], 1) for c in range(3)))
    lane_scalars = random_elements(rng, batch * M, device).reshape(batch, M, 8)
    tape = ff.fa_tape(vk, e_scalar=True)
    cols = ff.fa_gather(vk, b) + [b.y, b.x]
    inputs = torch.stack(cols)
    outs = ff.fa_tape_eval(tape, inputs)

    def cats():
        pts = co.JacPoint(*(torch.cat((c, c[:, :1]), 1) for c in lane_pts))
        return pts, torch.cat((lane_scalars, outs[3][:, None, :]), 1)

    pts, scalars = cats()
    per_all = ek.scalar_mul_win(pts, scalars)
    offsets = [0, 4, 8, 35, 36]
    sums = ek.jac_segment_sum(per_all, offsets, lane_axis=1)
    want = co.jac_segment_sum(per_all, offsets, lane_axis=1)
    if not bool(co.jac_eq(sums, want).all()):
        raise AssertionError("segmented sum != plain")
    emit({
        "probe": "device_step", "batch": batch, "lanes_a_proof": M + 1,
        "ms": {
            "stack_k2_inputs": cuda_ms(lambda: torch.stack(cols)),
            "k2": cuda_ms(lambda: ff.fa_tape_eval(tape, inputs)),
            "cats": cuda_ms(cats),
            "k1": cuda_ms(lambda: ek.scalar_mul_win(pts, scalars)),
            "k8": cuda_ms(lambda: ek.scalar_mul_ladder(pts, scalars, 254)),
            "jac_segment_sum": cuda_ms(lambda: ek.jac_segment_sum(per_all, offsets, lane_axis=1), reps=20),
        },
    })


def main() -> int:
    import numpy as np
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=128)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("verifier_probe: torch.cuda.is_available() is False; this run needs a CUDA card", file=sys.stderr)
        return 1

    from ..ops import build
    from ..ops import curve_ops as co
    from ..ops import ec_kernels as ek
    from ..utils import native

    if not native.available():
        raise RuntimeError("the native host engine is needed to make the probe's points")
    device = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    emit({"card": smi, "torch": torch.__version__, "cuda": torch.version.cuda})
    t0 = time.perf_counter()
    lib_path = build.build_library()
    build.load_library()
    emit({"build_s": time.perf_counter() - t0})
    show = False
    for line in (lib_path.parent / "ptxas.log").read_text().splitlines():
        if line.startswith("#"):
            show = any(src in line for src in SOURCES)
        elif show and ("registers" in line or "spill" in line or "Compiling entry" in line):
            print("ptxas: " + line.strip(), flush=True)

    rng = np.random.default_rng(SEED)
    emit(product_latency(device, rng))
    probe_scalar_mul(co, ek, native, rng, device)
    vk = simple_example_vk()
    probe_field_algebra(vk, device)
    probe_device_step(vk, co, ek, rng, args.batch, device)
    emit({"ok": True})
    return 0


if __name__ == "__main__":
    sys.exit(main())
