"""The batched verifier field algebra over a synthetic batch: the port's
counterpart of `__graft_entry__.py::entry`.

    python3 -m halo2_aggregation_tpu_torch.tools.graft_entry [--device cpu]

`entry(device)` returns (fn, args): `fn` runs the fused field algebra
(`plonk/fa_fused.py::field_algebra_fused`, K2 on a CUDA tensor, its plain
version on a CPU one) over `args`, `synthetic_batch(vk, 4, device)` for the
simple example's vk at `H2AConfig.from_env().k_inner`, and returns h_eval
as (4, 8) canonical Montgomery Fr.  No jit and no compile cache: those
were the TPU's.  The multi-chip dry run's counterpart is
`tools/dryrun_multichip.py`.  The command calls `fn` once and prints one
JSON line: h_eval's shape and values, K2's launches and the seconds.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

B = 4


def build_vk():
    """The simple example's vk at `k_inner`, from the host keygen."""
    from ..config import H2AConfig
    from ..models import simple_example as se
    from ..plonk import kzg
    from ..plonk.keygen import keygen

    k = H2AConfig.from_env().k_inner
    params = kzg.setup(k)
    circuit = se.MyCircuit(constant=7, a=2, b=3)
    cs, _, asg = se.build(circuit.without_witnesses(), k=k)
    vk, _ = keygen(params, cs, asg)
    return vk


def entry(device="cuda"):
    """(fn, args): the batched verifier field algebra over a B = 4 synthetic
    batch on `device`; `fn(*args)` is h_eval."""
    from ..device import resolve_device
    from ..plonk.fa_fused import field_algebra_fused
    from ..plonk.verifier_device import synthetic_batch

    device = resolve_device(device)
    vk = build_vk()
    batch = synthetic_batch(vk, B, device)

    def fn(b):
        h_eval, _xn, _xn_sub_one = field_algebra_fused(vk, b, B)
        return h_eval

    return fn, (batch,)


def main(argv=None) -> int:
    import torch

    from ..ops.field_ops import FR
    from ..plonk.fa_fused import fa_tape_eval

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    fn, fn_args = entry(args.device)
    launches = fa_tape_eval.launches
    h_eval = fn(*fn_args)
    if h_eval.device.type == "cuda":
        torch.cuda.synchronize(h_eval.device)
    print(json.dumps({
        "phase": "graft_entry", "device": str(h_eval.device), "shape": list(h_eval.shape),
        "h_eval": [str(v) for v in FR.from_mont_tensor(h_eval)], "fa_tape_launches": fa_tape_eval.launches - launches,
        "seconds": time.perf_counter() - t0,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
