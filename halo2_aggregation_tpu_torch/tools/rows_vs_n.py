"""The outer circuit's rows against N, and the least-squares rows a proof.

    python3 -m halo2_aggregation_tpu_torch.tools.rows_vs_n [--n 1 2 4] [--device cpu]

The counterpart of the JAX package's `tools/rows_vs_n.py`, with its inputs:
the simple example's inner proofs at k = 9 over `outer_prove.WITNESSES`
(proof i of seed 300 + i, the Blake2b transcript), made on the card by
`keygen_device` and `create_proof_device` unless `--device cpu` (then by
the host `keygen` and `create_proof`: the same bytes), each accepted by the
host `verify_proof`.  For each N of `--n` (default 1, 2 and 4), the
`AggregationCircuit` over the first N (its default `constrained_fs`,
False) synthesised at a headroom k of 24, every in-circuit quad equal to
the host's and, for N > 1, the fold to `fold_quads_host`; prints the rows
and the smallest k that fits, the least-squares slope and intercept over
the points, and the rows it predicts at N = 8, 16 and 64, as the JAX tool
does, then one JSON line with the same numbers.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

K_INNER = 9
K_HEADROOM = 24
SEED0 = 300


def inner_proofs(count: int, device="cuda") -> dict:
    """`count` inner proofs of the simple example at k = 9 over
    `WITNESSES`, proof i with seed 300 + i and the Blake2b transcript, on
    `device` ("cpu": the host `keygen` and `create_proof`).  Returns the
    vk, proofs, instance commitments and host quads."""
    from ..device import resolve_device
    from ..models import simple_example as se
    from ..plonk import kzg
    from ..plonk.verifier import verify_proof
    from .outer_prove import WITNESSES

    device = resolve_device(device)
    params = kzg.setup(K_INNER)
    base = se.MyCircuit(constant=7, a=2, b=3)
    cs_e, _, asg_e = se.build(base.without_witnesses(), k=K_INNER)
    if device.type == "cuda":
        from ..plonk.keygen_device import keygen_device
        from ..plonk.kzg import DeviceSRS
        from ..plonk.prover_device import create_proof_device

        srs = DeviceSRS(params, device)
        vk, pk = keygen_device(params, cs_e, asg_e, device=device, srs=srs)

        def prove(asg, pub, seed):
            return create_proof_device(params, pk, asg, [pub], seed=seed, device=device, srs=srs)
    else:
        from ..plonk.keygen import keygen
        from ..plonk.prover import create_proof

        vk, pk = keygen(params, cs_e, asg_e)

        def prove(asg, pub, seed):
            return create_proof(params, pk, asg, [pub], seed=seed)

    proofs, comms, efws = [], [], []
    for i, (a, b) in enumerate(WITNESSES[:count]):
        c = se.MyCircuit(constant=7, a=a, b=b)
        _, _, asg = se.build(c, k=K_INNER)
        pub = [c.public_output()]
        proofs.append(prove(asg, pub, SEED0 + i))
        ok, efw = verify_proof(params, vk, [pub], proofs[-1])
        if not ok:
            raise AssertionError(f"inner proof {i} rejected by the host verify_proof")
        comms.append(params.commit_lagrange(pub))
        efws.append(tuple(efw))
    return {"vk": vk, "proofs": proofs, "inst_comms": comms, "efws": efws}


def rows_at(n: int, inner: dict, k: int = K_HEADROOM) -> tuple:
    """The N = n `AggregationCircuit` synthesised at `k`; raises unless its
    quads (and fold) equal the host's.  Returns (rows, the smallest k in
    [18, 26] that fits)."""
    from ..models import aggregation_circuit as ac

    circ = ac.AggregationCircuit(inner["vk"], inner["proofs"][:n], num_proofs=n)
    pis = circ.public_inputs(inner["inst_comms"][:n], inner["efws"][:n])
    cs, _, _, ctx, out = ac.build(circ, k, pis)
    quads = [out] if n == 1 else out[0]
    for q, want in zip(quads, inner["efws"][:n]):
        if (q.e.value(), q.f.value(), q.w.value(), q.zw.value()) != tuple(want):
            raise AssertionError(f"N={n}: in-circuit quad != the host's")
    if n > 1 and (out[1].value(), out[2].value()) != ac.fold_quads_host(inner["efws"][:n]):
        raise AssertionError(f"N={n}: in-circuit fold != fold_quads_host")
    return ctx.offset, next((kk for kk in range(18, 27) if ctx.offset <= cs.usable_rows(1 << kk)), None)


def fit(rows: dict) -> dict:
    """Least-squares line through {N: rows} (two points or more): slope,
    intercept, the largest residual, and at N = 8, 16 and 64 the predicted
    rows and the k they need with 2 % headroom."""
    import numpy as np

    ns = sorted(rows)
    m, c0 = np.polyfit(ns, [rows[n] for n in ns], 1)
    resid = max(abs(rows[n] - (m * n + c0)) for n in ns)
    est = {n: c0 + m * n for n in (8, 16, 64)}
    return {"slope": float(m), "intercept": float(c0), "max_residual": float(resid),
            "estimate": {n: [float(e), math.ceil(math.log2(e * 1.02))] for n, e in est.items()}}


def main(argv=None) -> int:
    from ..ops import build

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, nargs="+", default=[1, 2, 4], help="the numbers of inner proofs (1 .. 8)")
    ap.add_argument("--device", default="cuda", help="where the inner proofs are made (cuda or cpu)")
    args = ap.parse_args(argv)
    # the SRS cache stays inside the checkout (build/ is not committed)
    os.environ.setdefault("H2A_PARAMS_CACHE", str(build.BUILD_ROOT.parent / "h2a-params"))
    t_all = time.time()
    inner = inner_proofs(max(args.n), args.device)
    rows = {}
    for n in args.n:
        t0 = time.time()
        rows[n], k_fit = rows_at(n, inner)
        print(f"N={n}: rows={rows[n]}  fits k={k_fit}  ({time.time() - t0:.0f}s)", flush=True)
    line = {"phase": "rows_vs_n", "rows": rows}
    if len(rows) > 1:
        f = fit(rows)
        print(f"least-squares rows/proof slope ~= {f['slope']:.0f}, intercept ~= {f['intercept']:.0f} "
              f"(max residual {f['max_residual']:.0f} rows over N={sorted(rows)})")
        for n, (est, k) in f["estimate"].items():
            print(f"N={n}: est rows={est:.0f} -> k>={k}")
        line.update(f)
    print(json.dumps({**line, "wall_s": time.time() - t_all}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
