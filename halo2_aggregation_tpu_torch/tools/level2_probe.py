"""A recursion node synthesised without a prove: its rows and the smallest k
that fits.

    python3 -m halo2_aggregation_tpu_torch.tools.level2_probe [--children A B] [--k 24] [--full-mock] [--device cpu]

The counterpart of the JAX package's `tools/level2_probe.py`.  Over two
child stems (`--children`; by default the checked-in
`docs/artifacts/outer_n2_k22` and `outer_n2_k22b`; level-2 stems such as
`docs/artifacts/level2_n2_k23` give the level-3 node): both children
re-verified by the host `verify_proof` with quads equal to their metas
(their SRS, `kzg.setup(k)`, made on the card unless `--device cpu`, then by
the host engine), the
node's `AggregationCircuit` over them synthesised at a headroom k (24, as
the JAX tool), every in-circuit quad equal to the child's and the
in-circuit fold to `fold_quads_host`; then the rows, the smallest k that
fits, and the rows of the 64-leaf tree (32 N = 2 leaves and 31 such nodes).
`--full-mock` runs `plonk/mock.py::mock_verify_fast` over the assignment
(the JAX tool's `H2A_FULL_MOCK=1`).  Prints the JAX tool's lines, then one
JSON line with the same numbers.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from .outer_prove import CHECKED_IN

#: the rows of an N = 2 outer circuit, the 64-leaf tree's leaves
#: (docs/PHASE_D_n2b_k22_dq_run.log:4)
ROWS_N2 = 2673963
K_HEADROOM = 24


def probe(children, k: int = K_HEADROOM, device="cuda", full_mock: bool = False, echo=print) -> dict:
    """The node over `children` synthesised at `k`; raises unless both
    children verify on the host with their metas' quads, and the in-circuit
    quads and fold equal the host's.  Returns the rows, the smallest k in
    [18, 26] that fits (None if none does), the 64-leaf tree's rows and the
    in-circuit quads and fold."""
    from ..aggregation.tree import load_artifact
    from ..device import resolve_device
    from ..models import aggregation_circuit as ac
    from ..plonk import kzg
    from ..plonk.verifier import verify_proof

    device = resolve_device(device)
    arts = [load_artifact(stem) for stem in children]
    vk_c = arts[0][1]
    if arts[1][1].hash_scalar() != vk_c.hash_scalar():
        raise ValueError("the children were made under different vks")
    for stem, (proof, _, meta, _, _, _) in zip(children, arts):
        echo(f"child artifact: {stem} (k={meta['k']}, N={meta['num_proofs']}, level={meta.get('level', 1)}, "
             f"{len(proof)} bytes)")
    echo(f"children distinct: {arts[0][0] != arts[1][0]}")
    # the SRS's fixed-base products on the card, else the host engine's
    params_c = kzg.setup(arts[0][2]["k"], device=device if device.type == "cuda" else None)
    t0 = time.time()
    for stem, (proof, _, _, pis, efw, _) in zip(children, arts):
        ok, efw_host = verify_proof(params_c, vk_c, [pis], proof)
        if not ok:
            raise AssertionError(f"{stem} does not verify on the host")
        if tuple(map(tuple, efw_host)) != efw:
            raise AssertionError(f"{stem}: the host quad != the meta's")
    del params_c
    echo(f"host re-verify ok ({time.time() - t0:.1f}s)")

    circ = ac.AggregationCircuit(vk_c, [a[0] for a in arts], num_proofs=2)
    pis = circ.public_inputs([a[5] for a in arts], [a[4] for a in arts])
    t0 = time.time()
    cs, _, asg, ctx, (quads, W, RHS) = ac.build(circ, k, pis)
    got = [(q.e.value(), q.f.value(), q.w.value(), q.zw.value()) for q in quads]
    if got != [a[4] for a in arts]:
        raise AssertionError("an in-circuit quad != its child's")
    fold = (W.value(), RHS.value())
    if fold != ac.fold_quads_host([a[4] for a in arts]):
        raise AssertionError("the in-circuit fold != fold_quads_host")
    rows = ctx.offset
    k_fit = next((kk for kk in range(18, 27) if rows <= cs.usable_rows(1 << kk)), None)
    seconds = time.time() - t0
    fit = f"fits k={k_fit}" if k_fit else "does NOT fit any k<=26"
    echo(f"node circuit: {rows} rows for 2 children @ {fit} ({seconds:.0f}s); quads + fold match")
    tree_rows = 31 * rows + 32 * ROWS_N2
    echo(f"rows per verified child: {rows / 2:.0f} -> a 64-leaf tree (32 x N=2 level-1 + 16+8+4+2+1 nodes) is "
         f"{tree_rows:.3g} total rows across 63 proofs")
    out = {"children": list(children), "k": k, "rows": rows, "k_fit": k_fit, "synthesis_s": seconds,
           "tree64_rows": tree_rows, "quads": got, "fold": fold, "public_inputs": len(pis)}
    if full_mock:
        from ..plonk.mock import mock_verify_fast

        t0 = time.time()
        failures = mock_verify_fast(cs, asg)
        if failures:
            raise AssertionError(failures[:5])
        out["mock_s"] = time.time() - t0
        echo(f"node mock prover succeeded ({out['mock_s']:.0f}s)")
    return out


def main(argv=None) -> int:
    from ..ops import build

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--children", nargs=2, metavar=("A", "B"),
                    default=[os.path.join(CHECKED_IN, "outer_n2_k22"), os.path.join(CHECKED_IN, "outer_n2_k22b")])
    ap.add_argument("--k", type=int, default=K_HEADROOM, help="the synthesis' k (headroom; the fit is reported)")
    ap.add_argument("--full-mock", action="store_true", help="also run mock_verify_fast over the assignment")
    ap.add_argument("--device", default="cuda", help="where the children's SRS is made (cuda or cpu)")
    args = ap.parse_args(argv)
    # the SRS cache stays inside the checkout (build/ is not committed)
    os.environ.setdefault("H2A_PARAMS_CACHE", str(build.BUILD_ROOT.parent / "h2a-params"))
    t0 = time.time()
    out = probe(args.children, args.k, args.device, args.full_mock, echo=lambda m: print(m, flush=True))
    print("done.")
    print(json.dumps({"phase": "level2_probe", **{k: v for k, v in out.items() if k not in ("quads", "fold")},
                      "wall_s": time.time() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
