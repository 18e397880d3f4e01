"""The in-circuit rows of each EccChip and IntegerChip primitive.

    python3 -m halo2_aggregation_tpu_torch.tools.row_costs

The counterpart of the JAX package's `tools/row_costs.py`, on the port's
copies of the gadgets: the outer circuit's configuration over a 2^18-row
assignment with its range table loaded, then each primitive on the same
inputs as the JAX tool, and the rows each one adds.  Prints the JAX tool's
lines, then one JSON line with the same numbers.  Synthesis only: host
Python, no card.
"""

from __future__ import annotations

import json
import sys


def costs() -> list:
    """[(label, rows), ...] in the JAX tool's order."""
    from ..aggregation.gadgets.main_gate import Ctx
    from ..models import aggregation_circuit as ac
    from ..oracle import curve as oc
    from ..plonk.circuit import Assignment, ConstraintSystem

    cs = ConstraintSystem()
    cfg = ac.configure(cs)
    asg = Assignment(cs, 1 << 18)
    cfg.rc.load_table(asg)
    ctx = Ctx(asg)
    ecc, mg, ic = cfg.ecc, cfg.mg, cfg.ic
    out = []

    def cost(label, fn):
        before = ctx.offset
        value = fn()
        out.append((label, ctx.offset - before))
        return value

    g = oc.g1_generator()
    p = oc.g1_mul(g, 12345)
    q = oc.g1_mul(g, 67890)
    pa = cost("assign_point", lambda: ecc.assign_point(ctx, p))
    qa = cost("assign_point(2)", lambda: ecc.assign_point(ctx, q))
    cost("add_incomplete", lambda: ecc.add_incomplete(ctx, pa, qa))
    cost("double", lambda: ecc.double(ctx, pa))
    bit = mg.assign_bit(ctx, 1)
    cost("select(point)", lambda: ecc.select(ctx, bit, pa, qa))
    sc = mg.assign_value(ctx, 0x1234567890ABCDEF)
    cost("scalar_bits(254)", lambda: ecc.scalar_bits(ctx, sc, 254))
    cost("assign_integer", lambda: ic.assign_integer(ctx, 424242))
    a = ic.assign_integer(ctx, 10**30)
    b = ic.assign_integer(ctx, 10**29)
    cost("ic.mul", lambda: ic.mul(ctx, a, b))
    cost("ic.assert_mul_equals", lambda: ic.assert_mul_equals(ctx, a, b, ic.mul(ctx, a, b)))
    cost("ic.add", lambda: ic.add(ctx, a, b))
    cost("ic.sub", lambda: ic.sub(ctx, a, b))
    sc2 = mg.assign_value(ctx, 0xDEADBEEF)
    cost("mul_var(254)", lambda: ecc.mul_var(ctx, pa, sc2, 254))
    return out


def main(argv=None) -> int:
    rows = costs()
    for label, n in rows:
        print(f"{label:28s} {n:7d} rows")
    print(json.dumps({"phase": "row_costs", "rows": dict(rows)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
