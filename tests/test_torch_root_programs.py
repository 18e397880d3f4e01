"""The port's counterparts of the JAX package's root programs against them:
`tools/row_costs.py` (the rows of each gadget primitive),
`__graft_entry__.py::entry` (the batched verifier field algebra over a
B = 4 synthetic batch) and `tools/rows_vs_n.py` (its least-squares fit, and
its N = 1 inner proof and rows against the JAX package's).  `tools/level2_probe.py`'s
test is in `test_torch_tree.py`.  Exact equality throughout."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from halo2_aggregation_tpu_torch.ops.limbs import jax_to_port
from halo2_aggregation_tpu_torch.tools import graft_entry, row_costs, rows_vs_n

torch.set_num_threads(1)  # small tensors; the test workers share the cores

ROOT = Path(__file__).resolve().parents[1]


def load_root_program(name: str):
    """A root program of the JAX package as a module (their directories
    are not packages)."""
    path = ROOT / (f"tools/{name}.py" if name != "__graft_entry__" else "__graft_entry__.py")
    spec = importlib.util.spec_from_file_location(f"root_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_row_costs_equal_the_jax_tool(capsys):
    """Every primitive's rows, in the JAX tool's order, and its printed
    lines."""
    load_root_program("row_costs").main()
    want = capsys.readouterr().out.strip().splitlines()
    got = row_costs.costs()
    assert [f"{label:28s} {n:7d} rows" for label, n in got] == want
    assert len(got) == 12 and dict(got)["mul_var(254)"] > 60000
    assert row_costs.main([]) == 0
    assert capsys.readouterr().out.strip().splitlines()[:-1] == want


def test_graft_entry_equals_the_jax_entry():
    """`entry(device="cpu")`'s h_eval (K2's plain version over the port's
    `synthetic_batch`) equals the JAX `__graft_entry__.entry()`'s, called as
    its `fn(*args)`, on the same seeded batch."""
    fn, args = graft_entry.entry(device="cpu")
    got = fn(*args)
    fn_r, args_r = load_root_program("__graft_entry__").entry()
    want = torch.from_numpy(jax_to_port(np.asarray(fn_r(*args_r))))
    assert got.shape == (graft_entry.B, 8) and got.device.type == "cpu"
    assert torch.equal(got, want.to(got.dtype))
    assert len(set(map(tuple, got.tolist()))) == graft_entry.B


def test_rows_vs_n_fit():
    """The fit is numpy's least-squares line (the JAX tool's
    `np.polyfit`), here over the JAX tool's rows at N = 1, 2, 4
    (`docs/rows_vs_n_run.log`, whose slope line came from the earlier
    two-point fit through N = 2 and 4); a line through exact points has no
    residual; the k of each estimate holds it with 2 % headroom."""
    rows = {1: 1232985, 2: 2593555, 4: 5194367}
    f = rows_vs_n.fit(rows)
    ns = np.array(sorted(rows), float)
    ys = np.array([rows[n] for n in sorted(rows)], float)
    slope = ((ns - ns.mean()) * (ys - ys.mean())).sum() / ((ns - ns.mean()) ** 2).sum()
    assert f["slope"] == pytest.approx(slope, rel=1e-12)
    assert f["intercept"] == pytest.approx(ys.mean() - slope * ns.mean(), rel=1e-9)
    assert round(f["slope"]) == 1317596 and f["max_residual"] > 0
    for n, (est, k) in f["estimate"].items():
        assert est == pytest.approx(f["intercept"] + f["slope"] * n) and 2 ** (k - 1) < est * 1.02 <= 2**k
    line = rows_vs_n.fit({1: 100, 2: 300, 5: 900})
    assert line["slope"] == pytest.approx(200) and line["max_residual"] == pytest.approx(0, abs=1e-6)


def test_rows_vs_n_one_proof():
    """N = 1 against the JAX package on the JAX tool's inputs: the inner
    proof of its first witness (2, 3), seed 300, Blake2b (made by the host
    prover for `--device cpu`) byte for byte equal to the JAX
    `create_proof`'s, and the N = 1 `AggregationCircuit`'s rows equal to the
    JAX `ac.build`'s over that proof, fitting k = 21 (synthesised at k = 21,
    which the rows do not depend on; the JAX side first, freed before the
    port's).  `docs/rows_vs_n_run.log:1` has 1,232,985 rows."""
    import gc

    from halo2_aggregation_tpu.models import aggregation_circuit as ac_r
    from halo2_aggregation_tpu.models import simple_example as se_r
    from halo2_aggregation_tpu.plonk import kzg as kzg_r
    from halo2_aggregation_tpu.plonk.keygen import keygen as keygen_r
    from halo2_aggregation_tpu.plonk.prover import create_proof as create_proof_r
    from halo2_aggregation_tpu.plonk.verifier import verify_proof as verify_proof_r

    params = kzg_r.setup(rows_vs_n.K_INNER)
    cs_e, _, asg_e = se_r.build(se_r.MyCircuit(constant=7, a=2, b=3).without_witnesses(), k=rows_vs_n.K_INNER)
    vk_r, pk_r = keygen_r(params, cs_e, asg_e)
    circuit = se_r.MyCircuit(constant=7, a=2, b=3)
    _, _, asg = se_r.build(circuit, k=rows_vs_n.K_INNER)
    pub = [circuit.public_output()]
    proof_r = create_proof_r(params, pk_r, asg, [pub], seed=rows_vs_n.SEED0)
    ok, efw_r = verify_proof_r(params, vk_r, [pub], proof_r)
    assert ok
    circ_r = ac_r.AggregationCircuit(vk_r, [proof_r], num_proofs=1)
    pis_r = circ_r.public_inputs([params.commit_lagrange(pub)], [efw_r])
    rows_r = ac_r.build(circ_r, 21, pis_r)[3].offset
    del circ_r, pis_r
    gc.collect()

    inner = rows_vs_n.inner_proofs(1, "cpu")
    assert inner["proofs"] == [proof_r] and len(proof_r) == 1248
    assert inner["vk"].hash_scalar() == vk_r.hash_scalar()
    assert [tuple(map(tuple, q)) for q in inner["efws"]] == [tuple(map(tuple, efw_r))]
    assert rows_vs_n.rows_at(1, inner, k=21) == (rows_r, 21)
