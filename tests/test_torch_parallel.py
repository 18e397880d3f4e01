"""`parallel/` on torch.distributed: ranks over gloo on the CPU, held to the
JAX package on the same proofs.

One spawned group a world runs every formulation once a mesh (module-scoped,
through `tools/dryrun_multichip.py::rank_run`, the dry run's own rank
step): world 4 over a 2 x 2 mesh (`make_mesh(4)`), then 4 x 1 and 1 x 4
(`fast_prep(lane_pad=4)`), at B = 4 over two k = 9 proofs, each with
`sharded_msm`; world 2 over a 2 x 1 mesh (`make_mesh(2)`, the JAX tests'
tiny-mesh edge) at B = 2.  The tests below read its records: every rank's
quads against the JAX package's host `verify_proof` and the port's
single-process `verify_algebra_fast`, h_eval against the JAX
`field_algebra`, the sharded MSM against the oracle (as
`tests/test_parallel.py`).  One more group runs the scale-out's rank step
(`scale_run`) at world 2."""

import os

import numpy as np
import pytest
import torch
from torch.multiprocessing import ProcessRaisedException

from halo2_aggregation_tpu.models import simple_example as se
from halo2_aggregation_tpu.oracle import curve as oc
from halo2_aggregation_tpu.parallel.mesh import make_mesh as jax_make_mesh
from halo2_aggregation_tpu.plonk import kzg
from halo2_aggregation_tpu.plonk import verifier_tpu as vt
from halo2_aggregation_tpu.plonk.keygen import keygen
from halo2_aggregation_tpu.plonk.prover import create_proof
from halo2_aggregation_tpu.plonk.verifier import parse_proof, verify_proof
from halo2_aggregation_tpu_torch.convert import keys_from_reference
from halo2_aggregation_tpu_torch.ops import curve_ops as co
from halo2_aggregation_tpu_torch.ops.limbs import ints_to_tensor, jax_to_port
from halo2_aggregation_tpu_torch.ops.msm import msm
from halo2_aggregation_tpu_torch.parallel.mesh import make_mesh, mesh_split, run_ranks
from halo2_aggregation_tpu_torch.plonk import kzg as port_kzg
from halo2_aggregation_tpu_torch.plonk import verifier_device as vd
from halo2_aggregation_tpu_torch.plonk.verifier import parse_proof as port_parse_proof
from halo2_aggregation_tpu_torch.tools import dryrun_multichip as dm

torch.set_num_threads(1)  # tiny tensors; the test workers share the cores

K = 9
B = 4
MSM_N = 8  # points of the sharded MSM: 4 a rank of mp = 2, 2 of dp or mp = 4
SHAPES_4 = [None, (4, 1), (1, 4)]  # the world-4 group's meshes: make_mesh's 2 x 2, then by shape


@pytest.fixture(scope="module")
def setup():
    """Two k = 9 proofs from the JAX package, cycled to B; the port's vk and
    parsed proofs of the same bytes; the host quads."""
    params = kzg.setup(K)
    circuit = se.MyCircuit(constant=7, a=2, b=3)
    cs_e, _, asg_e = se.build(circuit.without_witnesses(), k=K)
    vk, pk = keygen(params, cs_e, asg_e)
    protos = []
    for a, b in [(2, 3), (4, 5)]:
        c = se.MyCircuit(constant=7, a=a, b=b)
        _, _, asg = se.build(c, k=K)
        pub = [c.public_output()]
        protos.append(([pub], create_proof(params, pk, asg, [pub], seed=60 + a)))
    parsed = [parse_proof(vk, [params.commit_lagrange(col) for col in insts], proof) for insts, proof in protos]
    pvk = keys_from_reference(vk)
    pparsed = [port_parse_proof(pvk, list(p.inst_comms), proof) for p, (_, proof) in zip(parsed, protos)]
    efws = [tuple(verify_proof(params, vk, insts, proof)[1]) for insts, proof in protos]
    cycle = lambda xs, n: [xs[i % len(xs)] for i in range(n)]  # noqa: E731
    return vk, cycle(parsed, B), pvk, cycle(pparsed, B), cycle(efws, B)


def _msm_case():
    """8 points and scalars below 2^31, each with junk above bit 32 that
    `nbits=32` must drop."""
    rng = np.random.default_rng(3)
    g = oc.g1_generator()
    pts = [oc.g1_mul(g, i + 2) for i in range(MSM_N)]
    ss = [int(rng.integers(1, 1 << 31)) for _ in range(MSM_N)]
    junk = [s + (int(rng.integers(1, 1 << 30)) << 40) for s in ss]
    return pts, ss, (co.affine_from_ints(pts, "cpu"), ints_to_tensor(junk, "cpu"), 32)


@pytest.fixture(scope="module")
def group_2x2(setup):
    _, _, pvk, pparsed, _ = setup
    return run_ranks(dm.rank_run, 4, device="cpu", args=(pvk, pparsed, SHAPES_4, "cpu", _msm_case()[2]))


@pytest.fixture(scope="module")
def group_2x1(setup):
    _, _, pvk, pparsed, _ = setup
    return run_ranks(dm.rank_run, 2, device="cpu", args=(pvk, pparsed[:2], [None], "cpu", None))


@pytest.fixture(scope="module")
def scale_2x1(setup, tmp_path_factory):
    """`scale_run` on world 2 over a 2 x 1 mesh: B = 2 and 4, one repeat,
    `sharded_msm` of 2^3 points from a disk cache of the port's SRS that
    this fixture fills first (the ranks read it, as on the card)."""
    _, _, pvk, pparsed, _ = setup
    cache = str(tmp_path_factory.mktemp("params"))
    old_env, old_dir = os.environ.get("H2A_PARAMS_CACHE"), port_kzg.CACHE_DIR
    os.environ["H2A_PARAMS_CACHE"] = port_kzg.CACHE_DIR = cache
    try:
        port_kzg.setup(3)
        ranks = run_ranks(dm.scale_run, 2, device="cpu", args=(pvk, pparsed, (2, 1), "cpu", [2, 4], 1, 3))
        points, scalars = dm.random_column("cpu", 3)
    finally:
        port_kzg.CACHE_DIR = old_dir
        if old_env is None:
            del os.environ["H2A_PARAMS_CACHE"]
        else:
            os.environ["H2A_PARAMS_CACHE"] = old_env
    return ranks, co.jac_to_ints(co.JacPoint(*(c[None] for c in msm(points, scalars))))[0]


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_mesh_split_matches_jax(n):
    """conftest gives JAX eight CPU devices."""
    assert mesh_split(n) == tuple(jax_make_mesh(n).shape.values())


def test_make_mesh_in_the_groups(group_2x2, group_2x1):
    assert [recs[0]["mesh"] for recs in group_2x2] == [[2, 2]] * 4
    assert [[rec["mesh"] for rec in recs] for recs in group_2x2] == [[[2, 2], [4, 1], [1, 4]]] * 4
    assert [recs[0]["mesh"] for recs in group_2x1] == [[2, 1]] * 2


@pytest.mark.parametrize("name", ["shmap", "sharded"])
def test_formulation_2x2_matches_host_and_single_process(setup, group_2x2, name):
    """Every rank returns the whole batch's quads: the JAX package's host
    `verify_proof` efw and the port's single-process `verify_algebra_fast`
    (K1's plain version)."""
    _, _, pvk, pparsed, efws = setup
    single = vd.quads_to_ints(vd.verify_algebra_fast(pvk, vd.batch_proofs(pvk, pparsed, "cpu"), pparsed))
    assert single == efws
    for rank, recs in enumerate(group_2x2):
        assert recs[0]["quads"][name] == efws, f"rank {rank}"
        assert recs[0]["launches"][name] == {"ec_win": 0, "fa_tape": 0, "jac_segment_sum": 0, "msm_s5": 0}


def test_sharded_field_algebra_matches_jax(setup, group_2x2):
    """h_eval of `sharded_field_algebra`, gathered over dp, equals the JAX
    `field_algebra`'s bit for bit on every rank."""
    vk, parsed, _, _, _ = setup
    want = jax_to_port(np.asarray(vt.field_algebra(vk, vt.batch_proofs(vk, parsed), B)[0]))
    for recs in group_2x2:
        assert np.array_equal(recs[0]["h_eval"].numpy(), want)


def test_sharded_msm_matches_oracle(group_2x2):
    pts, ss, _ = _msm_case()
    want = oc.g1_msm(pts, ss)
    for recs in group_2x2:
        assert recs[0]["msm_axis"] == "mp" and recs[0]["msm"] == want


@pytest.mark.parametrize("mesh", [1, 2], ids=["4x1", "1x4"])
@pytest.mark.parametrize("name", ["shmap", "sharded"])
def test_formulation_4x1_1x4_matches_host(setup, group_2x2, mesh, name):
    """World 4 with every rank on one axis: 4 x 1 splits the proofs, one a
    rank; 1 x 4 splits each component's lanes (`fast_prep(lane_pad=4)`)
    four ways.  Every rank's quads equal the JAX host `verify_proof`'s."""
    efws = setup[4]
    for rank, recs in enumerate(group_2x2):
        assert recs[mesh]["quads"][name] == efws, f"rank {rank}"


@pytest.mark.parametrize("mesh", [1, 2], ids=["4x1", "1x4"])
def test_h_eval_and_msm_4x1_1x4_match_jax_and_oracle(setup, group_2x2, mesh):
    """h_eval over dp = 4 (one proof a rank) or dp = 1 equals the JAX
    `field_algebra`'s; `sharded_msm` over the axis of four ranks (dp, then
    mp) equals the oracle's MSM."""
    vk, parsed, _, _, _ = setup
    want = jax_to_port(np.asarray(vt.field_algebra(vk, vt.batch_proofs(vk, parsed), B)[0]))
    pts, ss, _ = _msm_case()
    for recs in group_2x2:
        assert np.array_equal(recs[mesh]["h_eval"].numpy(), want)
        assert recs[mesh]["msm_axis"] == ("dp", "mp")[mesh - 1] and recs[mesh]["msm"] == oc.g1_msm(pts, ss)


def test_scale_run_matches_host(setup, scale_2x1):
    """The scale-out's rank step: the warm-up quads of both formulations at
    B = 2 and 4 equal the JAX host `verify_proof`'s on both ranks, one wall
    and one set of timings a repeat, and the sharded MSM over dp equals one
    `msm` of the same column."""
    efws = setup[4]
    ranks, msm_want = scale_2x1
    for res in ranks:
        assert res["mesh"] == [2, 1] and res["card"] is None
        assert [run["batch"] for run in res["runs"]] == [2, 4]
        for run in res["runs"]:
            for name in ("shmap", "sharded"):
                assert run["quads"][name] == efws[: run["batch"]]
                assert len(run["walls"][name]) == 1
                assert set(run["timings"][name][0]) == {"prep", "device", "collective", "mp_sum"}
        assert res["msm"]["axis"] == "dp" and res["msm"]["n"] == 8 and res["msm"]["sum"] == msm_want
        assert len(res["msm"]["walls"]) == len(res["msm"]["share_walls"]) == 1
    groups = dm.scale_groups(ranks, 2, efws, 1)
    assert [g["batch"] for g in groups] == [2, 4]
    for g in groups:
        for name in ("shmap", "sharded"):
            slowest = max(r["wall_s"][name] for r in g["ranks"])
            assert g["proofs_per_s"][name]["median"] == pytest.approx(g["batch"] / slowest)
            assert min(r["wait"][name] for r in g["ranks"]) == 0  # one repeat: the last rank waits for none


def test_tiny_mesh_formulations_agree_with_host(setup, group_2x1):
    """B = 2 over dp = 2, mp = 1: the two formulations equal each other and
    the host on both ranks."""
    efws = setup[4][:2]
    for recs in group_2x1:
        assert recs[0]["quads"]["shmap"] == recs[0]["quads"]["sharded"] == efws


@pytest.mark.parametrize("backend", [None, "nccl"])
def test_run_ranks_refuses_more_nccl_ranks_than_cards(monkeypatch, backend):
    """An NCCL world larger than the visible cards (one, here) raises
    ValueError naming both numbers before any rank starts: no card is
    shared in its place."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)

    def no_spawn(*args, **kwargs):
        raise AssertionError("a rank was spawned")

    monkeypatch.setattr(torch.multiprocessing, "spawn", no_spawn)
    with pytest.raises(ValueError, match="world 2 needs one card a rank, 1 visible"):
        run_ranks(mesh_split, 2, device="cuda:0", backend=backend, args=(2,))


def test_bad_shapes_and_devices_raise(setup):
    """B must divide by dp; a mesh needs an initialized group; a CUDA mesh
    or run needs a card; a rank that raises makes the caller raise."""
    _, _, pvk, pparsed, _ = setup
    with pytest.raises(RuntimeError, match="not initialized"):
        make_mesh(device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            make_mesh(device="cuda")
        with pytest.raises(RuntimeError, match="cuda"):
            run_ranks(mesh_split, 1, device="cuda", args=(1,))
    with pytest.raises(ValueError):
        mesh_split(0)
    with pytest.raises(ProcessRaisedException, match="expected >= 1"):
        run_ranks(mesh_split, 2, device="cpu", args=(0,))
    with pytest.raises(ProcessRaisedException, match="must divide over dp"):
        run_ranks(dm.rank_run, 2, device="cpu", args=(pvk, pparsed[:3], [None], "cpu", None))

