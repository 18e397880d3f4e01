"""The port's own host modules against the JAX package's.

The port keeps a copy of every host module it needs.  (a) Each copy's
source is held to its original with difflib: after the two rewritings
below, every differing hunk must lie in a range of `REMOVED`, which names
the JAX branch that went.  (b) On one seed at k = 9 the copies compute what
the originals compute: SRS, keys, the three provers' bytes, the verifier's
quads, the transcript, point compression, the pairing check, Poseidon, the
GLV split and the polynomial helpers.  Exact equality: these are integers
and bytes."""

import difflib
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import halo2_aggregation_tpu as ref_pkg
import halo2_aggregation_tpu_torch as port_pkg
from halo2_aggregation_tpu.fields import R
from halo2_aggregation_tpu.models import simple_example as se_r
from halo2_aggregation_tpu.oracle import curve as oc_r
from halo2_aggregation_tpu.oracle import glv as glv_r
from halo2_aggregation_tpu.oracle import pairing as pairing_r
from halo2_aggregation_tpu.oracle import poly as poly_r
from halo2_aggregation_tpu.oracle import poseidon as poseidon_r
from halo2_aggregation_tpu.plonk import kzg as kzg_r
from halo2_aggregation_tpu.plonk import mock as mock_r
from halo2_aggregation_tpu.plonk.keygen import keygen as keygen_r
from halo2_aggregation_tpu.plonk.keygen import keygen_native as keygen_native_r
from halo2_aggregation_tpu.plonk.prover import create_proof as create_proof_r
from halo2_aggregation_tpu.plonk.prover_native import create_proof_native as create_proof_native_r
from halo2_aggregation_tpu.plonk.verifier import verify_proof as verify_proof_r
from halo2_aggregation_tpu.utils import serialization as ser_r
from halo2_aggregation_tpu.utils import transcript as tr_r
from halo2_aggregation_tpu_torch import convert
from halo2_aggregation_tpu_torch.models import simple_example as se_p
from halo2_aggregation_tpu_torch.oracle import curve as oc_p
from halo2_aggregation_tpu_torch.oracle import glv as glv_p
from halo2_aggregation_tpu_torch.oracle import pairing as pairing_p
from halo2_aggregation_tpu_torch.oracle import poly as poly_p
from halo2_aggregation_tpu_torch.oracle import poseidon as poseidon_p
from halo2_aggregation_tpu_torch.plonk import kzg as kzg_p
from halo2_aggregation_tpu_torch.plonk import mock as mock_p
from halo2_aggregation_tpu_torch.plonk.keygen import keygen as keygen_p
from halo2_aggregation_tpu_torch.plonk.keygen import keygen_native as keygen_native_p
from halo2_aggregation_tpu_torch.plonk.prover import create_proof as create_proof_p
from halo2_aggregation_tpu_torch.plonk.prover_native import create_proof_native as create_proof_native_p
from halo2_aggregation_tpu_torch.plonk.verifier import verify_proof as verify_proof_p
from halo2_aggregation_tpu_torch.utils import serialization as ser_p
from halo2_aggregation_tpu_torch.utils import transcript as tr_p

torch.set_num_threads(1)  # small tensors; the test workers share the cores

REF = Path(ref_pkg.__file__).parent
PORT = Path(port_pkg.__file__).parent
K = 9
SEED = 20261016

# the copied modules, by their path in both packages
COPIES = [
    "fields.py",
    "utils/__init__.py", "utils/u64.py", "utils/serialization.py", "utils/native.py", "utils/transcript.py",
    "oracle/__init__.py", "oracle/curve.py", "oracle/pairing.py", "oracle/poly.py", "oracle/poseidon.py",
    "oracle/glv.py",
    "plonk/circuit.py", "plonk/protocol.py", "plonk/engine.py", "plonk/kzg.py", "plonk/keygen.py",
    "plonk/verifier.py", "plonk/prover.py", "plonk/mock.py", "plonk/prover_native.py",
    "aggregation/__init__.py", "aggregation/chips.py",
    "aggregation/gadgets/__init__.py", "aggregation/gadgets/main_gate.py", "aggregation/gadgets/range_chip.py",
    "aggregation/gadgets/integer.py", "aggregation/gadgets/ecc.py", "aggregation/gadgets/poseidon.py",
    "models/__init__.py", "models/simple_example.py", "models/aggregation_circuit.py",
    "config.py", "api.py", "utils/artifacts.py", "utils/jobs.py", "aggregation/tree.py",
]

# Where a copy may differ: (first, last) lines of the ORIGINAL, 1-based and
# inclusive, and what went there.  Everything outside these ranges is the
# original's text.
REMOVED = {
    "plonk/protocol.py": [
        (119, 146, "LimbOps, the jnp backend: the port's is protocol_ops.TorchLimbOps"),
        (183, 194, "_register_pytree_dataclass: registers the eval dataclasses with jax"),
        (246, 246, "its decorator on PermutationSetEvals"),
    ],
    "plonk/kzg.py": [
        (17, 18, "module docstring: names DeviceSRS"),
        (24, 27, "imports of torch and the port's ops for DeviceSRS"),
        (77, 77, "Params._device_points, the JAX resident SRS"),
        (101, 102, "commit_lagrange's docstring: no H2A_DEVICE_MSM branch"),
        (123, 156, "the JAX device branch of Params._msm: the port's is DeviceSRS"),
        (181, 183, "setup's signature and docstring: the explicit `device`"),
        (213, 214, "setup's fixed-base products at k >= 14: K1 on `device` where one is given"),
        (225, 225, "setup passes `device` to _batch_g1_mul"),
        (231, 234, "_batch_g1_mul's signature and host condition: the explicit `device`"),
        (256, 264, "the JAX device branch of setup's _batch_g1_mul: K1 on `device` (a ValueError "
                   "under H2A_DEVICE_MSM=1 without one), its helpers; DeviceSRS follows it"),
    ],
    "plonk/keygen.py": [
        (138, 170, "StaticPreload: the keygen-time upload for the TPU quotient"),
        (185, 189, "StaticPreload: the sigma columns' feed"),
        (194, 195, "StaticPreload: the handle on the pk"),
    ],
    "plonk/prover_native.py": [
        (131, 158, "_use_device_quotient: probes jax for a TPU backend"),
        (195, 223, "the TPU DeviceQuotient's creation: the port's is create_proof_device"),
        (227, 243, "adoption of the keygen-time static preload"),
        (245, 256, "register(): the feed to the TPU engine and its fallback"),
        (263, 266, "a comment on the columns' early upload"),
        (448, 450, "a comment on the columns' early upload"),
        (459, 466, "the TPU engine's finalize and its fallback"),
        (469, 480, "the TPU engine's run_coset and its fallback"),
    ],
    "plonk/circuit.py": [
        (330, 331, "create_gate's callback parameter renamed to `make`"),
        (335, 336, "lookup's callback parameter renamed to `make`"),
    ],
    "models/aggregation_circuit.py": [
        (3, 3, "docstring wording: the reference's top-level circuit"),
    ],
    "config.py": [
        (36, 36, "mul_nbits: nothing passes it on to the outer circuit"),
        (38, 63, "the knobs nothing in the port reads: limb_bits, num_limbs, range_table_bits (the gadgets' "
                 "own constants); device_limb_bits, device_nlimbs (the TPU kernels' 32 x 8-bit limbs); batch, "
                 "mesh_dp, mesh_mp (the JAX bench's batch and mesh); device_msm (the port's commitments take "
                 "an explicit `device`); pallas_ec (the TPU verifier's ladder); full_mock (the JAX slow tests')"),
        (69, 71, "phase_d: the example's switch; the port's outer prover always runs phase D"),
        (90, 90, "from_env's H2A_MUL_NBITS, with mul_nbits"),
        (97, 102, "mesh_shape: the JAX mesh's (dp, mp)"),
    ],
    "api.py": [
        (19, 19, "module docstring: the entry points' `device`"),
        (22, 24, "imports: resolve_device and keygen_device"),
        (26, 26, "create_proof_device beside the host create_proof"),
        (28, 28, "verify_batch from the port's plonk/verifier_device, not plonk/verifier_tpu"),
        (38, 39, "Setup.new's `device`: the SRS's fixed-base products on the card (None: the host)"),
        (47, 55, "keygen_vk/keygen_pk's `device` (keygen_device; None: the host keygen), and create_proof "
                 "with its `device` (create_proof_device; None: the host create_proof)"),
    ],
    "utils/jobs.py": [
        (69, 81, "aggregate_checkpointed's `device`, its docstring, the port's verifier_device imports"),
        (112, 117, "the batch step: batch_proofs on `device`, quads_to_ints in place of jac_to_ints"),
    ],
    "aggregation/tree.py": [
        (9, 11, "module docstring: phase D through the outer prover's prove_and_save on the card"),
        (52, 65, "prove_node's `device`, its docstring, the prove_and_save import in place of the native "
                 "keygen and prover, and the node's stem settled first: under build/artifacts by default, "
                 "never in the checked-in docs/artifacts"),
        (71, 71, "the children's SRS: kzg.setup with `device`"),
        (102, 146, "the node's SRS, keygen, prove, verify and artifacts: prove_and_save on `device` through one "
                   "DeviceSRS, keygen on the witness-bearing assignment in place of a second, blank synthesis"),
    ],
}


def _rewritten(text: str) -> str:
    """The original's text as a copy carries it: the package's name in
    docstrings, and the Rust reference's sources cited by relative path."""
    text = text.replace("halo2_aggregation_tpu.", "halo2_aggregation_tpu_torch.")
    return re.sub(r"/\w+/reference/", "reference/", text)


@pytest.mark.parametrize("rel", COPIES)
def test_copy_differs_only_where_a_jax_branch_went(rel):
    orig = _rewritten((REF / rel).read_text()).splitlines()
    copy = (PORT / rel).read_text().splitlines()
    allowed = REMOVED.get(rel, [])
    stray = []
    for tag, i1, i2, j1, j2 in difflib.SequenceMatcher(None, orig, copy, autojunk=False).get_opcodes():
        if tag == "equal":
            continue
        # original lines i1+1 .. i2 (an insertion sits between i1 and i1+1)
        if not any(first - 1 <= i1 and i2 <= last for first, last, _ in allowed):
            stray.append((tag, i1 + 1, i2, copy[j1:j2][:3]))
    assert stray == [], f"{rel}: hunks outside the named ranges: {stray}"


def test_every_host_module_of_the_port_is_a_listed_copy_or_a_port():
    """No host module slips in unpinned: a .py file of the port that has a
    namesake in the JAX package is either in COPIES or one of the ported
    device modules (which tests/test_torch_*.py hold to their originals by
    value)."""
    ported = {"__init__.py", "ops/__init__.py", "plonk/__init__.py", "ops/field_ops.py", "ops/curve_ops.py",
              "ops/ntt.py", "ops/msm.py", "ops/limbs.py", "plonk/fa_fused.py", "plonk/quotient_device.py"}
    namesakes = {str(f.relative_to(PORT)) for f in PORT.rglob("*.py") if (REF / f.relative_to(PORT)).exists()}
    assert namesakes - ported == set(COPIES)


# ---------------------------------------------------------------------------
# behaviour
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """(reference, port) state at k = 9: params, vk, pk from each package's
    own setup and keygen on its own circuit objects."""
    params_r = kzg_r.setup(K)
    # the port's setup computes its SRS afresh: its cache starts empty
    old = kzg_p.CACHE_DIR
    kzg_p.CACHE_DIR = str(tmp_path_factory.mktemp("params"))
    try:
        params_p = kzg_p.setup(K)
    finally:
        kzg_p.CACHE_DIR = old
    out = []
    for se, keygen, params in ((se_r, keygen_r, params_r), (se_p, keygen_p, params_p)):
        circuit = se.MyCircuit(constant=7, a=2, b=3)
        cs, _, asg = se.build(circuit.without_witnesses(), k=K)
        vk, pk = keygen(params, cs, asg)
        out.append((params, vk, pk, circuit, se))
    return out


def _assignment(state):
    _, _, _, circuit, se = state
    return se.build(circuit, k=K)[2]


def test_setup_gives_the_same_srs(both):
    (pr, *_), (pp, *_) = both
    assert np.array_equal(pr.g_lagrange_u64, pp.g_lagrange_u64)
    assert np.array_equal(pr.g_lagrange_inf, pp.g_lagrange_inf)
    assert (pr.g1, pr.g2, pr.s_g2) == (pp.g1, pp.g2, pp.s_g2)
    col = [int(v) for v in np.random.default_rng(SEED).integers(1, 1 << 62, size=1 << K)]
    assert pr.commit_lagrange(col) == pp.commit_lagrange(col)


def test_keygen_gives_the_same_vk(both):
    (_, vk_r, pk_r, *_), (_, vk_p, pk_p, *_) = both
    assert vk_r.hash_scalar() == vk_p.hash_scalar()
    assert vk_r.fixed_commitments == vk_p.fixed_commitments
    assert vk_r.sigma_commitments == vk_p.sigma_commitments
    assert pk_r.fixed_columns == pk_p.fixed_columns and pk_r.sigma_columns == pk_p.sigma_columns


def test_keygen_native_gives_the_same_keys(both):
    res = []
    for (params, _, _, circuit, se), keygen_native in zip(both, (keygen_native_r, keygen_native_p)):
        cs, _, asg = se.build(circuit.without_witnesses(), k=K)
        res.append(keygen_native(params, cs, asg))
    (vk_r, pk_r), (vk_p, pk_p) = res
    assert vk_r.hash_scalar() == vk_p.hash_scalar() == both[0][1].hash_scalar()
    for a, b in zip(pk_r.fixed_columns + pk_r.sigma_columns, pk_p.fixed_columns + pk_p.sigma_columns):
        assert np.array_equal(a, b)


@pytest.fixture(scope="module")
def proofs(both):
    """One proof from each of the four host provers, seed 7."""
    r, p = both
    pub = [r[3].public_output()]
    return pub, {
        "create_proof_r": create_proof_r(r[0], r[2], _assignment(r), [pub], seed=7),
        "create_proof_p": create_proof_p(p[0], p[2], _assignment(p), [pub], seed=7),
        "create_proof_native_r": create_proof_native_r(r[0], r[2], _assignment(r), [pub], seed=7),
        "create_proof_native_p": create_proof_native_p(p[0], p[2], _assignment(p), [pub], seed=7),
    }


def test_create_proof_gives_the_same_bytes(proofs):
    _, by = proofs
    assert by["create_proof_p"] == by["create_proof_r"]


def test_create_proof_native_host_path_gives_the_same_bytes(proofs):
    _, by = proofs
    assert by["create_proof_native_p"] == by["create_proof_native_r"] == by["create_proof_r"]


def test_verify_proof_gives_the_same_quads(both, proofs):
    r, p = both
    pub, by = proofs
    ok_r, quad_r = verify_proof_r(r[0], r[1], [pub], by["create_proof_r"])
    ok_p, quad_p = verify_proof_p(p[0], p[1], [pub], by["create_proof_p"])
    assert ok_r and ok_p and tuple(quad_r) == tuple(quad_p)
    ok_bad, _ = verify_proof_p(p[0], p[1], [[pub[0] + 1]], by["create_proof_p"])
    assert not ok_bad


def test_mock_prover_agrees(both):
    verdicts = []
    for state, mock in zip(both, (mock_r, mock_p)):
        _, _, _, circuit, se = state
        cs, _, asg = se.build(circuit, k=K)
        verdicts.append((mock.mock_verify(cs, asg), mock.mock_verify_fast(cs, asg)))
    assert verdicts[0] == verdicts[1] == ([], [])


def test_reference_state_carries_over(both, proofs):
    """`convert`'s three functions: the JAX package's params, keys and
    assignment, rebuilt as the port's classes, prove to the same bytes and
    verify to the same quad in the port."""
    r, _ = both
    pub, by = proofs
    params = convert.params_from_reference(r[0])
    vk = convert.keys_from_reference(r[1])
    pk = convert.keys_from_reference(r[2])
    assert type(params) is kzg_p.Params and type(vk).__module__.startswith("halo2_aggregation_tpu_torch.")
    assert type(pk.vk.cs).__module__ == "halo2_aggregation_tpu_torch.plonk.circuit"
    assert vk.hash_scalar() == r[1].hash_scalar()
    asg = convert.assignment_from_reference(_assignment(r))
    assert create_proof_native_p(params, pk, asg, [pub], seed=7) == by["create_proof_r"]
    ok, quad = verify_proof_p(params, vk, [pub], by["create_proof_r"])
    ok_r, quad_r = verify_proof_r(r[0], r[1], [pub], by["create_proof_r"])
    assert ok and ok_r and tuple(quad) == tuple(quad_r)


def _points(n: int, oc):
    rng = np.random.default_rng(SEED)
    g = oc.g1_generator()
    return [oc.g1_mul(g, int.from_bytes(rng.bytes(32), "little") % R) for _ in range(n)]


def test_transcript_copies_agree():
    rng = np.random.default_rng(SEED)
    scalars = [int.from_bytes(rng.bytes(32), "little") % R for _ in range(6)]
    pts = _points(4, oc_r)
    for write, read in (("Blake2bWrite", "Blake2bRead"), ("PoseidonWrite", "PoseidonRead")):
        outs = []
        for tr in (tr_r, tr_p):
            t = getattr(tr, write)()
            t.common_scalar(scalars[0])
            t.common_point(pts[0])
            ch = [t.squeeze_challenge()]
            for p, s in zip(pts[1:], scalars[1:]):
                t.write_point(p)
                t.write_scalar(s)
                ch.append(t.squeeze_challenge())
            proof = t.finalize()
            rd = getattr(tr, read)(proof)
            rd.common_scalar(scalars[0])
            rd.common_point(pts[0])
            back = [rd.squeeze_challenge()]
            for _ in pts[1:]:
                back.append((rd.read_point(), rd.read_scalar(), rd.squeeze_challenge()))
            outs.append((ch, proof, back))
        assert outs[0] == outs[1]
    digest = rng.bytes(64)
    assert tr_r.challenge_from_wide(digest) == tr_p.challenge_from_wide(digest)


def test_serialization_copies_agree():
    pts = _points(8, oc_r) + [None]
    assert pts[:-1] == _points(8, oc_p)
    for p in pts:
        b = ser_r.g1_compress(p)
        assert b == ser_p.g1_compress(p)
        assert ser_r.g1_decompress(b) == ser_p.g1_decompress(b) == p
    x = pts[0][0]
    assert ser_r.fq_to_bytes(x) == ser_p.fq_to_bytes(x)
    assert ser_r.fr_from_bytes(ser_r.fr_to_bytes(x % R)) == ser_p.fr_from_bytes(ser_p.fr_to_bytes(x % R))


def test_pairing_copies_agree():
    rng = np.random.default_rng(SEED)
    a, b = (int(v) for v in rng.integers(2, 1 << 62, size=2))
    verdicts = []
    for oc, pairing in ((oc_r, pairing_r), (oc_p, pairing_p)):
        g1, g2 = oc.g1_generator(), oc.g2_generator()
        good = [(oc.g1_mul(g1, a), oc.g2_mul(g2, b)), (oc.g1_neg(oc.g1_mul(g1, a * b % R)), g2)]
        bad = [(oc.g1_mul(g1, a), oc.g2_mul(g2, b)), (oc.g1_neg(oc.g1_mul(g1, a * b % R + 1)), g2)]
        verdicts.append((pairing.multi_pairing_check_fast(good), pairing.multi_pairing_check_fast(bad)))
    assert verdicts == [(True, False), (True, False)]
    g1, g2 = oc_r.g1_generator(), oc_r.g2_generator()
    assert pairing_r.miller_loop(oc_r.g1_mul(g1, a), g2) == pairing_p.miller_loop(oc_p.g1_mul(g1, a), g2)


def test_poseidon_copies_agree():
    rng = np.random.default_rng(SEED)
    xs = [int.from_bytes(rng.bytes(32), "little") % R for _ in range(7)]
    outs = []
    for mod in (poseidon_r, poseidon_p):
        sponge = mod.PoseidonSponge()
        for x in xs:
            sponge.absorb(x)
        outs.append((sponge.squeeze(), sponge.squeeze(), mod.permute(xs[:3]), mod.round_constants()[:4]))
    assert outs[0] == outs[1]


def test_glv_and_poly_copies_agree():
    rng = np.random.default_rng(SEED)
    s = int.from_bytes(rng.bytes(32), "little") % R
    assert glv_r.decompose(s) == glv_p.decompose(s)
    p = _points(1, oc_r)[0]
    assert glv_r.phi(p) == glv_p.phi(p)
    coeffs = [int.from_bytes(rng.bytes(32), "little") % R for _ in range(16)]
    assert poly_r.coeffs_to_lagrange(coeffs, 4) == poly_p.coeffs_to_lagrange(coeffs, 4)
    assert poly_r.lagrange_to_coeffs(coeffs, 4) == poly_p.lagrange_to_coeffs(coeffs, 4)
    assert poly_r.eval_poly(coeffs, s) == poly_p.eval_poly(coeffs, s)
    assert poly_r.divide_linear(coeffs, s) == poly_p.divide_linear(coeffs, s)
