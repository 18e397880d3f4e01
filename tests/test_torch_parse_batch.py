"""The verifier's batched host parse (`plonk/verifier_device.py::parse_batch`)
against the loop of `parse_proof` it replaces, and its pieces: the point
layout a vk gives, the batched decompression (`utils/decompress.py`)
against `serialization.g1_decompress`, and `commit_instance` against
`Params.commit_lagrange`.

`parse_batch` must give what the loop gives, field for field, and raise the
loop's first error (the lowest-index bad proof's first bad read) on every
corruption of every point slot and on every truncation; it decompresses a
batch's points in one `native.fq_batch_sqrt` call whatever B is. Inputs are
the bench's k = 9 proofs and the checked-in aggregation-circuit artifacts;
random encodings are drawn from seeds.
"""

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from halo2_aggregation_tpu.models import simple_example as se_r
from halo2_aggregation_tpu.plonk import kzg as kzg_r
from halo2_aggregation_tpu.plonk.keygen import keygen as keygen_r
from halo2_aggregation_tpu.plonk.verifier import parse_proof as parse_proof_r
from halo2_aggregation_tpu_torch import bench
from halo2_aggregation_tpu_torch.fields import Q, R
from halo2_aggregation_tpu_torch.plonk import verifier_device as vd
from halo2_aggregation_tpu_torch.plonk.verifier import parse_proof, verify_proof
from halo2_aggregation_tpu_torch.utils import artifacts, native
from halo2_aggregation_tpu_torch.utils.decompress import BadPoint, g1_decompress_batch
from halo2_aggregation_tpu_torch.utils.serialization import g1_decompress
from halo2_aggregation_tpu_torch.utils.transcript import Blake2bRead

torch.set_num_threads(1)  # the test workers share the cores

ART = Path(__file__).resolve().parents[1] / "docs" / "artifacts"
STEMS = ["outer_n1_k21", "outer_n2_k22", "outer_n2_k22b", "outer_n4_k23", "outer_n4_k23dq", "level2_n2_k23"]
SLOTS = 16  # the simple example's points a proof
BAD = 2  # the index of the corrupted proof in a batch of four


def non_residue_xs(count: int) -> list:
    """The smallest x whose x^3 + 3 has no square root in Fq."""
    out, x = [], 1
    while len(out) < count:
        if pow((x**3 + 3) % Q, (Q - 1) // 2, Q) == Q - 1:
            out.append(x)
        x += 1
    return out


def outcome(fn):
    """What `fn()` returns, or its exception's type and message."""
    try:
        return ("value", fn())
    except Exception as e:  # noqa: BLE001 - the type is what is compared
        return (type(e), str(e))


def decompress_outcome(b: bytes):
    return outcome(lambda: g1_decompress(b))


def batch_outcomes(encs: list) -> list:
    arr = np.frombuffer(b"".join(encs), dtype="<u8").reshape(-1, 4)
    return [(ValueError, e.message) if isinstance(e, BadPoint) else ("value", e) for e in g1_decompress_batch(arr)]


def loop(vk, comms, proofs):
    return [parse_proof(vk, c, p) for c, p in zip(comms, proofs)]


def as_ints(v):
    """A parsed proof as nested tuples of ints, whichever package made it."""
    if dataclasses.is_dataclass(v):
        return tuple(as_ints(getattr(v, f.name)) for f in dataclasses.fields(v))
    if isinstance(v, (list, tuple)):
        return tuple(as_ints(x) for x in v)
    return None if v is None else int(v)


@pytest.fixture(scope="module")
def protos():
    return bench.make_protos(9)


def cycled(protos, B: int):
    picks = [protos[2][i % len(protos[2])] for i in range(B)]
    return [p[2] for p in picks], [p[1] for p in picks]


def load(stem):
    meta = json.loads((ART / f"{stem}.meta.json").read_text())
    return artifacts.load_vk(str(ART / stem)), [tuple(int(c) for c in meta["inst_comm"])], (ART / f"{stem}.proof").read_bytes()


# -- parse_batch against the loop ---------------------------------------------


@pytest.mark.parametrize("B", [1, 5, 128])
def test_parse_batch_equals_the_loop(protos, B):
    _, vk, _ = protos
    comms, proofs = cycled(protos, B)
    got = vd.parse_batch(vk, comms, proofs)
    assert len(got) == B
    assert got == loop(vk, comms, proofs)
    assert bench.parse_cycled(vk, protos[2], B) == got


def test_parse_batch_equals_the_jax_package(protos):
    """B = 4, the same proof bytes through the JAX package's `parse_proof`
    under its own vk of the same circuit: challenges, points and scalars."""
    params_r = kzg_r.setup(9)
    cs_e, _, asg_e = se_r.build(se_r.MyCircuit(constant=7, a=2, b=3).without_witnesses(), k=9)
    vk_r, _ = keygen_r(params_r, cs_e, asg_e)
    _, vk, _ = protos
    assert vk_r.hash_scalar() == vk.hash_scalar()
    comms, proofs = cycled(protos, 4)
    got = vd.parse_batch(vk, comms, proofs)
    want = [parse_proof_r(vk_r, c, p) for c, p in zip(comms, proofs)]
    assert [as_ints(p) for p in got] == [as_ints(p) for p in want]
    assert all(p.x is not None and len(p.w_comms) > 0 for p in got)


@pytest.mark.parametrize("stem", STEMS)
def test_parse_batch_on_the_aggregation_circuit(stem):
    vk, comms, proof = load(stem)
    assert vd.parse_batch(vk, [comms], [proof]) == [parse_proof(vk, comms, proof)]


def test_parse_batch_of_two_aggregation_proofs_under_one_vk():
    (vk, c0, p0), (vk_b, c1, p1) = load("outer_n2_k22"), load("outer_n2_k22b")
    assert vk_b.hash_scalar() == vk.hash_scalar()
    assert vd.parse_batch(vk, [c0, c1], [p0, p1]) == loop(vk, [c0, c1], [p0, p1])


# -- the layout ----------------------------------------------------------------


def spy_offsets(vk, comms, proof) -> tuple:
    """The offsets at which `parse_proof` reads a point of a real proof."""
    seen = []

    class Spy(Blake2bRead):
        def read_point(self):
            seen.append(self.off)
            return super().read_point()

    parse_proof(vk, comms, proof, Spy)
    return tuple(seen)


def test_layout_of_the_simple_example(protos):
    _, vk, ps = protos
    layout = vd.point_layout(vk)
    assert len(layout) == SLOTS and list(layout) == sorted(layout)
    for _, proof, comms in ps:
        assert spy_offsets(vk, comms, proof) == layout
    assert vd.point_layout(vk) == layout  # the vk's alone, whatever the proof


@pytest.mark.parametrize("stem", STEMS)
def test_layout_of_the_aggregation_circuit(stem):
    vk, comms, proof = load(stem)
    assert vd.point_layout(vk) == spy_offsets(vk, comms, proof)


# -- decompression -------------------------------------------------------------


def edge_encodings() -> list:
    sign = 1 << 255
    vals = [0, sign, Q - 1, Q, Q + 1, sign | (Q - 1), sign | Q, (1 << 255) - 1, (1 << 256) - 1]
    vals += [x | s for x in non_residue_xs(4) for s in (0, sign)]
    vals += [1, sign | 1]  # the generator's x, both signs: (1, 2) and (1, -2)
    return [v.to_bytes(32, "little") for v in vals]


def test_decompress_batch_equals_g1_decompress():
    rng = np.random.default_rng(20261017)
    raw = [bytes(r) for r in rng.integers(0, 256, size=(2000, 32), dtype=np.uint8)]
    below = []
    for r in rng.integers(0, 256, size=(1000, 32), dtype=np.uint8):
        v = int.from_bytes(bytes(r), "little")
        below.append(((v >> 1) % Q | (v & 1) << 255).to_bytes(32, "little"))
    encs = edge_encodings() + raw + below
    want = [decompress_outcome(b) for b in encs]
    assert batch_outcomes(encs) == want
    kinds = {w[1] if w[0] is ValueError else type(w[1]).__name__ for w in want}
    assert kinds == {"bad point encoding", "x not on curve", "tuple", "NoneType"}
    assert [w[1] for w in want[len(edge_encodings()) - 2 : len(edge_encodings())]] == [(1, 2), (1, Q - 2)]


@settings(max_examples=40, deadline=None)
@given(st.lists(st.binary(min_size=32, max_size=32), min_size=1, max_size=40))
def test_decompress_batch_equals_g1_decompress_on_any_bytes(encs):
    assert batch_outcomes(encs) == [decompress_outcome(b) for b in encs]


def test_decompress_batch_of_nothing_calls_no_root(monkeypatch):
    calls = []
    monkeypatch.setattr(native, "fq_batch_sqrt", lambda *a: calls.append(a))
    assert g1_decompress_batch(np.zeros((0, 4), np.uint64)) == []
    assert g1_decompress_batch(np.zeros((3, 4), np.uint64)) == [None] * 3
    assert calls == []


@pytest.mark.parametrize("B", [1, 5, 128])
def test_one_square_root_call_a_batch(protos, monkeypatch, B):
    calls = []
    real = native.fq_batch_sqrt

    def spy(vals):
        calls.append(len(vals))
        return real(vals)

    monkeypatch.setattr(native, "fq_batch_sqrt", spy)
    _, vk, _ = protos
    comms, proofs = cycled(protos, B)
    vd.parse_batch(vk, comms, proofs)
    assert calls == [SLOTS * B]


# -- faults: the loop's first error -------------------------------------------


def corrupt(proof: bytes, off: int, kind: str) -> bytes:
    b = bytearray(proof)
    if kind == "x_at_least_q":
        b[off : off + 32] = (Q + 7).to_bytes(32, "little")
    elif kind == "non_residue":
        b[off : off + 32] = non_residue_xs(1)[0].to_bytes(32, "little")
    elif kind == "zero":
        b[off : off + 32] = bytes(32)
    elif kind == "sign_flip":  # the negated point: valid, other challenges
        b[off + 31] ^= 0x80
    return bytes(b)


def assert_same_outcome(vk, comms, proofs):
    want = outcome(lambda: loop(vk, comms, proofs))
    assert outcome(lambda: vd.parse_batch(vk, comms, proofs)) == want
    return want


@pytest.mark.parametrize("slot", range(SLOTS))
@pytest.mark.parametrize("kind", ["x_at_least_q", "non_residue", "zero", "sign_flip"])
def test_corrupt_slot_gives_the_loops_outcome(protos, kind, slot):
    _, vk, _ = protos
    comms, proofs = cycled(protos, 4)
    proofs[BAD] = corrupt(proofs[BAD], vd.point_layout(vk)[slot], kind)
    got = assert_same_outcome(vk, comms, proofs)
    expected = {"x_at_least_q": "bad point encoding", "non_residue": "x not on curve",
                "zero": "cannot absorb the identity point"}
    if kind in expected:
        assert got == (ValueError, expected[kind])
    else:
        assert got[0] == "value" and got[1][BAD] != parse_proof(vk, comms[BAD], cycled(protos, 4)[1][BAD])


def truncations(protos):
    _, vk, ps = protos
    n = len(ps[0][1])
    cuts = [0, 1, n - 1, 400, 700]
    for off in vd.point_layout(vk):
        cuts += [off, off + 16, off + 31]
    return sorted(set(cuts))


def test_truncated_proof_gives_the_loops_outcome(protos):
    _, vk, _ = protos
    comms, proofs = cycled(protos, 4)
    for cut in truncations(protos):
        bad = list(proofs)
        bad[BAD] = proofs[BAD][:cut]
        assert assert_same_outcome(vk, comms, bad) == (ValueError, "transcript exhausted"), cut


def test_the_lowest_bad_proof_raises_first(protos):
    """Proof 1 fails late (its last point is off the curve), proof 2 early
    (its first point is out of range), proof 3 is cut: proof 1's error."""
    _, vk, _ = protos
    layout = vd.point_layout(vk)
    comms, proofs = cycled(protos, 4)
    proofs[1] = corrupt(proofs[1], layout[-1], "non_residue")
    proofs[2] = corrupt(proofs[2], layout[0], "x_at_least_q")
    proofs[3] = proofs[3][:100]
    assert assert_same_outcome(vk, comms, proofs) == (ValueError, "x not on curve")
    proofs[1] = proofs[1][: layout[-1] + 8]
    assert assert_same_outcome(vk, comms, proofs) == (ValueError, "transcript exhausted")
    proofs[1] = cycled(protos, 4)[1][1]
    assert assert_same_outcome(vk, comms, proofs) == (ValueError, "bad point encoding")


def test_a_read_outside_the_layout_raises(protos):
    _, vk, ps = protos
    proof = ps[0][1]
    slots = {off: i for i, off in enumerate(vd.point_layout(vk)[1:])}  # the first slot missing
    t = vd._BatchRead(slots, [], proof)
    with pytest.raises(RuntimeError, match="outside the vk's point layout"):
        t.read_point()


# -- the instance commitments --------------------------------------------------


def seeded_columns(usable: int) -> list:
    rng = np.random.default_rng(13)
    cols = []
    for length, density in [(1, 1.0), (5, 0.6), (40, 0.1), (usable, 0.02), (usable, 1.0)]:
        vals = [int.from_bytes(bytes(r), "little") % R for r in rng.integers(0, 256, size=(length, 32), dtype=np.uint8)]
        keep = rng.random(length) < density
        cols.append([v if k else 0 for v, k in zip(vals, keep)])
    return cols


def test_commit_instance_equals_commit_lagrange(protos):
    params, vk, _ = protos
    usable = vk.cs.usable_rows(vk.n)
    cols = seeded_columns(usable) + [[R + 5, 2 * R, (1 << 256) - 1], [0, 0, R]]
    for col in cols:
        assert vd.commit_instance(params, col, usable) == params.commit_lagrange(col)


def test_commit_instance_of_the_zero_column_calls_no_msm(protos, monkeypatch):
    params, vk, _ = protos
    calls = []
    monkeypatch.setattr(native, "g1_msm_u64", lambda *a: calls.append(a))
    for col in ([], [0], [0] * 7, [R, 0, 2 * R]):
        assert vd.commit_instance(params, col, vk.cs.usable_rows(vk.n)) is None
    assert calls == []


def test_commit_instance_refuses_what_verify_proof_refuses(protos):
    params, vk, ps = protos
    usable = vk.cs.usable_rows(vk.n)
    col = [1] * (usable + 1)
    with pytest.raises(ValueError, match="instance too large") as got:
        vd.commit_instance(params, col, usable)
    with pytest.raises(ValueError) as want:
        verify_proof(params, vk, [col], ps[0][1])
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="instance too large"):
        vd.verify_batch(params, vk, [[col]], [ps[0][1]], device="cpu")
    assert vd.commit_instance(params, col[:usable], usable) == params.commit_lagrange(col[:usable])
