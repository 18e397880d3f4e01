"""The kernels' arithmetic on the host: g++ builds `csrc/field.cuh`,
`curve.cuh` (with the mixed add), K1's scalar split and two-half lane,
K8's lane and its rounds on given halves, the tape interpreter of K2 and K6
with K2's shared-memory register file, the segmented sum's per-thread code
and tree (`jac_sum.cuh`), the NTT butterflies, stage index maps and fused
passes of K3-K4 and K5's power series (`ntt.cuh`), and the per-thread sort,
walk, fold and Horner of K7 and K9 (`msm.cuh`) through
`csrc/host_shim.cpp`, and each is checked against its plain PyTorch
version, exactly (points as affine points)."""

import ctypes
import shutil

import numpy as np
import pytest
import torch

from halo2_aggregation_tpu.fields import Q, R
from halo2_aggregation_tpu.oracle import curve as oc
from halo2_aggregation_tpu.oracle import glv
from halo2_aggregation_tpu_torch.ops import build
from halo2_aggregation_tpu_torch.ops import curve_ops as co
from halo2_aggregation_tpu_torch.ops import field_ops as fo
from halo2_aggregation_tpu_torch.ops.ec_kernels import glv_constants, glv_split
from halo2_aggregation_tpu_torch.ops.limbs import ints_to_tensor, tensor_to_ints

torch.set_num_threads(1)  # tiny tensors; the test workers share the cores

RNG = np.random.default_rng(0xC0DE)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")
    return build.build_host_library(tmp_path_factory.mktemp("host_core"))


def _ptr(t: torch.Tensor):
    return ctypes.c_void_p(t.data_ptr())


def _points(pts):
    return co.affine_to_jac(co.affine_from_ints(pts, "cpu"))


def _rand_points(n):
    g = oc.g1_generator()
    return [oc.g1_mul(g, int(RNG.integers(1, 1 << 62))) for _ in range(n)]


@pytest.mark.parametrize("field", ["Fq", "Fr"])
def test_mont_mul(lib, field):
    spec, p = (fo.FQ, Q) if field == "Fq" else (fo.FR, R)
    xs = [0, 1, p - 1, p - 2] + [int.from_bytes(RNG.bytes(40), "little") % p for _ in range(28)]
    ys = [p - 1, p - 1, p - 1, 3] + [int.from_bytes(RNG.bytes(40), "little") % p for _ in range(28)]
    a, b = ints_to_tensor(xs, "cpu"), ints_to_tensor(ys, "cpu")
    out = torch.empty_like(a)
    lib.h2a_host_mont_mul(int(field == "Fr"), _ptr(a), _ptr(b), _ptr(out), len(xs))
    assert torch.equal(out, fo.mont_mul(a, b, spec))


@pytest.mark.parametrize("field", ["Fq", "Fr"])
def test_mont_mul_carry_chain(lib, field):
    """`fe_mul_cc`, the product the card runs (carries in the flag, two
    8-limb accumulators), with the flag kept in a variable: equal to the
    portable CIOS and to the plain product on every pair of the edge values
    and on random pairs."""
    spec, p = (fo.FQ, Q) if field == "Fq" else (fo.FR, R)
    rng = np.random.default_rng(0xCC + len(field))
    edge = [0, 1, 2, p - 1, p - 2, (1 << 256) % p, (1 << 253) - 1, 1 << 253, (1 << 32) - 1, 1 << 32]
    rnd = [int.from_bytes(rng.bytes(40), "little") % p for _ in range(4000)]
    xs = [u for u in edge for _ in edge] + rnd[:2000]
    ys = [v for _ in edge for v in edge] + rnd[2000:]
    a, b = ints_to_tensor(xs, "cpu"), ints_to_tensor(ys, "cpu")
    chain, portable = torch.empty_like(a), torch.empty_like(a)
    lib.h2a_host_mont_mul_cc(int(field == "Fr"), _ptr(a), _ptr(b), _ptr(chain), len(xs))
    lib.h2a_host_mont_mul(int(field == "Fr"), _ptr(a), _ptr(b), _ptr(portable), len(xs))
    assert torch.equal(chain, portable)
    assert torch.equal(chain, fo.mont_mul(a, b, spec))


@pytest.mark.parametrize("field", ["Fq", "Fr"])
def test_add_sub_carry_chain(lib, field):
    """`fe_add_cc` and `fe_sub_cc`, the sum and difference the card runs on
    the carry flag, equal the portable forms and the plain versions on
    every pair of the edge values and on random pairs."""
    spec, p = (fo.FQ, Q) if field == "Fq" else (fo.FR, R)
    rng = np.random.default_rng(0xADD + len(field))
    edge = [0, 1, p - 1, p - 2, (p - 1) // 2, (p + 1) // 2, (1 << 253) - 1, 1 << 253, (1 << 32) - 1, 1 << 32]
    rnd = [int.from_bytes(rng.bytes(40), "little") % p for _ in range(2000)]
    xs = [u for u in edge for _ in edge] + rnd[:1000]
    ys = [v for _ in edge for v in edge] + rnd[1000:]
    a, b = ints_to_tensor(xs, "cpu"), ints_to_tensor(ys, "cpu")
    out = {cc: (torch.empty_like(a), torch.empty_like(a)) for cc in (0, 1)}
    for cc, (total, diff) in out.items():
        lib.h2a_host_add_sub(int(field == "Fr"), cc, _ptr(a), _ptr(b), _ptr(total), _ptr(diff), len(xs))
    assert torch.equal(out[1][0], out[0][0]) and torch.equal(out[1][1], out[0][1])
    assert torch.equal(out[1][0], fo.add(a, b, spec)) and torch.equal(out[1][1], fo.sub(a, b, spec))
    assert tensor_to_ints(out[1][0]) == [(x + y) % p for x, y in zip(xs, ys)]
    assert tensor_to_ints(out[1][1]) == [(x - y) % p for x, y in zip(xs, ys)]


@pytest.mark.parametrize("field", ["Fq", "Fr"])
def test_inverse_sliding_window(lib, field):
    """`fe_inv`, the Fermat inverse by a sliding window over the exponent,
    equals the plain inverse and a^(p - 2) on host ints; 0 maps to 0."""
    spec, p = (fo.FQ, Q) if field == "Fq" else (fo.FR, R)
    rng = np.random.default_rng(0x1A7 + len(field))
    xs = [0, 1, 2, p - 1, p - 2, (1 << 256) % p] + [int.from_bytes(rng.bytes(40), "little") % p for _ in range(58)]
    a = ints_to_tensor(xs, "cpu")
    out = torch.empty_like(a)
    lib.h2a_host_inv(int(field == "Fr"), _ptr(a), _ptr(out), len(xs))
    assert torch.equal(out, fo.inv(a, spec))
    rinv = pow(1 << 256, -1, p)
    assert tensor_to_ints(out) == [pow(x * rinv % p, p - 2, p) * (1 << 256) % p for x in xs]
    assert tensor_to_ints(out)[0] == 0


def test_jac_add_edge_cases(lib):
    g = oc.g1_generator()
    rnd = _rand_points(4)
    pts = [g, g, None, g, None] + rnd
    qts = [g, oc.g1_neg(g), g, None, None] + rnd[::-1]
    P, Qp = _points(pts), _points(qts)
    # (n, 3, 8) buffers, held in names while the library reads them
    a, b = (torch.stack(list(J), 1).contiguous() for J in (P, Qp))
    out = torch.empty_like(a)
    lib.h2a_host_jac_add(_ptr(a), _ptr(b), _ptr(out), len(pts))
    got = co.jac_to_ints(co.JacPoint(out[:, 0], out[:, 1], out[:, 2]))
    assert got == co.jac_to_ints(co.jac_add(P, Qp))
    assert got == [oc.g1_add(a, b) for a, b in zip(pts, qts)]


GLV = torch.from_numpy(glv_constants().view(np.int32))  # K1's split constants


def _host_ec_win(lib, pts, ks):
    """K1's two-half lane on every lane -> (Jacobian out, affine ints)."""
    P = _points(pts)
    s = ints_to_tensor(ks, "cpu")
    out = co.JacPoint(*(torch.empty_like(c) for c in P))
    lib.h2a_host_ec_win(*(_ptr(c) for c in P), _ptr(s), _ptr(GLV), *(_ptr(c) for c in out), len(pts))
    return P, s, out, co.jac_to_ints(out)


def _host_split(lib, ks):
    """K1's scalar split -> [(s1, s2)] signed halves."""
    s = ints_to_tensor(ks, "cpu")
    mags = torch.empty((len(ks), 2, 8), dtype=torch.int32)
    negs = torch.empty((len(ks), 2), dtype=torch.int32)
    lib.h2a_host_glv_split(_ptr(s), _ptr(GLV), _ptr(mags), _ptr(negs), len(ks))
    m = tensor_to_ints(mags.reshape(-1, 8))
    sg = negs.reshape(-1).tolist()
    assert set(sg) <= {0, 1}
    return [(-m[2 * i] if sg[2 * i] else m[2 * i], -m[2 * i + 1] if sg[2 * i + 1] else m[2 * i + 1])
            for i in range(len(ks))]


def test_windowed_scalar_mul(lib):
    pts = _rand_points(6) + [None, oc.g1_generator()]
    ks = [int.from_bytes(RNG.bytes(32), "little") % R for _ in range(5)] + [(1 << 256) - 1, 9, 0]
    P, s, out, got = _host_ec_win(lib, pts, ks)
    assert got == co.jac_to_ints(co.scalar_mul(P, s))
    assert got == [oc.g1_mul(p, k) if p else None for p, k in zip(pts, ks)]
    assert (out.z[6:] == 0).all() and (out.z[:6] != 0).any(-1).all()


# scalars whose halves meet in the last add: s = 2 a (mod r) for a short
# lattice vector (a, b) splits into (a, -b), and a = -b lambda (mod r)
_GLV_EDGE = [0, 1, R - 1, R, R + 1, (1 << 256) - 1, 2, 15, 16, 1 << 128, glv.LAMBDA, R - glv.LAMBDA] + [
    sign * 2 * v[0] % R for v in (glv._V1, glv._V2) for sign in (1, -1)
]


def test_glv_split_identity_and_bound(lib):
    """K1's scalar split on 10^5 random scalars below 2^256 and on the edge
    values: s1 + s2 lambda = s (mod r), |s1| and |s2| below 2^132 (the 33
    windows of a half), and the halves the constants were made for: within
    a basis vector of `oracle/glv.decompose`'s."""
    rng = np.random.default_rng(0x61F)
    raw = rng.integers(0, 1 << 32, size=(100_000, 8), dtype=np.uint64).astype(np.uint32)
    ks = tensor_to_ints(torch.from_numpy(raw.view(np.int32))) + _GLV_EDGE
    halves = _host_split(lib, ks)
    worst = 0
    for k, (s1, s2) in zip(ks, halves):
        assert (s1 + s2 * glv.LAMBDA - k) % R == 0, k
        worst = max(worst, abs(s1), abs(s2))
    assert worst < 1 << (4 * 33)
    assert halves[-500:] == [glv_split(k) for k in ks[-500:]]  # the host mirror of the split
    assert worst.bit_length() <= glv.GLV_BITS + 1
    assert halves[len(ks) - len(_GLV_EDGE)] == (0, 0) and halves[len(ks) - len(_GLV_EDGE) + 3] == (0, 0)
    (a1, b1), (a2, b2) = glv._V1, glv._V2
    for k, (s1, s2) in list(zip(ks, halves))[-200:]:
        sg1, m1, sg2, m2 = glv.decompose(k)
        d1, d2 = s1 - sg1 * m1, s2 - sg2 * m2
        assert (d1, d2) in {(i * a1 + j * a2, i * b1 + j * b2) for i in (-1, 0, 1) for j in (-1, 0, 1)}


def test_glv_lane_cases(lib):
    """K1's two-half lane against `oracle.curve.g1_mul` on the edge
    scalars (0, 1, r - 1, r, r + 1, 2^256 - 1, ...), identity points, zero
    scalars, and scalars whose two halves give the same point, so that the
    last add doubles."""
    ks = list(_GLV_EDGE)
    pts = _rand_points(len(ks))
    pts[6], pts[9] = None, oc.g1_generator()
    ks += [0, 5, int.from_bytes(RNG.bytes(32), "little")]
    pts += [pts[0], None, pts[1]]
    _, _, out, got = _host_ec_win(lib, pts, ks)
    assert got == [oc.g1_mul(p, k % R) if p else None for p, k in zip(pts, ks)]
    one = fo.narrow(fo.FQ.wide("cpu").one)
    for i, g in enumerate(got):
        if g is None:
            assert torch.equal(out.x[i], one) and torch.equal(out.y[i], one) and not out.z[i].any()
    halves = _host_split(lib, ks)
    doubling = [k for k, (s1, s2) in zip(ks, halves) if s1 and (s1 - s2 * glv.LAMBDA) % R == 0]
    assert doubling, "no lane's halves met in the doubling branch of the last add"


@pytest.fixture(scope="module")
def vk9():
    """The simple example's vk at k = 9 as the port's own class."""
    from halo2_aggregation_tpu.models import simple_example as se
    from halo2_aggregation_tpu.plonk import kzg
    from halo2_aggregation_tpu.plonk.keygen import keygen
    from halo2_aggregation_tpu_torch.convert import keys_from_reference

    params = kzg.setup(9)
    circuit = se.MyCircuit(constant=7, a=2, b=3)
    cs_e, _, asg_e = se.build(circuit.without_witnesses(), k=9)
    return keys_from_reference(keygen(params, cs_e, asg_e)[0])


def _host_tape(lib, tape, inputs):
    """The tape over `TapeRegs`, registers in (host) device memory."""
    lanes = inputs.shape[1]
    instrs, consts, outputs = tape.device_arrays("cpu")
    tmp = torch.zeros((tape.n_temps, lanes, 8), dtype=torch.int32)
    out = torch.empty((len(tape.outputs), lanes, 8), dtype=torch.int32)
    lib.h2a_host_fa_tape(
        _ptr(instrs), instrs.shape[0], _ptr(consts), _ptr(inputs), tape.n_inputs,
        _ptr(tmp), _ptr(outputs), len(tape.outputs), _ptr(out), lanes,
    )
    return out


def test_tape_interpreter(lib, vk9):
    from halo2_aggregation_tpu_torch.plonk import fa_fused as ff
    from halo2_aggregation_tpu_torch.plonk.verifier_device import synthetic_batch

    lanes = 2
    batch = synthetic_batch(vk9, lanes, "cpu", seed=11)
    tape = ff.fa_tape(vk9)
    inputs = torch.stack(ff.fa_gather(vk9, batch)).contiguous()
    out = _host_tape(lib, tape, inputs)
    want = ff.fa_tape_eval_plain(tape, inputs)
    assert torch.equal(out, want)
    assert tensor_to_ints(out[0]) != [0, 0]


@pytest.mark.parametrize("e_scalar", [False, True], ids=["three_outputs", "with_e_scalar"])
def test_tape_shared_register_file(lib, vk9, e_scalar):
    """K2's lane over `SharedTapeRegs` ([register][limb][lane] for a block
    of 32 lanes, inputs copied in once) equals the lane over `TapeRegs` and
    the plain version, on 70 lanes: two full blocks and a ragged one."""
    from halo2_aggregation_tpu_torch.plonk import fa_fused as ff
    from halo2_aggregation_tpu_torch.plonk.verifier_device import synthetic_batch

    lanes = 70
    batch = synthetic_batch(vk9, lanes, "cpu", seed=12)
    tape = ff.fa_tape(vk9, e_scalar)
    cols = ff.fa_gather(vk9, batch) + ([batch.y, batch.x] if e_scalar else [])
    inputs = torch.stack(cols).contiguous()
    instrs, consts, outputs = tape.device_arrays("cpu")
    out = torch.empty((len(tape.outputs), lanes, 8), dtype=torch.int32)
    lib.h2a_host_fa_tape_shared(
        _ptr(instrs), instrs.shape[0], _ptr(consts), _ptr(inputs), tape.n_inputs, tape.n_temps,
        _ptr(outputs), len(tape.outputs), _ptr(out), lanes, ff.LANES_PER_BLOCK,
    )
    assert torch.equal(out, _host_tape(lib, tape, inputs))
    assert torch.equal(out[:, :8], ff.fa_tape_eval_plain(tape, inputs[:, :8].contiguous()))
    assert ff.shared_bytes(tape) == 4 * (
        4 * instrs.shape[0] + 8 * len(tape.consts) + (tape.n_inputs + tape.n_temps) * 8 * 32
    ) <= ff.MAX_SHARED_BYTES


@pytest.mark.parametrize("lane_axis", [0, 1], ids=["lanes_first", "batch_first"])
def test_jac_segment_sum_lanes(lib, lane_axis):
    """The segmented sum as its warps run it (32 partial sums a segment,
    then the tree) on segments of 0, 1, 31, 32, 33 and 70 lanes of B = 2
    batch elements, in both layouts, against the plain version and the
    oracle as affine points.  The lanes hold identities, a point twice in
    one thread's run and twice across the tree (the doubling branch), and
    a point with its negation (the cancelling branch)."""
    lens = [0, 1, 31, 32, 33, 70]
    offsets = [0]
    for m in lens:
        offsets.append(offsets[-1] + m)
    M, Bn = offsets[-1], 2
    base = _rand_points(24)
    rng = np.random.default_rng(0x5E6 + lane_axis)
    pts = [[base[int(rng.integers(len(base)))] for _ in range(M)] for _ in range(Bn)]
    for row in pts:
        for i in range(3, M, 11):
            row[i] = None  # identities
    o31, o32, o33, o70 = offsets[2], offsets[3], offsets[4], offsets[5]
    pts[0][offsets[1]] = None                                # a segment that is one identity
    pts[0][o33], pts[0][o33 + 32] = base[0], base[0]         # twice in thread 0's run
    pts[0][o32 + 1], pts[0][o32 + 17] = base[1], base[1]     # twice across the tree
    pts[1][o32 + 2], pts[1][o32 + 18] = base[2], oc.g1_neg(base[2])  # cancels in the tree
    pts[1][o70 + 5], pts[1][o70 + 37] = base[3], oc.g1_neg(base[3])  # cancels in a thread's run
    pts[1][o31 : o31 + 31] = [base[4], oc.g1_neg(base[4])] * 15 + [None]  # sums to the identity
    flat = _points([p for row in pts for p in row])
    P = co.JacPoint(*(c.reshape(Bn, M, 8) for c in flat))
    if lane_axis == 0:
        P = co.JacPoint(*(c.transpose(0, 1).contiguous() for c in P))
    offs = torch.tensor(offsets, dtype=torch.int32)
    out = co.JacPoint(*(torch.empty((len(lens), Bn, 8), dtype=torch.int32) for _ in range(3)))
    lib.h2a_host_jac_segment_sum(
        *(_ptr(c) for c in P), P.x.stride(1 - lane_axis), P.x.stride(lane_axis),
        _ptr(offs), len(lens), Bn, *(_ptr(c) for c in out),
    )
    got = co.jac_to_ints(co.JacPoint(*(c.reshape(-1, 8) for c in out)))
    want = co.jac_segment_sum(P, offsets, lane_axis)
    assert got == co.jac_to_ints(co.JacPoint(*(c.reshape(-1, 8) for c in want)))
    expect = []
    for j in range(len(lens)):
        for b in range(Bn):
            acc = None
            for p in pts[b][offsets[j] : offsets[j + 1]]:
                acc = oc.g1_add(acc, p)
            expect.append(acc)
    assert got == expect
    assert expect[0] is None and expect[2] is None and expect[2 * 2 + 1] is None
    one = fo.narrow(fo.FQ.wide("cpu").one)
    for coords in (out, want):
        for i in (0, 1, 2, 5):  # empty segments, the identity lane, the cancelled segment
            x, y, z = (c.reshape(-1, 8)[i] for c in coords)
            assert torch.equal(x, one) and torch.equal(y, one) and not z.any()


def _rand_stack(rng, c, n) -> torch.Tensor:
    """(c, n, 8) canonical values (top 32-bit limb below r's)."""
    a = rng.integers(0, 1 << 32, size=(c, n, 8), dtype=np.uint64)
    a[..., 7] &= 0x1FFF_FFFF
    return torch.from_numpy(a.astype(np.uint32).view(np.int32))


def test_ntt_stages(lib):
    """A full k = 7 NTT and INTT through the host-built butterflies and
    stage index maps, one stage at a time (the reference that
    `test_ntt_fused_passes` holds the kernels' passes to)."""
    from halo2_aggregation_tpu_torch.ops import ntt as nt

    k, cols = 7, 3
    tables = nt.NttTables(k, "cpu")
    x = _rand_stack(RNG, cols, 1 << k)
    fwd = x.clone()
    for s in range(k):
        lib.h2a_host_ntt_stage(_ptr(fwd), _ptr(tables.fwd), cols, k, s, 0)
    assert torch.equal(fwd, nt.ntt_plain(x, tables.fwd))
    inv = x.clone()
    for s in range(k - 1, -1, -1):
        lib.h2a_host_ntt_stage(_ptr(inv), _ptr(tables.inv), cols, k, s, 1)
    ninv = tables.n_inv.expand_as(inv).contiguous()
    lib.h2a_host_mont_mul(1, _ptr(inv), _ptr(ninv), _ptr(inv), inv.numel() // 8)
    assert torch.equal(inv, nt.intt_plain(x, tables.inv, tables.n_inv))
    # the index map itself: every element in exactly one pair per stage
    for s in range(k):
        lo, hi, tw = nt.stage_pairs(k, s, "cpu")
        assert sorted(torch.cat([lo, hi]).tolist()) == list(range(1 << k))
        assert int(tw.max()) < (1 << (k - 1))


@pytest.mark.parametrize("dif", [False, True], ids=["dit", "dif"])
@pytest.mark.parametrize("k", [1, 2, 5, 7, 8, 11, 13, 14])
def test_ntt_fused_passes(lib, k, dif):
    """K3's and K4's fused passes through the host build of the tile code
    (one pass, ragged r, three passes; the DIF with its folded 1/n) equal
    the stage-by-stage transform and the plain version bit for bit."""
    from halo2_aggregation_tpu_torch.ops import ntt as nt

    cols = 2
    tables = nt.NttTables(k, "cpu")
    x = _rand_stack(np.random.default_rng(1000 + k), cols, 1 << k)
    tw = tables.inv if dif else tables.fwd
    plan = nt.pass_plan(k)
    fused = x.clone()
    for s0, r in reversed(plan) if dif else plan:
        scale = _ptr(tables.n_inv) if dif and s0 == 0 else None
        run = lib.h2a_host_ntt_pass(_ptr(fused), _ptr(tw), scale, cols, k, s0, r, int(dif))
        assert run == 1 << nt.pass_chunk_bits(k, s0, r)
    staged = x.clone()
    for s in range(k - 1, -1, -1) if dif else range(k):
        lib.h2a_host_ntt_stage(_ptr(staged), _ptr(tw), cols, k, s, int(dif))
    if dif:
        ninv = tables.n_inv.expand_as(staged).contiguous()
        lib.h2a_host_mont_mul(1, _ptr(staged), _ptr(ninv), _ptr(staged), staged.numel() // 8)
    assert torch.equal(fused, staged)
    want = nt.intt_plain(x, tw, tables.n_inv) if dif else nt.ntt_plain(x, tw)
    assert torch.equal(fused, want)


@pytest.mark.parametrize("k", range(1, 25))
def test_ntt_pass_plan(lib, k):
    """`pass_plan(k)` covers every stage once, in order, in ceil(k / R_MAX)
    passes of at most R_MAX stages; each pass's slot -> element map is a
    bijection with runs of 2^c neighbours, and the kernel's map
    (`ntt_tile_index`) equals its Python mirror."""
    from halo2_aggregation_tpu_torch.ops import ntt as nt

    plan = nt.pass_plan(k)
    assert len(plan) == -(-k // nt.R_MAX)
    assert [s for s0, r in plan for s in range(s0, s0 + r)] == list(range(k))
    sizes = [r for _, r in plan]
    assert 1 <= min(sizes) and max(sizes) <= nt.R_MAX and max(sizes) - min(sizes) <= 1
    for s0, r in plan:
        c = nt.pass_chunk_bits(k, s0, r)
        assert 0 <= c <= nt.C_MAX and r + c <= k and (c == nt.C_MAX or k - r < nt.C_MAX or 0 < s0 < nt.C_MAX)
        if k > 20:
            continue  # the maps below are 2^k entries each
        idx = nt.tile_indices(k, s0, r)
        assert idx.shape == (1 << (k - r - c), 1 << (r + c))
        assert np.array_equal(np.sort(idx.ravel()), np.arange(1 << k))
        # a tile's elements agree outside the pass's bits and its run's
        group = ((1 << r) - 1) << s0 | ((1 << c) - 1 if s0 else ((1 << (r + c)) - 1))
        assert ((idx & ~group) == (idx[:, :1] & ~group)).all()
        runs = idx.reshape(-1, 1 << c)
        assert (runs == runs[:, :1] + np.arange(1 << c)).all()
        got = torch.empty(1 << k, dtype=torch.int32)
        lib.h2a_host_ntt_tile_indices(k, s0, r, _ptr(got))
        assert np.array_equal(got.numpy().astype(np.int64), idx.ravel())


def _host_pow_series(lib, base, k, start, bitrev):
    """K5's series as its two launches run it: the tables, then the products."""
    from halo2_aggregation_tpu_torch.ops import ntt as nt

    sq = nt.pow_series_squares(base, k, "cpu", start)
    out = torch.empty((1 << k, 8), dtype=torch.int32)
    lib.h2a_host_pow_series(_ptr(out), _ptr(sq), k, int(bitrev))
    return out


@pytest.mark.parametrize("bitrev", [False, True])
def test_pow_series_element(lib, bitrev):
    from halo2_aggregation_tpu_torch.ops import ntt as nt

    k = 6
    out = _host_pow_series(lib, R - 3, k, 5, bitrev)
    assert torch.equal(out, nt.pow_series(R - 3, k, "cpu", start=5, bitrev=bitrev))


@pytest.mark.parametrize("bitrev", [False, True], ids=["natural", "bitrev"])
@pytest.mark.parametrize("k", [0, 1, 2, 5, 11, 14])
def test_pow_series_tables(lib, k, bitrev):
    """The two tables of 2^ceil(k/2) and 2^floor(k/2) entries and one
    product an element, against the plain select ladder over the k bits:
    k = 0 and 1 (a table of one entry), 2, odd and even k."""
    from halo2_aggregation_tpu_torch.ops import ntt as nt

    base, start = int.from_bytes(RNG.bytes(32), "little") % R, 1 + k
    out = _host_pow_series(lib, base, k, start, bitrev)
    want = nt.pow_series_plain(nt.mont_tensor(start, "cpu"), nt.mont_tensor(base, "cpu"), k, bitrev)
    assert torch.equal(out, want)
    idx = (1 << k) - 1
    last = nt.bit_reverse_indices(k)[idx] if bitrev and k else idx
    assert tensor_to_ints(out[idx:])[0] == fo.FR.to_mont(start * pow(base, int(last), R) % R)


def test_quotient_lane(lib):
    """K6's lane on rows 0, 1, n-1 and a middle row of the simple
    example's quotient tape, against the plain tape."""
    from halo2_aggregation_tpu.models import simple_example as se
    from halo2_aggregation_tpu_torch.convert import constraint_system_from_reference
    from halo2_aggregation_tpu_torch.ops.ntt import mont_tensor
    from halo2_aggregation_tpu_torch.plonk import quotient_program as qp

    cs, _, _ = se.build(se.MyCircuit(constant=7, a=2, b=3).without_witnesses(), k=9)
    qt = qp.quotient_tape(constraint_system_from_reference(cs))
    n = 1 << 6
    C = int(qt.sources[:, 0].max()) + 1
    stack, x = _rand_stack(RNG, C, n), _rand_stack(RNG, 1, n)[0]
    uniforms = torch.stack([mont_tensor(v, "cpu") for v in (2, 3, 5, 7, 11)])
    rows = torch.tensor([0, 1, n - 1, n // 2], dtype=torch.int32)
    instrs, consts, _ = qt.tape.device_arrays("cpu")
    src, rot = qt.device_arrays("cpu")
    out = torch.empty((len(rows), 8), dtype=torch.int32)
    lib.h2a_host_quotient_rows(
        _ptr(instrs), instrs.shape[0], _ptr(consts), _ptr(src), _ptr(rot), qt.tape.n_inputs,
        _ptr(stack), _ptr(x), _ptr(uniforms), n, qt.tape.outputs[0], _ptr(rows), len(rows), _ptr(out),
    )
    want = qp.quotient_tape_eval_plain(qt, stack, x, uniforms, rows.long())
    assert torch.equal(out, want)
    assert len(set(tensor_to_ints(out))) == len(rows)


def test_jac_add_mixed_edge_cases(lib):
    """P + P (doubling), P + (-P) (identity), a bucket at infinity, random."""
    g = oc.g1_generator()
    rnd = _rand_points(6)
    pts = [g, g, None] + rnd[:3]
    qts = [g, oc.g1_neg(g), rnd[3]] + rnd[3:]
    P = _points(pts)
    x2, y2 = (fo.FQ.to_mont_tensor([q[i] for q in qts], "cpu") for i in (0, 1))
    a = torch.stack(list(P), 1).contiguous()
    out = torch.empty_like(a)
    lib.h2a_host_jac_add_mixed(_ptr(a), _ptr(x2), _ptr(y2), _ptr(out), len(pts))
    got = co.jac_to_ints(co.JacPoint(out[:, 0], out[:, 1], out[:, 2]))
    assert got == co.jac_to_ints(co.jac_add_mixed(P, x2, y2))
    assert got == [oc.g1_add(p, q) for p, q in zip(pts, qts)]


def _host_ladder(lib, pts, ks, nbits):
    """K8's lane on every lane -> affine ints; also the plain version's."""
    P = _points(pts)
    s = ints_to_tensor(ks, "cpu")
    out = co.JacPoint(*(torch.empty_like(c) for c in P))
    lib.h2a_host_ec_ladder(*(_ptr(c) for c in P), _ptr(s), _ptr(GLV), *(_ptr(c) for c in out), len(pts), nbits)
    return co.jac_to_ints(out), co.jac_to_ints(co.scalar_mul_ladder(P, s, nbits))


@pytest.mark.parametrize("nbits", [254, 256])
def test_ladder_lane(lib, nbits):
    pts = _rand_points(5) + [None, oc.g1_generator()]
    ks = [int.from_bytes(RNG.bytes(32), "little") % R for _ in range(4)] + [R - 1, 7, 0]
    if nbits == 256:
        ks[0] = (1 << 256) - 1
    got, plain = _host_ladder(lib, pts, ks, nbits)
    assert got == plain
    assert got == [oc.g1_mul(p, k) if p else None for p, k in zip(pts, ks)]


def _signed_halves(rng, want):
    """A scalar below r whose split (`glv_split`) has halves of the signs
    `want` ((s1 < 0, s2 < 0)), drawn from `rng`."""
    while True:
        k = int.from_bytes(rng.bytes(32), "little") % R
        s1, s2 = glv_split(k)
        if (s1 < 0, s2 < 0) == want:
            return k


@pytest.mark.parametrize("nbits", [130, 256])
def test_ladder_joint_rounds(lib, nbits):
    """The joint double-and-add over the halves of the split on the scalars
    its design adds: r and r + 1 (reduced to 0 and 1), scalars with bits
    above nbits (masked off), and halves of the signs the split gives (s1 <
    0 and s2 < 0, s1 >= 0 > s2, s2 == 0); each equal to the plain bit-serial
    version and to `oracle.curve.g1_mul` of the masked scalar."""
    rng = np.random.default_rng(0x1AD + nbits)
    ks = [R, R + 1, (1 << 256) - 1, (1 << 256) - (1 << 129) + 5, (1 << 256) - (1 << nbits) | 3, 12345]
    ks += [_signed_halves(rng, (a, True)) for a in (False, True)]
    pts = _rand_points(len(ks))
    got, plain = _host_ladder(lib, pts, ks, nbits)
    masked = [k % (1 << nbits) for k in ks]
    assert masked[4] == 3 and (masked[3] != ks[3]) == (nbits < 256) and glv_split(12345) == (12345, 0)
    assert got == plain
    assert got == [oc.g1_mul(p, k % R) for p, k in zip(pts, masked)]
    if nbits == 256:
        assert got[0] is None and got[1] == pts[1]


def _round_branches(s1, s2):
    """Where the rounds on the halves (s1, s2) meet the accumulator's own
    addend (doubling) or its negation (identity): [(kind, bit)], from the
    halves' bits as the lane runs them (ec_ladder.cuh::ec_ladder_rounds)."""
    g1, g2 = (1 if s1 >= 0 else -1), (1 if s2 >= 0 else -1)
    m1, m2 = abs(s1), abs(s2)
    out = []
    for j in range(max(m1.bit_length(), m2.bit_length()) - 2, -1, -1):
        acc = 2 * (g1 * (m1 >> j + 1) + g2 * glv.LAMBDA * (m2 >> j + 1)) % R
        add = (g1 * (m1 >> j & 1) + g2 * glv.LAMBDA * (m2 >> j & 1)) % R
        if add and acc == add:
            out.append(("doubling", j))
        if add and acc and (acc + add) % R == 0:
            out.append(("identity", j))
    return out


def test_ladder_rounds_branches(lib):
    """K8's rounds on chosen halves, against `oracle.curve.g1_mul` and the
    plain bit-serial ladder of s1 + s2 lambda.  The kernel's own split never
    meets these branches on points of the curve (G1 has prime order): halves
    (s1, s2) whose last add finds the accumulator equal to its addend are
    v + (2, 0) for the lattice vector v = (a1, b1) of the split, and the
    split of s = 2 is (2, 0).  So they are forced here: v + (2, 0) doubles in
    the last add, v and 2 v + (1, 0) meet the addend's negation (the
    identity, then doubled and added to), and halves of both signs and of
    unequal lengths run the generic rounds."""
    (a1, b1), (a2, b2) = glv._V1, glv._V2
    halves = [(a1 + 2, b1), (a1, b1), (2 * a1 + 1, 2 * b1), (-a2 - 2, -b2), (5, -(1 << 100) - 7),
              (-(1 << 129) + 1, 3), (0, 1), (1, 0)]
    kinds = [_round_branches(*h) for h in halves]
    assert kinds[0] == [("doubling", 0)] and kinds[1] == [("identity", 0)] and ("identity", 1) in kinds[2]
    assert glv_split(2) == (2, 0)
    pts = _rand_points(len(halves))
    P = _points(pts)
    mags = ints_to_tensor([abs(h) for pair in halves for h in pair], "cpu")
    negs = torch.tensor([[h < 0 for h in pair] for pair in halves], dtype=torch.int32)
    out = co.JacPoint(*(torch.empty_like(c) for c in P))
    lib.h2a_host_ec_ladder_rounds(*(_ptr(c) for c in P), _ptr(mags), _ptr(negs), _ptr(GLV[6].contiguous()),
                                  *(_ptr(c) for c in out), len(pts))
    got = co.jac_to_ints(out)
    ks = [(s1 + s2 * glv.LAMBDA) % R for s1, s2 in halves]
    assert got == [oc.g1_mul(p, k) for p, k in zip(pts, ks)]
    assert got == co.jac_to_ints(co.scalar_mul_ladder(P, ints_to_tensor(ks, "cpu"), 256))
    assert got[1] is None and got[0] == oc.g1_mul(pts[0], 2)


def _msm_lanes(n, zero_rows=()):
    """n points and scalars for K7's / K9's per-thread code: adjacent rows
    0..3 share a chunk and one scalar: P, -P (the identity branch: sorted by
    digit they meet back to back), P into the emptied bucket sum, P again
    (the doubling branch); an infinity point with its scalar zeroed, as
    `msm` zeroes it; r - 1; and zero scalars on `zero_rows`."""
    pts = _rand_points(n)
    ks = [int.from_bytes(RNG.bytes(32), "little") % R for _ in range(n)]
    for i, p in ((1, oc.g1_neg(pts[0])), (2, pts[0]), (3, pts[0])):
        pts[i], ks[i] = p, ks[0]
    pts[4], ks[4] = None, 0
    ks[5] = R - 1
    for i in zero_rows:
        ks[i] = 0
    return pts, ks


def _host_partials(lib, signed, A, digits, n, C):
    from halo2_aggregation_tpu_torch.ops import msm as m

    n_win = digits.shape[0]
    order = torch.zeros((n_win, n), dtype=torch.int16)
    bsums = torch.zeros((n_win, C, m.BUCKETS[signed], 3, 8), dtype=torch.int32)
    parts = torch.empty((n_win, C, 3, 8), dtype=torch.int32)
    lib.h2a_host_msm_partials(
        int(signed), _ptr(A.x), _ptr(A.y), _ptr(digits), n, C,
        _ptr(order), _ptr(bsums), _ptr(parts),
    )
    return co.jac_to_ints(co.JacPoint(*(parts[:, :, i].reshape(-1, 8) for i in range(3))))


@pytest.mark.parametrize("signed", [True, False], ids=["k7_signed", "k9_unsigned"])
def test_msm_bucket_pass_fold_and_horner(lib, signed):
    """K7's / K9's per-thread sort, walk and fold for every (window, chunk)
    at 3 contiguous chunks over 40 points (a ragged last chunk of 12),
    against the plain version's at the same chunking; then the Horner over
    the plain window sums.  The lanes meet the identity and doubling
    branches of the adds on adjacent rows of one chunk."""
    from halo2_aggregation_tpu_torch.ops import msm as m

    n, C = 40, 3
    pts, ks = _msm_lanes(n)
    A = co.affine_from_ints(pts, "cpu")
    s = ints_to_tensor(ks, "cpu")
    digits = (m.signed_windows(s) if signed else m.unsigned_windows(s)).contiguous()
    want = m.bucket_partials_plain(A.x, A.y, digits, signed, C)
    assert _host_partials(lib, signed, A, digits, n, C) == co.jac_to_ints(
        co.JacPoint(*(c.reshape(-1, 8) for c in want))
    )
    wsum = co.jac_sum(co.JacPoint(*(c.transpose(0, 1) for c in want)))
    ws = torch.stack(list(wsum), 1).contiguous()
    out = torch.empty((3, 8), dtype=torch.int32)
    lib.h2a_host_msm_horner(int(signed), _ptr(ws), _ptr(out))
    got = co.jac_to_ints(co.JacPoint(out[0:1], out[1:2], out[2:3]))[0]
    assert got == co.jac_to_ints(co.JacPoint(*(c[None] for c in m.combine_plain(want, signed))))[0]
    assert got == oc.g1_msm(pts, ks)


@pytest.mark.parametrize("case", ["ragged_last_chunk", "all_zero_chunk", "empty_buckets", "one_chunk", "chunk_of_one"])
@pytest.mark.parametrize("signed", [True, False], ids=["k7_signed", "k9_unsigned"])
def test_msm_chunk_cases(lib, signed, case):
    """`msm.cuh::msm_chunk` (sort, walk, fold) against the plain version, chunk
    by chunk, where trouble is likely: a ragged last chunk, a chunk whose
    every digit is zero, chunks so short that most buckets stay empty, one
    chunk for all points, and chunks of a single point."""
    from halo2_aggregation_tpu_torch.ops import msm as m

    n, C, zero_rows = {
        "ragged_last_chunk": (29, 4, ()),       # L = 8: chunks of 8, 8, 8, 5
        "all_zero_chunk": (32, 4, range(8, 16)),
        "empty_buckets": (24, 6, ()),           # 4 points a chunk, 15 or 16 buckets
        "one_chunk": (24, 1, ()),
        "chunk_of_one": (8, 8, ()),
    }[case]
    pts, ks = _msm_lanes(n, zero_rows)
    A = co.affine_from_ints(pts, "cpu")
    s = ints_to_tensor(ks, "cpu")
    digits = (m.signed_windows(s) if signed else m.unsigned_windows(s)).contiguous()
    want = m.bucket_partials_plain(A.x, A.y, digits, signed, C)
    got = _host_partials(lib, signed, A, digits, n, C)
    assert got == co.jac_to_ints(co.JacPoint(*(c.reshape(-1, 8) for c in want)))
    if case == "all_zero_chunk":
        n_win = digits.shape[0]
        assert all(got[w * C + 1] is None for w in range(n_win))


@pytest.mark.parametrize("signed", [True, False], ids=["k7_signed", "k9_unsigned"])
def test_msm_sort_matches_numpy_argsort(lib, signed):
    """The counting sort of every chunk of one window's digits (`order` and
    the buckets' ends) against a stable numpy argsort by magnitude; the
    sign rides in bit 15.  5 chunks over 203 random digits: a ragged last
    chunk of 39."""
    n, C = 203, 5
    L = -(-n // C)
    nb = 16 if signed else 15
    mag = RNG.integers(0, nb + 1, size=n).astype(np.uint8)
    mag[41 : 41 + L // 2] = 0
    neg = RNG.integers(0, 2, size=n).astype(np.uint8) if signed else np.zeros(n, np.uint8)
    dig = torch.from_numpy((mag | (neg << 5)).astype(np.uint8))
    for c in range(C):
        lo, hi = c * L, min(n, (c + 1) * L)
        order = torch.zeros(L, dtype=torch.int16)
        ends = torch.zeros(nb + 1, dtype=torch.int32)
        total = lib.h2a_host_msm_sort(int(signed), _ptr(dig), n, c, C, _ptr(order), _ptr(ends))
        m_c, neg_c = mag[lo:hi], neg[lo:hi]
        idx = np.argsort(m_c, kind="stable")
        idx = idx[m_c[idx] > 0]
        assert total == len(idx)
        got = order.numpy().view(np.uint16)[:total]
        assert np.array_equal(got & 0x7FFF, idx)
        assert np.array_equal(got >> 15, neg_c[idx])
        assert np.array_equal(ends.numpy(), np.cumsum(np.bincount(m_c, minlength=nb + 1) * (np.arange(nb + 1) > 0)))
    # 4 chunks of 3 over 9 digits: the fourth starts past the end, nothing to sort
    assert lib.h2a_host_msm_sort(int(signed), _ptr(dig), 9, 3, 4, _ptr(order), _ptr(ends)) == 0
