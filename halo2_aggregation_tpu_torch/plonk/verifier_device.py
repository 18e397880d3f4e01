"""The batched verifier on a CUDA device: B proofs folded into one accumulator.

Counterpart of `halo2_aggregation_tpu/plonk/verifier_tpu.py`'s production
path (`verify_batch(aggregate=True)` -> `verify_algebra_fast`):

1. host: `commit_instance` commits each instance column over its nonzero
   rows, `parse_batch` decompresses every proof point of the batch in one
   native call and replays each transcript through `parse_proof`
   (`plonk/verifier.py`), then `batch_proofs` and `fast_prep_gathered`
   build the batch;
2. device: `fast_device_gathered` -> `fast_device`: the fused field algebra
   (kernel K2) gives h_eval and the e-lane's scalar, one batched scalar-mul
   runs over all B x (M + 1) multiopen lanes including the e-lane (kernel
   K1, the windowed ladder, or with `method="ladder"` kernel K8, one joint
   double-and-add over the same split), and one segmented sum (`csrc/jac_sum.cu`) gives each
   proof's quad (e, f, w, zw);
3. host: `check_aggregate` folds all quads into one pairing.

The other formulations of the JAX module: `field_algebra`, the unfused
field algebra (`plonk/protocol.py`'s formulas over `TorchLimbOps`, not
through the tape), which K2's tape is held to and `parallel/` shards;
`verify_algebra`, the sequential H fold and GWC fold in the reference's
order, every scalar-mul through `ops/ec_kernels.py::scalar_mul` (K1 on the
card), which `verify_batch(..., fast=False)` runs; and `fast_prep`, the lane
points as coordinates with each component padded to a multiple of
`lane_pad`, which both mesh formulations of `parallel/batch_verify.py` take.

`_multiopen_coefficients`, `synthetic_batch` and
`aggregate_quads` / `check_aggregate` are copies of the JAX module's host
code: that module imports jax, so the port cannot import them.
"""

from __future__ import annotations

import bisect
import time
from dataclasses import dataclass
from functools import partial
from typing import List

import numpy as np
import torch

from ..device import resolve_device
from ..fields import G1_GEN, R
from ..ops import curve_ops as co, field_ops as fo
from ..ops.curve_ops import JacPoint
from ..ops.ec_kernels import jac_segment_sum, scalar_mul
from ..ops.limbs import ints_to_np
from ..oracle import curve as oc
from ..oracle.pairing import multi_pairing_check_fast
from ..utils import native
from ..utils.decompress import BadPoint, g1_decompress_batch
from ..utils.serialization import g1_compress
from ..utils.transcript import Blake2bRead
from ..utils.u64 import ints_to_u64
from .fa_fused import fa_gather, fa_program, fa_schedule, field_algebra_fused
from . import kzg
from .keygen import VerifyingKey
from .protocol import LookupEvals, PermutationSetEvals, query_schedule, rotation_sets
from .protocol_ops import TorchLimbOps
from .verifier import ParsedProof, num_perm_chunks, parse_proof

FR = fo.FR
QUAD_NAMES = ("e", "f", "w", "zw")


def _points(pts, device) -> JacPoint:
    """(B,) oracle points -> JacPoint of (B, 8) Montgomery Fq."""
    return co.affine_to_jac(co.affine_from_ints(pts, device))


@dataclass
class VerifierBatch:
    """Batched device inputs for B proofs under one vk: scalars are (B, 8)
    Montgomery Fr tensors, points JacPoints of (B, 8) Montgomery Fq."""

    theta: torch.Tensor
    beta: torch.Tensor
    gamma: torch.Tensor
    y: torch.Tensor
    x: torch.Tensor
    v: torch.Tensor
    u: torch.Tensor
    inst_evals: list
    adv_evals: list
    fix_evals: list
    r_eval: torch.Tensor
    sigma_evals: list
    perm_sets: list  # of PermutationSetEvals with (B, 8) leaves
    lookup_evs: list  # of LookupEvals with (B, 8) leaves
    inst_comms: list
    adv_comms: list
    lookups_permuted: list  # (A', S') pairs
    perm_z_comms: list
    lookup_z_comms: list
    r_comm: JacPoint
    h_comms: list
    w_comms: list


def batch_proofs(vk: VerifyingKey, parsed: List[ParsedProof], device) -> VerifierBatch:
    device = resolve_device(device)
    cs = vk.cs
    num_chunks = num_perm_chunks(cs)

    def S(get):
        return FR.to_mont_tensor([get(p) for p in parsed], device)

    def P(get):
        return _points([get(p) for p in parsed], device)

    perm_sets = [
        PermutationSetEvals(
            z=S(lambda p, ci=ci: p.perm_sets[ci].z),
            z_next=S(lambda p, ci=ci: p.perm_sets[ci].z_next),
            z_last=(
                S(lambda p, ci=ci: p.perm_sets[ci].z_last)
                if ci < num_chunks - 1
                else None
            ),
        )
        for ci in range(num_chunks)
    ]
    lookup_evs = [
        LookupEvals(
            z=S(lambda p, li=li: p.lookup_evs[li].z),
            z_next=S(lambda p, li=li: p.lookup_evs[li].z_next),
            a_prime=S(lambda p, li=li: p.lookup_evs[li].a_prime),
            a_prime_prev=S(lambda p, li=li: p.lookup_evs[li].a_prime_prev),
            s_prime=S(lambda p, li=li: p.lookup_evs[li].s_prime),
        )
        for li in range(len(cs.lookups))
    ]
    return VerifierBatch(
        theta=S(lambda p: p.theta),
        beta=S(lambda p: p.beta),
        gamma=S(lambda p: p.gamma),
        y=S(lambda p: p.y),
        x=S(lambda p: p.x),
        v=S(lambda p: p.v),
        u=S(lambda p: p.u),
        inst_evals=[S(lambda p, i=i: p.inst_evals[i]) for i in range(len(cs.instance_queries))],
        adv_evals=[S(lambda p, i=i: p.adv_evals[i]) for i in range(len(cs.advice_queries))],
        fix_evals=[S(lambda p, i=i: p.fix_evals[i]) for i in range(len(cs.fixed_queries))],
        r_eval=S(lambda p: p.r_eval),
        sigma_evals=[
            S(lambda p, i=i: p.sigma_evals[i]) for i in range(len(cs.permutation_columns))
        ],
        perm_sets=perm_sets,
        lookup_evs=lookup_evs,
        inst_comms=[P(lambda p, i=i: p.inst_comms[i]) for i in range(cs.num_instance_columns)],
        adv_comms=[P(lambda p, i=i: p.adv_comms[i]) for i in range(cs.num_advice_columns)],
        lookups_permuted=[
            (
                P(lambda p, i=i: p.lookups_permuted[i][0]),
                P(lambda p, i=i: p.lookups_permuted[i][1]),
            )
            for i in range(len(cs.lookups))
        ],
        perm_z_comms=[P(lambda p, i=i: p.perm_z_comms[i]) for i in range(num_chunks)],
        lookup_z_comms=[P(lambda p, i=i: p.lookup_z_comms[i]) for i in range(len(cs.lookups))],
        r_comm=P(lambda p: p.r_comm),
        h_comms=[P(lambda p, i=i: p.h_comms[i]) for i in range(cs.quotient_poly_degree())],
        w_comms=[P(lambda p, i=i: p.w_comms[i]) for i in range(len(parsed[0].w_comms))],
    )


def _multiopen_coefficients(vk: VerifyingKey, p: ParsedProof):
    """Host-side: expand the GWC folds into explicit linear combinations
    (a copy of `verifier_tpu._multiopen_coefficients`).

    Every output point of the multiopen (w, zw, f) is a linear combination
    of transcript/vk points whose coefficients are products of u/v powers,
    z_i and x^n powers, all host-known after transcript replay.  e is
    -(eval_multi) * G1, where eval_multi splits into a host-known part and
    one h_eval-dependent term.  Lane points are descriptors naming a
    transcript point of the VerifierBatch or a vk constant.

    Returns per-component [(descriptor, scalar)] lane lists plus the
    coefficient of h_eval inside eval_multi."""
    cs = vk.cs
    omega = vk.omega
    omega_inv = pow(omega, -1, R)
    x, u, v = p.x, p.u, p.v
    xn = pow(x, vk.n, R)
    num_chunks = num_perm_chunks(cs)
    sched = query_schedule(cs, num_chunks, len(cs.lookups))

    def resolve(q):
        if q.kind == "instance":
            col, _ = cs.instance_queries[q.index]
            return [(("inst", col.index), 1)], p.inst_evals[q.index]
        if q.kind == "advice":
            col, _ = cs.advice_queries[q.index]
            return [(("adv", col.index), 1)], p.adv_evals[q.index]
        if q.kind == "fixed":
            col, _ = cs.fixed_queries[q.index]
            return [(("fixed", col.index), 1)], p.fix_evals[q.index]
        if q.kind == "perm_z":
            ev = p.perm_sets[q.index]
            return [(("perm_z", q.index), 1)], (ev.z if q.rotation == 0 else ev.z_next)
        if q.kind == "perm_z_last":
            return [(("perm_z", q.index), 1)], p.perm_sets[q.index].z_last
        if q.kind == "lookup_z":
            ev = p.lookup_evs[q.index]
            return [(("lookup_z", q.index), 1)], (ev.z if q.rotation == 0 else ev.z_next)
        if q.kind == "lookup_a":
            ev = p.lookup_evs[q.index]
            return [(("lookup_a", q.index), 1)], (
                ev.a_prime if q.rotation == 0 else ev.a_prime_prev
            )
        if q.kind == "lookup_s":
            return [(("lookup_s", q.index), 1)], p.lookup_evs[q.index].s_prime
        if q.kind == "sigma":
            return [(("sigma", q.index), 1)], p.sigma_evals[q.index]
        if q.kind == "vanishing_h":
            # H = sum_l (x^n)^l h_l  (vanishing.rs:177-188)
            lanes = []
            c = 1
            for l in range(len(p.h_comms)):
                lanes.append((("h", l), c))
                c = c * xn % R
            return lanes, "h_eval"
        if q.kind == "vanishing_r":
            return [(("r", 0), 1)], p.r_eval
        raise KeyError(q.kind)

    by_rot = {}
    for q in sched:
        by_rot.setdefault(q.rotation, []).append(q)
    rots = sorted(by_rot)
    K = len(rots)

    w_lanes, zw_lanes, f_lanes = [], [], []
    eval_known = 0
    h_coeff = 0
    for i, rot in enumerate(rots):
        upow = pow(u, K - 1 - i, R)
        z_i = x * pow(omega, rot, R) % R if rot >= 0 else x * pow(omega_inv, -rot, R) % R
        w_lanes.append((("w", i), upow))
        zw_lanes.append((("w", i), upow * z_i % R))
        qs = by_rot[rot]
        m = len(qs)
        for j, q in enumerate(qs):
            coeff = upow * pow(v, m - 1 - j, R) % R
            lanes, ev = resolve(q)
            for desc, c in lanes:
                f_lanes.append((desc, coeff * c % R))
            if ev == "h_eval":
                h_coeff = (h_coeff + coeff) % R
            else:
                eval_known = (eval_known + coeff * ev) % R

    return {
        "w": w_lanes,
        "zw": zw_lanes,
        "f": f_lanes,
        "eval_known": eval_known,
        "h_coeff": h_coeff,
    }


def fast_prep(vk: VerifyingKey, parsed: List[ParsedProof], device, lane_pad: int = 1,
              batch: VerifierBatch | None = None):
    """Host half of the mesh paths: the GWC folds expanded into one (B, M)
    lane array of (point, scalar) pairs, the lane points as coordinates on
    `device`, gathered out of `batch` (the `VerifierBatch` of `parsed`, built
    here if not given) by `fast_prep_gathered`'s descriptors.  Each component
    (w, zw, f) is padded on the device up to a multiple of `lane_pad` with
    identity points (Z = 0, as the JAX package pads) and zero scalars, so
    that it splits evenly over an `mp` mesh axis: a zero scalar gives the
    identity whatever the point, so a padding lane adds nothing to its
    component's sum.

    Returns (lane_pts, lane_scalars, ms, h_coeff_mont, known_mont):
    `lane_pts` a JacPoint of (B, M, 8) Montgomery Fq, `lane_scalars` (B, M, 8)
    plain limbs, `ms` the padded component sizes (M = sum(ms)), and the two
    (B, 8) Montgomery vectors of the h_eval linearization."""
    if lane_pad < 1:
        raise ValueError(f"lane_pad = {lane_pad}: expected >= 1")
    device = resolve_device(device)
    B = len(parsed)
    b = batch_proofs(vk, parsed, device) if batch is None else batch
    if b.x.shape[0] != B:
        raise ValueError(f"batch holds {b.x.shape[0]} proofs, expected {B}")
    descs, lane_ss, h_coeff_mont, known_mont = fast_prep_gathered(vk, parsed, device)
    identity = JacPoint(*(c.expand(B, 8) for c in _points([None], device)))
    pts, ss, ms = [], [], []
    lo = 0
    for comp in descs:
        pad = (-len(comp)) % lane_pad
        pts += [_desc_point_batch(vk, b, d, B) for d in comp] + [identity] * pad
        ss += [lane_ss[:, lo : lo + len(comp)], lane_ss.new_zeros(B, pad, 8)]
        lo += len(comp)
        ms.append(len(comp) + pad)
    lane_pts = JacPoint(*(torch.stack([p[c] for p in pts], 1) for c in range(3)))
    return lane_pts, torch.cat(ss, 1), tuple(ms), h_coeff_mont, known_mont


def field_algebra(vk: VerifyingKey, b: VerifierBatch, B: int):
    """Steps 20-24 of the verifier (the pure Fr work) in plain torch on the
    batch's device: `plonk/protocol.py`'s formulas evaluated directly over
    `TorchLimbOps` by `fa_program`, not through K2's tape.  Returns
    (h_eval, x^n, x^n - 1) as (B, 8) canonical Montgomery Fr, bit for bit
    the JAX `field_algebra`'s (see `fa_program` on its one inversion)."""
    cols = fa_gather(vk, b)
    if cols[0].shape[0] != B:
        raise ValueError(f"batch holds {cols[0].shape[0]} proofs, expected {B}")
    return fa_program(TorchLimbOps(b.x.device), vk, dict(zip(fa_schedule(vk), cols)))


def _ec_mul_mont(point: JacPoint, scalar_mont) -> JacPoint:
    """Scalar-mul where the scalar arrives in Montgomery form: decode to
    plain limbs, then `ec_kernels.scalar_mul` (K1 on a CUDA tensor, its
    plain version on a CPU one)."""
    return scalar_mul(point, fo.from_mont(scalar_mont, FR))


def verify_algebra(vk: VerifyingKey, b: VerifierBatch, B: int):
    """Steps 20-27 of the verifier for B proofs at once, with the EC folds
    done sequentially in the reference's order: the parity reference of
    `verify_algebra_fast`.  Returns {e, f, w, zw: JacPoint of (B, 8),
    h_eval: (B, 8)} on the batch's device."""
    cs = vk.cs
    omega = vk.omega
    omega_inv = pow(omega, -1, R)
    num_chunks = num_perm_chunks(cs)
    device = b.x.device

    def const(v: int):
        return FR.to_mont_tensor([v] * B, device)

    h_eval, xn, _ = field_algebra(vk, b, B)

    # step 24 (second half): the H fold (vanishing.rs:177-188)
    H = b.h_comms[0]
    xn_power = xn
    for hc in b.h_comms[1:]:
        term = _ec_mul_mont(hc, xn_power)
        xn_power = fo.mont_mul(xn_power, xn, FR)
        H = co.jac_add(H, term)

    # step 25: resolve queries (constant commitments from the vk)
    fixed_comms = [_points([c] * B, device) for c in vk.fixed_commitments]
    sigma_comms = [_points([c] * B, device) for c in vk.sigma_commitments]

    def resolve(q):
        if q.kind == "instance":
            col, _ = cs.instance_queries[q.index]
            return b.inst_comms[col.index], b.inst_evals[q.index]
        if q.kind == "advice":
            col, _ = cs.advice_queries[q.index]
            return b.adv_comms[col.index], b.adv_evals[q.index]
        if q.kind == "fixed":
            col, _ = cs.fixed_queries[q.index]
            return fixed_comms[col.index], b.fix_evals[q.index]
        if q.kind == "perm_z":
            ev = b.perm_sets[q.index]
            return b.perm_z_comms[q.index], (ev.z if q.rotation == 0 else ev.z_next)
        if q.kind == "perm_z_last":
            return b.perm_z_comms[q.index], b.perm_sets[q.index].z_last
        if q.kind == "lookup_z":
            ev = b.lookup_evs[q.index]
            return b.lookup_z_comms[q.index], (ev.z if q.rotation == 0 else ev.z_next)
        if q.kind == "lookup_a":
            ev = b.lookup_evs[q.index]
            return b.lookups_permuted[q.index][0], (ev.a_prime if q.rotation == 0 else ev.a_prime_prev)
        if q.kind == "lookup_s":
            return b.lookups_permuted[q.index][1], b.lookup_evs[q.index].s_prime
        if q.kind == "sigma":
            return sigma_comms[q.index], b.sigma_evals[q.index]
        if q.kind == "vanishing_h":
            return H, h_eval
        if q.kind == "vanishing_r":
            return b.r_comm, b.r_eval
        raise KeyError(q.kind)

    # step 27: GWC multiopen fold (multiopen.rs:271-509)
    by_rot = {}
    for q in query_schedule(cs, num_chunks, len(cs.lookups)):
        by_rot.setdefault(q.rotation, []).append(resolve(q))

    eval_multi = const(0)
    Ws, ZWs, Fs = [], [], []
    for set_i, rot in enumerate(sorted(by_rot)):
        w_exp = pow(omega, rot, R) if rot >= 0 else pow(omega_inv, -rot, R)
        z_pt = fo.mont_mul(b.x, const(w_exp), FR)
        wi = b.w_comms[set_i]
        Ws.append(wi)
        ZWs.append(_ec_mul_mont(wi, z_pt))
        eval_multi = fo.mont_mul(eval_multi, b.u, FR)
        batch_c, batch_e = by_rot[rot][0]
        for comm, ev in by_rot[rot][1:]:
            batch_c = co.jac_add(_ec_mul_mont(batch_c, b.v), comm)
            batch_e = fo.add(fo.mont_mul(batch_e, b.v, FR), ev, FR)
        Fs.append(batch_c)
        eval_multi = fo.add(eval_multi, batch_e, FR)

    def fold_pts(pts):
        acc = pts[0]
        for pt in pts[1:]:
            acc = co.jac_add(_ec_mul_mont(acc, b.u), pt)
        return acc

    g1 = _points([G1_GEN] * B, device)
    return {
        "e": _ec_mul_mont(g1, fo.neg(eval_multi, FR)),
        "f": fold_pts(Fs),
        "w": fold_pts(Ws),
        "zw": fold_pts(ZWs),
        "h_eval": h_eval,
    }


def _desc_point_batch(vk: VerifyingKey, b: VerifierBatch, desc, B: int) -> JacPoint:
    """A lane descriptor -> (B, 8) JacPoint: transcript points come from the
    VerifierBatch; vk constants are converted and broadcast."""
    kind, idx = desc
    if kind in ("fixed", "sigma"):
        pts = vk.fixed_commitments if kind == "fixed" else vk.sigma_commitments
        c = _points([pts[idx]], b.x.device)
        return JacPoint(*(a.expand(B, 8) for a in c))
    if kind in ("lookup_a", "lookup_s"):
        return b.lookups_permuted[idx][0 if kind == "lookup_a" else 1]
    table = {
        "w": b.w_comms,
        "inst": b.inst_comms,
        "adv": b.adv_comms,
        "perm_z": b.perm_z_comms,
        "lookup_z": b.lookup_z_comms,
        "h": b.h_comms,
    }
    if kind == "r":
        return b.r_comm
    if kind not in table:
        raise KeyError(kind)
    return table[kind][idx]


def fast_prep_gathered(vk: VerifyingKey, parsed: List[ParsedProof], device):
    """Host half: the per-lane plain scalars (B, M, 8) and the two (B, 8)
    Montgomery vectors of the h_eval linearization.  Returns
    (descs, lane_scalars, h_coeff_mont, known_mont); `descs` is the
    vk-static per-component lane structure."""
    device = resolve_device(device)
    B = len(parsed)
    coeffs = [_multiopen_coefficients(vk, p) for p in parsed]
    names = ("w", "zw", "f")
    descs = tuple(tuple(d for d, _ in coeffs[0][name]) for name in names)
    flat_ss = [s for c in coeffs for name in names for _, s in c[name]]
    m_tot = sum(len(comp) for comp in descs)
    lane_scalars = torch.from_numpy(ints_to_np(flat_ss).reshape(B, m_tot, 8)).to(device)
    h_coeff_mont = FR.to_mont_tensor([c["h_coeff"] for c in coeffs], device)
    known_mont = FR.to_mont_tensor([c["eval_known"] for c in coeffs], device)
    return descs, lane_scalars, h_coeff_mont, known_mont


def fast_device_gathered(
    vk: VerifyingKey, b: VerifierBatch, B: int, descs: tuple,
    lane_scalars, h_coeff_mont, known_mont, method: str = "win",
):
    """Device half: gather the lane points out of the VerifierBatch, then
    run `fast_device`."""
    ms = tuple(len(comp) for comp in descs)
    pts = [_desc_point_batch(vk, b, d, B) for comp in descs for d in comp]
    lane_pts = JacPoint(*(torch.stack([p[c] for p in pts], 1) for c in range(3)))
    return fast_device(vk, b, B, ms, lane_pts, lane_scalars, h_coeff_mont, known_mont, method)


def with_e_lane(lane_pts: JacPoint, lane_scalars, e_scalar):
    """The (B, M) lanes with the e-lane appended as lane M: G1 with the
    (B, 8) plain scalar `e_scalar`.  Returns (points, scalars) of M + 1
    lanes, contiguous."""
    B = lane_scalars.shape[0]
    g1 = _points([G1_GEN], lane_scalars.device)
    pts = JacPoint(*(torch.cat((lp, g.expand(B, 1, 8)), 1) for lp, g in zip(lane_pts, g1)))
    return pts, torch.cat((lane_scalars, e_scalar[:, None, :]), 1)


def segment_offsets(sizes) -> list:
    """Segment sizes -> the offsets `jac_segment_sum` takes."""
    offsets = [0]
    for m in sizes:
        offsets.append(offsets[-1] + m)
    return offsets


def fast_device(
    vk: VerifyingKey, b: VerifierBatch, B: int, ms: tuple,
    lane_pts: JacPoint, lane_scalars, h_coeff_mont, known_mont, method: str = "win",
):
    """Field algebra for h_eval and the e-lane's scalar (K2), ONE
    scalar-mul (K1, or K8 with `method="ladder"`) over every multiopen lane
    plus the e-lane (e = -(eval_known + h_coeff*h_eval)*G1), then ONE
    segmented sum over each proof's lanes: the components w, zw, f and the
    e-lane alone.  Returns {e, f, w, zw: JacPoint of (B, 8), h_eval: (B, 8)}."""
    h_eval, _, _, e_scalar = field_algebra_fused(vk, b, B, h_coeff_mont, known_mont)
    all_pts, all_scalars = with_e_lane(lane_pts, lane_scalars, e_scalar)
    per_all = scalar_mul(all_pts, all_scalars, method)  # (B, M + 1, 8)
    sums = jac_segment_sum(per_all, segment_offsets((*ms, 1)), lane_axis=1)  # (4, B, 8)
    quads = {name: JacPoint(*(c[j] for c in sums)) for j, name in enumerate(("w", "zw", "f", "e"))}
    quads["h_eval"] = h_eval
    return quads


def verify_algebra_fast(
    vk: VerifyingKey, b: VerifierBatch, parsed: List[ParsedProof], method: str = "win"
):
    """Host prep + device half; the quads stay on the batch's device."""
    descs, lane_scalars, h_coeff_mont, known_mont = fast_prep_gathered(
        vk, parsed, b.x.device
    )
    return fast_device_gathered(
        vk, b, len(parsed), descs, lane_scalars, h_coeff_mont, known_mont, method
    )


def quads_to_ints(out: dict) -> list:
    """Device quads -> per-proof host (e, f, w, zw) affine int tuples, with
    one device-to-host copy."""
    arr = torch.stack([c for name in QUAD_NAMES for c in out[name]]).cpu()
    cols = [co.jac_to_ints(JacPoint(*arr[3 * i : 3 * i + 3])) for i in range(4)]
    return [tuple(col[i] for col in cols) for i in range(len(cols[0]))]


def synthetic_batch(vk: VerifyingKey, B: int, device, seed: int = 0) -> VerifierBatch:
    """A structurally-correct VerifierBatch with random field and point
    values; the same numpy draws in the same order as the JAX
    `synthetic_batch`, so one seed gives the same batch in both."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    cs = vk.cs
    num_chunks = num_perm_chunks(cs)

    def ri():
        return int.from_bytes(rng.bytes(40), "little") % R

    def S():
        return FR.to_mont_tensor([ri() for _ in range(B)], device)

    def P():
        g = oc.g1_generator()
        return _points([oc.g1_mul(g, int(rng.integers(1, 1 << 31))) for _ in range(B)], device)

    perm_sets = [
        PermutationSetEvals(z=S(), z_next=S(), z_last=S() if ci < num_chunks - 1 else None)
        for ci in range(num_chunks)
    ]
    lookup_evs = [
        LookupEvals(z=S(), z_next=S(), a_prime=S(), a_prime_prev=S(), s_prime=S())
        for _ in cs.lookups
    ]
    sched = query_schedule(cs, num_chunks, len(cs.lookups))
    return VerifierBatch(
        theta=S(),
        beta=S(),
        gamma=S(),
        y=S(),
        x=S(),
        v=S(),
        u=S(),
        inst_evals=[S() for _ in cs.instance_queries],
        adv_evals=[S() for _ in cs.advice_queries],
        fix_evals=[S() for _ in cs.fixed_queries],
        r_eval=S(),
        sigma_evals=[S() for _ in cs.permutation_columns],
        perm_sets=perm_sets,
        lookup_evs=lookup_evs,
        inst_comms=[P() for _ in range(cs.num_instance_columns)],
        adv_comms=[P() for _ in range(cs.num_advice_columns)],
        lookups_permuted=[(P(), P()) for _ in cs.lookups],
        perm_z_comms=[P() for _ in range(num_chunks)],
        lookup_z_comms=[P() for _ in cs.lookups],
        r_comm=P(),
        h_comms=[P() for _ in range(cs.quotient_poly_degree())],
        w_comms=[P() for _ in rotation_sets(sched)],
    )


def aggregate_quads(quads, g1, s_g2, g2):
    """Fold N deferred-pairing quads into ONE pairing check (a copy of
    `verifier_tpu.aggregate_quads`).

    Each quad satisfies e(w_i, [tau]_2) == e(zw_i + f_i + e_i, [1]_2); a
    random linear combination with lambda derived by hashing all quads
    (Fiat-Shamir, so the prover cannot bias it) reduces the N checks to
        e(sum l^i w_i, [tau]_2) == e(sum l^i (zw_i+f_i+e_i), [1]_2).
    Returns ((W, RHS), lambda)."""
    import hashlib

    h = hashlib.blake2b(digest_size=64, person=b"H2A-Aggregate---")
    for e, f, w, zw in quads:
        for p in (e, f, w, zw):
            h.update(g1_compress(p))
    lam = int.from_bytes(h.digest(), "little") % R

    lams = []
    lp = 1
    for _ in quads:
        lams.append(lp)
        lp = lp * lam % R
    ws = [w for _, _, w, _ in quads]
    if native.available():
        # RHS = sum_i lam^i (zw_i + f_i + e_i) as ONE 3B-point native MSM
        W = native.g1_msm(ws, lams)
        RHS = native.g1_msm(
            [q[3] for q in quads] + [q[1] for q in quads] + [q[0] for q in quads],
            lams * 3,
        )
    else:
        rhss = [oc.g1_add(oc.g1_add(zw, f), e) for e, f, w, zw in quads]
        W = None
        RHS = None
        for w, rhs, lp_i in zip(ws, rhss, lams):
            W = oc.g1_add(W, oc.g1_mul(w, lp_i))
            RHS = oc.g1_add(RHS, oc.g1_mul(rhs, lp_i))
    return (W, RHS), lam


def check_aggregate(quads, params) -> bool:
    """One pairing for the whole batch (vs one per proof)."""
    (W, RHS), _ = aggregate_quads(quads, params.g1, params.s_g2, params.g2)
    return multi_pairing_check_fast([(W, params.s_g2), (oc.g1_neg(RHS), params.g2)])


class _LayoutRead(Blake2bRead):
    """A transcript over no proof: reads zeros, gives the generator for each
    point and records the point's byte offset, so `parse_proof` run on it
    yields its read order and nothing else."""

    def __init__(self, proof: bytes):
        super().__init__(proof)
        self.points = []

    def _take(self, n: int) -> bytes:
        self.off += n
        return bytes(n)

    def read_point(self):
        self.points.append(self.off)
        self._take(32)
        self.common_point(G1_GEN)
        return G1_GEN


class _BatchRead(Blake2bRead):
    """`Blake2bRead` whose points were decompressed ahead: `read_point` takes
    its 32 bytes as before (so "transcript exhausted" comes where it came),
    then the entry of its slot, raising a refused encoding's ValueError."""

    def __init__(self, slots: dict, points: list, proof: bytes):
        super().__init__(proof)
        self.slots, self.points = slots, points

    def read_point(self):
        off = self.off
        self._take(32)
        i = self.slots.get(off)
        if i is None or i >= len(self.points):
            raise RuntimeError(f"a point read at byte {off}, outside the vk's point layout")
        p = self.points[i]
        if isinstance(p, BadPoint):
            raise ValueError(p.message)
        self.common_point(p)
        return p


def point_layout(vk: VerifyingKey) -> tuple:
    """The byte offsets of the points `parse_proof` reads, ascending: they
    depend on the constraint system alone and are found by `parse_proof`
    itself on a transcript that records them (one replay over no bytes and
    no decompression, so a batch finds them anew rather than caching)."""
    t = _LayoutRead(b"")
    parse_proof(vk, [], b"", transcript_cls=lambda _: t)
    return tuple(t.points)


def parse_batch(vk: VerifyingKey, inst_comms_list, proofs) -> List[ParsedProof]:
    """`[parse_proof(vk, c, p) for c, p in zip(inst_comms_list, proofs)]`,
    with the same first error, but every point of every proof decompressed
    in one `g1_decompress_batch` call before the replays. A slot is taken
    only where it lies wholly inside its proof; past that, the replay's
    read raises "transcript exhausted" as before."""
    pairs = list(zip(inst_comms_list, proofs))
    layout = point_layout(vk)
    ends = [off + 32 for off in layout]
    chunks, counts = [], []
    for _, proof in pairs:
        c = bisect.bisect_right(ends, len(proof))
        chunks.extend(proof[off : off + 32] for off in layout[:c])
        counts.append(c)
    points = g1_decompress_batch(np.frombuffer(b"".join(chunks), dtype="<u8").reshape(-1, 4))
    slots = {off: i for i, off in enumerate(layout)}
    parsed, start = [], 0
    for (comms, proof), c in zip(pairs, counts):
        parsed.append(parse_proof(vk, comms, proof, partial(_BatchRead, slots, points[start : start + c])))
        start += c
    return parsed


def commit_instance(params, col, usable_rows: int):
    """`params.commit_lagrange(col)` over the column's nonzero rows only (the
    values taken mod R as it takes them): an instance column has a few
    nonzero rows in n. A column longer than `usable_rows` raises
    `verify_proof`'s "instance too large"; the zero column is the identity.
    The sparse sum reads a plain `kzg.Params`' Lagrange points; a `Params`
    that overrides `commit_lagrange` is answered by its own method."""
    vals = [int(v) % R for v in col]
    if len(vals) > usable_rows:
        raise ValueError("instance too large")
    rows = [i for i, v in enumerate(vals) if v]
    if not rows:
        return None
    if not native.available() or type(params).commit_lagrange is not kzg.Params.commit_lagrange:
        return params.commit_lagrange(vals)
    return native.g1_msm_u64(params.g_lagrange_u64[rows], params.g_lagrange_inf[rows],
                             ints_to_u64([vals[i] for i in rows]))


def verify_batch(
    params,
    vk: VerifyingKey,
    instances_list,
    proofs: List[bytes],
    *,
    device="cuda",
    aggregate: bool = True,
    timings: dict | None = None,
    method: str = "win",
    fast: bool = True,
):
    """Full batched verification: host instance commitments and transcript
    replay (`commit_instance` for every column, which refuses a column past
    the usable rows as `verify_proof` does, then `parse_batch`), device algebra
    (K2, the scalar-mul by `method`, "win" for K1 or "ladder" for K8, and
    the lane sums on `device`), host pairing.  With `fast=False` the
    device algebra is the sequential `verify_algebra` (plain field algebra,
    one K1 call a fold step) in place of `verify_algebra_fast`.  With
    aggregate=True, folds all quads into ONE pairing check and returns
    (ok: bool, quads); otherwise ([ok per proof], quads).  `timings`, if
    given, receives the stage split in seconds: parse, prep, device (up to
    the quads on the host) and pairing."""
    device = resolve_device(device)
    t0 = time.perf_counter()
    usable = vk.cs.usable_rows(vk.n)
    inst_comms = [[commit_instance(params, col, usable) for col in insts] for insts in instances_list]
    parsed = parse_batch(vk, inst_comms, proofs)
    t1 = time.perf_counter()
    batch = batch_proofs(vk, parsed, device)
    if fast:
        prep = fast_prep_gathered(vk, parsed, device)
    t2 = time.perf_counter()
    if fast:
        out = fast_device_gathered(vk, batch, len(parsed), *prep, method)
    else:
        out = verify_algebra(vk, batch, len(parsed))
    efws = quads_to_ints(out)
    t3 = time.perf_counter()
    if aggregate:
        result = check_aggregate(efws, params)
    else:
        result = []
        for e, f, w, zw in efws:
            rhs = oc.g1_add(oc.g1_add(zw, f), e)
            result.append(
                multi_pairing_check_fast([(w, params.s_g2), (oc.g1_neg(rhs), params.g2)])
            )
    if timings is not None:
        timings.update(
            parse=t1 - t0, prep=t2 - t1, device=t3 - t2, pairing=time.perf_counter() - t3
        )
    return result, efws
