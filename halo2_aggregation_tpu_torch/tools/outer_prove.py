"""The aggregation product through the port: N inner proofs folded into one
outer proof, proved and verified with the quotient and every commitment on
the card.

    python3 -m halo2_aggregation_tpu_torch.tools.outer_prove [--artifacts-dir DIR] [--tag T] [--expect STEM]

The counterpart of `examples/simple_example.py` with `H2A_PHASE_D=1`, on
the port's own modules.  `config.H2AConfig.from_env()` gives N
(`H2A_NUM_PROOFS`), the outer k (`H2A_OUTER_K`; 21 for one proof, one more
for each doubling of N) and the transcript (`H2A_CONSTRAINED_FS`);
`H2A_WITNESS_OFFSET` picks another window of inner witnesses, as in the
example.

A. N inner proofs at k = 9 (`seed=42 + i`, the Poseidon transcript when
   `constrained_fs`), each accepted by the host `verify_proof`;
B. the outer circuit (`SingleProofCircuit` for N = 1, `AggregationCircuit`
   above) and its public inputs;
C. `ac.build`: the synthesis, with every in-circuit quad (and the fold, for
   N > 1) equal to the host's;
D. `prove_and_save`, which `aggregation/tree.py::prove_node` shares:
   `kzg.setup(k_outer, device=...)`, one `DeviceSRS`, `keygen_device` on
   the witness-bearing assignment of C in place of the example's second,
   blank build (the circuit's fixed columns and copy constraints do not
   depend on the witness; `chip_smoke.py` holds the vk to the artifact's),
   `create_proof_device(..., seed=1)` (`run_outer`'s `seed`) sharing the
   `DeviceSRS`, the host
   `verify_proof`, and, when a directory is given, the artifacts as the
   example writes them (`<dir>/outer_n{N}_k{k}{tag}.proof`, `.vk.npz`,
   `.meta.json`; never into the checked-in `docs/artifacts`).

Everything is seeded, so at N = 1 the proof, vk and quad can be held to
`docs/artifacts/outer_n1_k21.*` (`chip_smoke.py`'s `outer` phase does).
`run_outer(device="cpu")` gets through A-C in about a minute on a CPU; D
then runs every commitment through the plain K7 and takes hours.  The
command prints one JSON line (`result_line`): the host verify's verdict,
whether the in-circuit quads equal the host's, the stage split in seconds
and the SHA-256 of the proof; then the card's name and power limit, the peak
device memory and the process's peak RSS.  `--expect STEM` holds the proof,
the vk and the meta's public inputs, quad and instance commitment to a
checked-in stem (`expect_checks`) and exits 1 on any difference; e.g.
`H2A_NUM_PROOFS=4 ... outer_prove --expect docs/artifacts/outer_n4_k23`.
Every run is also held to what needs no artifact (`run_checks`): the
inner proofs verified, the rows within the vk's usable rows, the
in-circuit quads and fold equal to the host's, the outer proof accepted by
the host `verify_proof` and by `verify_batch` on the card at B = 1 and
refused with a byte flipped, and the public inputs' SHA-256 where
`PIS_SHA256` pins it (N = 8 at k = 24, which has no artifact):

    H2A_PARAMS_CACHE=build/h2a-params H2A_NUM_PROOFS=8 python3 -m halo2_aggregation_tpu_torch.tools.outer_prove

The JSON line also gives the RSS and peak RSS after each stage, the
stage that reached the peak and the host's MemTotal; the second line each
kernel's launches.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import os
import resource
import subprocess
import sys
import time

#: distinct inner witnesses (constant=7, a, b) for up to 8 proofs, as in
#: examples/simple_example.py
WITNESSES = [(2, 3), (4, 5), (6, 11), (12, 13), (1, 255), (3, 9), (8, 21), (17, 2)]


def peak_rss_mib() -> float:
    """The process's peak resident set (Linux reports KiB)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024


def rss_mib() -> list:
    """[resident set now, peak so far] of the process in MiB: the resident
    pages of /proc/self/statm and `ru_maxrss`."""
    with open("/proc/self/statm") as f:
        pages = int(f.read().split()[1])
    now = pages * os.sysconf("SC_PAGE_SIZE") / 2**20
    return [now, max(now, peak_rss_mib())]  # ru_maxrss lags the pages a little


def mem_total_mib() -> float:
    """The host's memory: MemTotal of /proc/meminfo (in KiB there)."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemTotal:"):
                return int(line.split()[1]) / 1024
    raise ValueError("no MemTotal in /proc/meminfo")


def peak_rss_stage(rows: list) -> str:
    """The stage of [stage, RSS, peak] rows (in run order) during which the
    process reached its peak: the first row whose peak is the last row's
    (None without rows)."""
    return next((stage for stage, _, peak in rows if peak >= rows[-1][2]), None)


class Stages:
    """[message, seconds since the previous message] for each `progress`
    call in `rows`, and [message, RSS MiB, peak RSS MiB] (`rss_mib`) at
    that call in `memory`; forwarded to `echo` when given."""

    def __init__(self, echo=None):
        self.echo = echo
        self.rows = []
        self.memory = []
        self._last = time.perf_counter()

    def __call__(self, msg: str) -> None:
        now = time.perf_counter()
        self.rows.append([msg, now - self._last])
        self.memory.append([msg, *rss_mib()])
        self._last = now
        if self.echo is not None:
            self.echo(msg)


def inner_proofs(cfg, witness_offset: int = 0) -> dict:
    """Phase A: N inner proofs of the simple example at k_inner, each
    accepted by the host verify_proof.  Returns the inner vk, proofs,
    instance commitments, quads and the host verdicts."""
    from ..models import simple_example as se
    from ..plonk import kzg
    from ..plonk.keygen import keygen
    from ..plonk.prover import create_proof
    from ..plonk.verifier import verify_proof
    from ..utils.transcript import Blake2bRead, Blake2bWrite, PoseidonRead, PoseidonWrite

    N = cfg.num_proofs
    if not (1 <= N and witness_offset + N <= len(WITNESSES)):
        raise ValueError(f"num_proofs {N} + offset {witness_offset} not within [1, {len(WITNESSES)}]")
    t_write = PoseidonWrite if cfg.constrained_fs else Blake2bWrite
    t_read = PoseidonRead if cfg.constrained_fs else Blake2bRead
    k = cfg.k_inner
    params = kzg.setup(k)
    proofs, comms, efws, oks = [], [], [], []
    vk = None
    for i, (a, b) in enumerate(WITNESSES[witness_offset : witness_offset + N]):
        circuit = se.MyCircuit(constant=7, a=a, b=b)
        cs_e, _, asg_e = se.build(circuit.without_witnesses(), k=k)
        vk_i, pk_i = keygen(params, cs_e, asg_e)
        if vk is None:
            vk = vk_i  # all N share one circuit structure, hence one vk
        _, _, asg_i = se.build(circuit, k=k)
        pub_i = [circuit.public_output()]
        proof_i = create_proof(params, pk_i, asg_i, [pub_i], seed=42 + i, transcript_cls=t_write)
        ok_i, efw_i = verify_proof(params, vk, [pub_i], proof_i, transcript_cls=t_read)
        if not ok_i:
            raise AssertionError(f"inner proof {i} rejected by the host verify_proof")
        proofs.append(proof_i)
        comms.append(params.commit_lagrange(pub_i))
        efws.append(tuple(efw_i))
        oks.append(bool(ok_i))
    return {"vk": vk, "proofs": proofs, "inst_comms": comms, "efws": efws, "verified": oks}


def outer_circuit(cfg, inner: dict):
    """Phase B: the outer circuit over the inner proofs, and its public
    inputs."""
    from ..models import aggregation_circuit as ac

    cfs = cfg.constrained_fs
    if cfg.num_proofs == 1:
        outer = ac.SingleProofCircuit(inner["vk"], inner["proofs"][0], constrained_fs=cfs)
        return outer, outer.public_inputs(inner["inst_comms"][0], inner["efws"][0])
    outer = ac.AggregationCircuit(inner["vk"], inner["proofs"], num_proofs=cfg.num_proofs, constrained_fs=cfs)
    return outer, outer.public_inputs(inner["inst_comms"], inner["efws"])


def synthesize(cfg, outer, public_inputs, efws):
    """Phase C: the outer circuit's assignment at k_outer; raises unless
    every in-circuit quad (and, for N > 1, the fold) equals the host's.
    Returns (cs, assignment, rows, the in-circuit quads, the in-circuit
    fold (W, RHS); None for N = 1)."""
    from ..models import aggregation_circuit as ac

    cs, _, asg, ctx, out = ac.build(outer, cfg.k_outer, public_inputs)
    quads, fold = ([out], None) if cfg.num_proofs == 1 else (out[0], (out[1].value(), out[2].value()))
    quads = [(q.e.value(), q.f.value(), q.w.value(), q.zw.value()) for q in quads]
    for i, (q, efw) in enumerate(zip(quads, efws)):
        if q != tuple(efw):
            raise AssertionError(f"in-circuit quad {i} != the host verify_proof's")
    if fold is not None and fold != ac.fold_quads_host(efws, constrained_fs=cfg.constrained_fs):
        raise AssertionError("in-circuit fold != the host's")
    usable = cs.usable_rows(1 << cfg.k_outer)
    if ctx.offset > usable:
        raise ValueError(f"{ctx.offset} rows do not fit k = {cfg.k_outer} ({usable} usable)")
    return cs, asg, ctx.offset, quads, fold


#: the checked-in reference artifacts, which nothing here overwrites
CHECKED_IN = os.path.normpath(os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", "docs", "artifacts"))


def writable_stem(stem: str) -> str:
    """`stem`, unless it lies in the checked-in `docs/artifacts` (the
    references the port's proofs are held to): then a ValueError."""
    if os.path.realpath(os.path.dirname(os.path.abspath(stem))) == os.path.realpath(CHECKED_IN):
        raise ValueError(f"{stem}: refusing to overwrite a checked-in artifact; write under build/")
    return stem


def level1_meta(cfg, witness_offset: int) -> dict:
    """The head of the example's level-1 meta.json."""
    return {"k": cfg.k_outer, "num_proofs": cfg.num_proofs, "witness_offset": witness_offset,
            "constrained_fs": cfg.constrained_fs}


def save_artifacts(stem: str, proof: bytes, vk, meta: dict, public_inputs, efw, inst_comm) -> None:
    """The example's artifacts: proof bytes, vk, and `meta` followed by the
    public inputs, quad and instance commitment."""
    from ..utils.artifacts import save_vk_npz

    writable_stem(stem)
    os.makedirs(os.path.dirname(stem) or ".", exist_ok=True)
    with open(f"{stem}.proof", "wb") as f:
        f.write(proof)
    save_vk_npz(f"{stem}.vk.npz", vk)
    with open(f"{stem}.meta.json", "w") as f:
        json.dump(
            {
                **meta,
                "public_inputs": [str(v) for v in public_inputs],
                "efw": [[str(c) for c in p] for p in efw],
                "inst_comm": [str(c) for c in inst_comm],
            },
            f,
        )


def prove_and_save(cs, asg, public_inputs, k: int, *, seed: int, device="cuda", srs=None, stem=None, meta=None,
                   progress=None, prove_window=None) -> dict:
    """Phase D: `kzg.setup(k, device=...)`, one `DeviceSRS` (`srs` when
    given), `keygen_device` on the witness-bearing assignment `asg` (the
    circuit's fixed columns and copy constraints do not depend on the
    witness, so the example's second, blank synthesis is not needed; the
    callers hold the vk to a checked-in one), `create_proof_device` sharing
    the `DeviceSRS`, the host `verify_proof`, and, when `stem` is given and
    the proof verifies, the artifacts under `stem` with `meta` as the head
    of the meta.json.  `progress` gets a message after each stage;
    `prove_window`, a context manager, is entered around the prove alone
    (`create_proof_device` and its synchronise: a profiler's window).  Returns
    the params, proof, vk, quad, instance commitment, `verified`,
    `seconds`: the split, with keygen's and the prove's `progress` stages as
    [message, seconds] rows, and `rss_mib`: [stage, RSS MiB, peak RSS MiB]
    rows in run order (`rss_mib()` after the setup, the upload, each of
    keygen's and the prove's stages, and the verify)."""
    import torch

    from ..device import resolve_device
    from ..plonk import kzg
    from ..plonk.keygen_device import keygen_device
    from ..plonk.kzg import DeviceSRS
    from ..plonk.prover_device import create_proof_device
    from ..plonk.verifier import verify_proof

    device = resolve_device(device)
    if stem is not None:
        writable_stem(stem)
    log = progress or (lambda *_: None)
    seconds = {}

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    t0 = time.perf_counter()
    params = kzg.setup(k, device=device)
    seconds["setup"] = time.perf_counter() - t0
    rss = [["setup", *rss_mib()]]
    t0 = time.perf_counter()
    if srs is None:
        srs = DeviceSRS(params, device)
    elif srs.device != device or srs.n != params.n:
        raise ValueError(f"srs of {srs.n} points on {srs.device}, expected {params.n} on {device}")
    sync()
    seconds["srs_upload"] = time.perf_counter() - t0
    rss.append(["srs_upload", *rss_mib()])
    log(f"SRS at k = {k} ready")

    keygen_stages = Stages(log)
    t0 = time.perf_counter()
    vk, pk = keygen_device(params, cs, asg, device=device, srs=srs, progress=keygen_stages)
    sync()
    seconds["keygen"] = time.perf_counter() - t0
    seconds["keygen_stages"] = keygen_stages.rows
    rss += [[f"keygen: {m}", *r] for m, *r in keygen_stages.memory]
    log("keygen done")

    prove_stages = Stages(log)
    t0 = time.perf_counter()
    with prove_window if prove_window is not None else contextlib.nullcontext():
        proof = create_proof_device(params, pk, asg, [public_inputs], seed=seed, progress=prove_stages,
                                    device=device, srs=srs)
        sync()
    seconds["prove"] = time.perf_counter() - t0
    seconds["prove_stages"] = prove_stages.rows
    rss += [[f"prove: {m}", *r] for m, *r in prove_stages.memory]
    del pk

    t0 = time.perf_counter()
    ok, efw = verify_proof(params, vk, [public_inputs], proof)
    seconds["verify"] = time.perf_counter() - t0
    rss.append(["verify", *rss_mib()])
    inst_comm = srs.commit_lagrange(public_inputs)
    efw = tuple(efw) if efw is not None else None
    log(f"proof of {len(proof)} bytes {'valid' if ok else 'REJECTED'}")
    if stem is not None and ok:
        save_artifacts(stem, proof, vk, meta or {}, public_inputs, efw, inst_comm)
        log(f"artifacts saved at {stem}.*")
    return {"params": params, "proof": proof, "vk": vk, "efw": efw, "inst_comm": inst_comm, "verified": bool(ok),
            "seconds": seconds, "rss_mib": rss}


def run_outer(
    cfg=None,
    *,
    device="cuda",
    artifacts_dir=None,
    tag: str = "",
    witness_offset: int = 0,
    progress=None,
    srs=None,
    seed: int = 1,
    prove_window=None,
) -> dict:
    """Phases A-D on `device` ("cpu" runs the kernels' plain versions).
    `srs` is a `DeviceSRS` of the outer SRS on `device` to share (made here
    when None); `seed` is the outer prove's (1 made `docs/artifacts/
    outer_n1_k21.proof`); `prove_window` is `prove_and_save`'s.  Returns the public inputs, the inner quads (the host
    verifier's) and the in-circuit ones, the synthesis' rows, the outer
    params, proof, vk, quad and instance commitment, `verified` (the host
    `verify_proof`), the artifacts' stem (None unless written), and
    `seconds`: the stage split, with keygen's and the prove's `progress`
    stages as [message, seconds] rows, and `rss_mib`: [stage, RSS MiB,
    peak RSS MiB] rows in run order, from the inner proofs and the
    synthesis on (`prove_and_save`'s after them).  Also the host verdicts
    of the inner proofs (`inner_verified`), for N > 1 the in-circuit fold
    (W, RHS) as `in_circuit_fold` (None for N = 1), and the synthesis'
    assignment (`assignment`)."""
    from ..config import H2AConfig
    from ..device import resolve_device

    device = resolve_device(device)
    cfg = cfg or H2AConfig.from_env()
    log = progress or (lambda *_: None)
    stem = None
    if artifacts_dir:
        stem = writable_stem(os.path.join(artifacts_dir, f"outer_n{cfg.num_proofs}_k{cfg.k_outer}{tag}"))
    seconds = {}

    t0 = time.perf_counter()
    inner = inner_proofs(cfg, witness_offset)
    outer, public_inputs = outer_circuit(cfg, inner)
    seconds["inner_proofs"] = time.perf_counter() - t0
    rss = [["inner_proofs", *rss_mib()]]
    log(f"{cfg.num_proofs} inner proof(s) valid; {len(public_inputs)} outer public inputs")

    t0 = time.perf_counter()
    cs, asg, rows, in_circuit_quads, fold = synthesize(cfg, outer, public_inputs, inner["efws"])
    seconds["synthesis"] = time.perf_counter() - t0
    rss.append(["synthesis", *rss_mib()])
    log(f"synthesized {rows} rows at k = {cfg.k_outer}; quads equal the host's")

    res = prove_and_save(cs, asg, public_inputs, cfg.k_outer, seed=seed, device=device, srs=srs, stem=stem,
                         meta=level1_meta(cfg, witness_offset), progress=log, prove_window=prove_window)
    seconds.update(res.pop("seconds"))
    rss += res.pop("rss_mib")
    return {
        "num_proofs": cfg.num_proofs, "k_outer": cfg.k_outer, "constrained_fs": cfg.constrained_fs,
        "witness_offset": witness_offset, "rows": rows, "public_inputs": public_inputs,
        "inner_quads": inner["efws"], "inner_verified": inner["verified"],
        "in_circuit_quads": in_circuit_quads, "in_circuit_fold": fold, **res,
        "artifact_stem": stem if res["verified"] else None, "seconds": seconds,
        "rss_mib": rss, "assignment": asg,
    }


def result_line(res: dict) -> dict:
    """The command's JSON line from `run_outer`'s result: beside `seconds`,
    the [stage, RSS MiB, peak RSS MiB] rows, the stage that reached the
    peak and the host's MemTotal."""
    return {
        "num_proofs": res["num_proofs"], "k_outer": res["k_outer"], "rows": res["rows"],
        "proof_bytes": len(res["proof"]), "proof_sha256": hashlib.sha256(res["proof"]).hexdigest(),
        "vk_hash": str(res["vk"].hash_scalar()), "pis_sha256": pis_sha256(res["public_inputs"]),
        "verified": res["verified"],
        "in_circuit_quads_equal_host": res["in_circuit_quads"] == res["inner_quads"],
        "artifact_stem": res["artifact_stem"], "seconds": res["seconds"],
        "rss_mib": res["rss_mib"], "peak_rss_stage": peak_rss_stage(res["rss_mib"]),
        "host_mem_total_mib": mem_total_mib(),
    }


#: SHA-256 (`pis_sha256`) of the outer public inputs at (N, witness
#: offset, constrained_fs) where no checked-in artifact holds them: the JAX
#: package's `AggregationCircuit.public_inputs` over its own inner proofs
#: (tests/test_torch_aggregation.py holds both packages to it)
PIS_SHA256 = {
    (8, 0, True): "df62a6f8655934de8bb7841f53166719dd3e6743bf62ec8c3eb0aa3a4a0c8bba",
    # the recursion tree's two leaves beside outer_n2_k22{,b} (tools/tree_prove.py)
    (2, 4, True): "0f4489f914045d91401ada528e73b053835aa1f75c00bf7d8d2f2673f4c1106f",
    (2, 6, True): "406bf863d896254e6471534d41eb8aebaa3dcf394ab7c5f612b880e6ec4831b7",
}


def pis_sha256(public_inputs) -> str:
    """SHA-256 of the public inputs, each as 32 big-endian bytes."""
    return hashlib.sha256(b"".join(int(v).to_bytes(32, "big") for v in public_inputs)).hexdigest()


def verify_on_device(params, vk, pis: list, proofs: list, efws: list, device) -> tuple:
    """`verify_batch(aggregate=True)` on `device` over `proofs` (each with
    its public inputs).  Returns (accepted with quads equal to `efws`, the
    timings)."""
    import torch

    from ..plonk.verifier_device import verify_batch

    t = {}
    t1 = time.perf_counter()
    ok, quads = verify_batch(params, vk, [[p] for p in pis], proofs, device=device, aggregate=True, timings=t)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    t["wall"] = time.perf_counter() - t1
    return ok is True and [tuple(map(tuple, q)) for q in quads] == list(efws), t


def flipped_byte_verdict(params, vk, pis: list, proofs: list, device):
    """The batch with one evaluation's byte of the first proof flipped (the
    transcript still parses) through `verify_batch(aggregate=True)` on
    `device`: how it was rejected, or None when it was accepted."""
    from ..plonk.verifier_device import verify_batch

    bad = bytearray(proofs[0])
    bad[len(bad) - 64 * 5] ^= 1
    try:
        ok_bad, _ = verify_batch(params, vk, [[p] for p in pis], [bytes(bad), *proofs[1:]], device=device,
                                 aggregate=True)
        return "check_failed" if ok_bad is False else None
    except ValueError as e:
        return f"parse_raised: {e}"


def run_checks(res: dict, device="cuda") -> dict:
    """What a run can be held to without an artifact, one boolean each: the
    N inner proofs accepted by the host `verify_proof`, the rows within the
    outer vk's usable rows, the in-circuit quads (and, for N > 1, the fold)
    equal to the host's, the outer proof accepted by the host
    `verify_proof`, and by `verify_batch` on `device` at B = 1 and refused
    with one byte flipped; and, where `PIS_SHA256` pins them, the public
    inputs' SHA-256."""
    from ..models.aggregation_circuit import fold_quads_host

    n = res["num_proofs"]
    checks = {
        "inner_proofs_verified": len(res["inner_verified"]) == n and all(res["inner_verified"]),
        "rows_fit": res["rows"] <= res["vk"].cs.usable_rows(res["vk"].n),
        "in_circuit_quads_equal_host": res["in_circuit_quads"] == res["inner_quads"],
    }
    if n > 1:
        checks["fold_equal_to_host"] = res["in_circuit_fold"] == fold_quads_host(
            res["inner_quads"], constrained_fs=res["constrained_fs"])
    checks["verified"] = res["verified"]
    args = (res["params"], res["vk"], [res["public_inputs"]], [res["proof"]])
    checks["verify_batch_b1_accepts"], _ = verify_on_device(*args, [res["efw"]], device)
    checks["flipped_byte_rejected"] = flipped_byte_verdict(*args, device) is not None
    pinned = PIS_SHA256.get((n, res["witness_offset"], res["constrained_fs"]))
    if pinned is not None:
        checks["pis_sha256_equal_to_pinned"] = pis_sha256(res["public_inputs"]) == pinned
    return checks


def expect_checks(res: dict, stem: str) -> dict:
    """`run_outer`'s (or `prove_and_save`'s) proof, vk, public inputs, quad
    and instance commitment against the artifact at `stem`: one boolean
    each.  Of the meta only those three keys (a level-1 meta may lack
    `witness_offset`)."""
    from ..utils.artifacts import load_vk

    with open(f"{stem}.meta.json") as f:
        meta = json.load(f)
    with open(f"{stem}.proof", "rb") as f:
        want_proof = f.read()
    vk, want_vk = res["vk"], load_vk(stem)
    return {
        "pis_equal_to_meta": [int(v) for v in res["public_inputs"]] == [int(v) for v in meta["public_inputs"]],
        "vk_equal_to_artifact": (vk.hash_scalar() == want_vk.hash_scalar()
                                 and vk.fixed_commitments == want_vk.fixed_commitments
                                 and vk.sigma_commitments == want_vk.sigma_commitments),
        "proof_equal_to_artifact": res["proof"] == want_proof,
        "inst_comm_equal_to_meta": res["inst_comm"] == tuple(int(c) for c in meta["inst_comm"]),
        "efw_equal_to_meta": res["efw"] == tuple(tuple(int(c) for c in p) for p in meta["efw"]),
    }


def kernel_launches() -> dict:
    """Each kernel's launches so far in the process, under the names of
    `chip_smoke.py`'s `kernels` line."""
    from ..ops import ec_kernels as ek
    from ..ops import msm_kernels as mk
    from ..ops import ntt as nt
    from ..plonk.fa_fused import fa_tape_eval
    from ..plonk.quotient_program import quotient_tape_eval

    return {
        "ntt": nt.ntt_batched.launches, "intt": nt.intt_batched.launches,
        "ew": nt.ew_mul_col.launches + nt.ew_mul_scalar.launches + nt.pow_series.launches,
        "quotient_tape": quotient_tape_eval.launches, "msm_s5": mk.msm_bucket_s5.launches,
        "msm_u4": mk.msm_bucket_u4.launches, "ec_win": ek.scalar_mul_win.launches,
        "ec_ladder": ek.scalar_mul_ladder.launches, "fa_tape": fa_tape_eval.launches,
        "jac_segment_sum": ek.jac_segment_sum.launches,
    }


def card_line() -> str:
    """`nvidia-smi`'s name and power limit of the card, or "" without it."""
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True).stdout.strip()
    except OSError:
        return ""


def main(argv=None) -> int:
    import torch

    from ..config import H2AConfig

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--artifacts-dir", default=os.environ.get("H2A_ARTIFACTS_DIR", ""))
    ap.add_argument("--tag", default=os.environ.get("H2A_ARTIFACT_TAG", ""))
    ap.add_argument("--expect", default="", help="a stem to hold the proof, vk and meta to; exit 1 on a difference")
    args = ap.parse_args(argv)
    if args.expect and not os.path.exists(f"{args.expect}.proof"):
        ap.error(f"--expect {args.expect}: no {args.expect}.proof")
    t0 = time.perf_counter()
    res = run_outer(
        H2AConfig.from_env(), artifacts_dir=args.artifacts_dir or None, tag=args.tag,
        witness_offset=int(os.environ.get("H2A_WITNESS_OFFSET", "0")),
        progress=lambda m: print(f"  [{time.perf_counter() - t0:8.1f}s] {m}", flush=True),
    )
    print(json.dumps(result_line(res)), flush=True)
    launches = kernel_launches()
    checks = run_checks(res)
    after = kernel_launches()
    if args.expect:
        checks.update(expect_checks(res, args.expect))
    print(json.dumps({
        "card": card_line(), "expect": args.expect or None, **checks, "wall_s": time.perf_counter() - t0,
        # the run's (its SRS's fixed-base products on K1 too when kzg.setup's cache was cold), then run_checks'
        "launches": launches, "launches_checks": {name: after[name] - launches[name] for name in after},
        "peak_device_mib": torch.cuda.max_memory_allocated() / 2**20 if torch.cuda.is_available() else None,
        "peak_rss_mib": peak_rss_mib(), "host_mem_total_mib": mem_total_mib(),
    }), flush=True)
    return 0 if all(checks.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
