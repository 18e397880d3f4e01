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


class Stages:
    """[message, seconds since the previous message] for each `progress`
    call, forwarded to `echo` when given."""

    def __init__(self, echo=None):
        self.echo = echo
        self.rows = []
        self._last = time.perf_counter()

    def __call__(self, msg: str) -> None:
        now = time.perf_counter()
        self.rows.append([msg, now - self._last])
        self._last = now
        if self.echo is not None:
            self.echo(msg)


def inner_proofs(cfg, witness_offset: int = 0) -> dict:
    """Phase A: N inner proofs of the simple example at k_inner, each
    accepted by the host verify_proof.  Returns the inner vk, proofs,
    instance commitments and quads."""
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
    proofs, comms, efws = [], [], []
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
    return {"vk": vk, "proofs": proofs, "inst_comms": comms, "efws": efws}


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
    the params, proof, vk, quad, instance commitment, `verified`, and
    `seconds`: the split, with keygen's and the prove's `progress` stages as
    [message, seconds] rows."""
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
    t0 = time.perf_counter()
    if srs is None:
        srs = DeviceSRS(params, device)
    elif srs.device != device or srs.n != params.n:
        raise ValueError(f"srs of {srs.n} points on {srs.device}, expected {params.n} on {device}")
    sync()
    seconds["srs_upload"] = time.perf_counter() - t0
    log(f"SRS at k = {k} ready")

    keygen_stages = Stages(log)
    t0 = time.perf_counter()
    vk, pk = keygen_device(params, cs, asg, device=device, srs=srs, progress=keygen_stages)
    sync()
    seconds["keygen"] = time.perf_counter() - t0
    seconds["keygen_stages"] = keygen_stages.rows
    log("keygen done")

    prove_stages = Stages(log)
    t0 = time.perf_counter()
    with prove_window if prove_window is not None else contextlib.nullcontext():
        proof = create_proof_device(params, pk, asg, [public_inputs], seed=seed, progress=prove_stages,
                                    device=device, srs=srs)
        sync()
    seconds["prove"] = time.perf_counter() - t0
    seconds["prove_stages"] = prove_stages.rows
    del pk

    t0 = time.perf_counter()
    ok, efw = verify_proof(params, vk, [public_inputs], proof)
    seconds["verify"] = time.perf_counter() - t0
    inst_comm = srs.commit_lagrange(public_inputs)
    efw = tuple(efw) if efw is not None else None
    log(f"proof of {len(proof)} bytes {'valid' if ok else 'REJECTED'}")
    if stem is not None and ok:
        save_artifacts(stem, proof, vk, meta or {}, public_inputs, efw, inst_comm)
        log(f"artifacts saved at {stem}.*")
    return {"params": params, "proof": proof, "vk": vk, "efw": efw, "inst_comm": inst_comm, "verified": bool(ok),
            "seconds": seconds}


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
    stages as [message, seconds] rows.  For N > 1 also the in-circuit fold
    (W, RHS) as `in_circuit_fold` (None for N = 1)."""
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
    log(f"{cfg.num_proofs} inner proof(s) valid; {len(public_inputs)} outer public inputs")

    t0 = time.perf_counter()
    cs, asg, rows, in_circuit_quads, fold = synthesize(cfg, outer, public_inputs, inner["efws"])
    seconds["synthesis"] = time.perf_counter() - t0
    log(f"synthesized {rows} rows at k = {cfg.k_outer}; quads equal the host's")

    res = prove_and_save(cs, asg, public_inputs, cfg.k_outer, seed=seed, device=device, srs=srs, stem=stem,
                         meta=level1_meta(cfg, witness_offset), progress=log, prove_window=prove_window)
    del asg
    seconds.update(res.pop("seconds"))
    return {
        "num_proofs": cfg.num_proofs, "k_outer": cfg.k_outer, "constrained_fs": cfg.constrained_fs,
        "rows": rows, "public_inputs": public_inputs, "inner_quads": inner["efws"],
        "in_circuit_quads": in_circuit_quads, "in_circuit_fold": fold, **res,
        "artifact_stem": stem if res["verified"] else None, "seconds": seconds,
    }


def result_line(res: dict) -> dict:
    """The command's JSON line from `run_outer`'s result."""
    return {
        "num_proofs": res["num_proofs"], "k_outer": res["k_outer"], "rows": res["rows"],
        "proof_bytes": len(res["proof"]), "proof_sha256": hashlib.sha256(res["proof"]).hexdigest(),
        "vk_hash": str(res["vk"].hash_scalar()), "verified": res["verified"],
        "in_circuit_quads_equal_host": res["in_circuit_quads"] == res["inner_quads"],
        "artifact_stem": res["artifact_stem"], "seconds": res["seconds"],
    }


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


def peak_rss_mib() -> float:
    """The process's peak resident set (Linux reports KiB)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024


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
    checks = expect_checks(res, args.expect) if args.expect else {}
    print(json.dumps({
        "card": card_line(), "expect": args.expect or None, **checks, "wall_s": time.perf_counter() - t0,
        "peak_device_mib": torch.cuda.max_memory_allocated() / 2**20 if torch.cuda.is_available() else None,
        "peak_rss_mib": peak_rss_mib(),
    }), flush=True)
    return 0 if res["verified"] and all(checks.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
