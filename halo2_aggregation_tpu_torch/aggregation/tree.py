"""Recursive aggregation tree orchestration (VERDICT r4 items 2 + 6).

docs/AGGREGATION_SCALING.md costs the 64-leaf tree: 32 N=2 level-1
proofs + 31 binary recursion nodes = 63 proves, ~2.2e8 rows.  This
module turns that plan into executable, crash-safe orchestration:

  * `prove_node(stem_a, stem_b, ...)` proves ONE recursion node for
    real — a k=23 AggregationCircuit whose two VerifierChips verify the
    two child artifacts (themselves real outer proofs), the outer
    prover's phase D (tools/outer_prove.py::prove_and_save: keygen_device
    + create_proof_device, quotient and commitments on the card, + verify
    + artifact persist).
  * `run_tree(leaf_stems, ...)` folds any list of proven artifacts up a
    binary tree, one `prove_node` at a time (serial: this host's 2
    cores + 1 chip can run exactly one prove), with an append-only
    JSONL manifest keyed by the children's proof digests — a preempted
    run restarted with the same manifest skips every completed node,
    the same recovery contract as `utils.jobs.aggregate_checkpointed`.

The reference has no recursion and no orchestration (one hardcoded
prove, `reference/examples/simple-example.rs:678-730`).
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from typing import Callable, List, Optional


def load_artifact(stem: str):
    """(proof, vk, meta, public_inputs, efw, inst_comm) from a stem."""
    from ..utils.artifacts import load_vk

    proof = open(f"{stem}.proof", "rb").read()
    vk = load_vk(stem)
    meta = json.load(open(f"{stem}.meta.json"))
    pis = [int(v) for v in meta["public_inputs"]]
    efw = tuple(tuple(int(c) for c in p) for p in meta["efw"])
    inst_comm = tuple(int(c) for c in meta["inst_comm"])
    return proof, vk, meta, pis, efw, inst_comm


def prove_node(
    stem_a: str,
    stem_b: str,
    k: int = 23,
    out_stem: Optional[str] = None,
    seed: int = 2,
    progress: Optional[Callable] = None,
    reverify_children: bool = True,
    *,
    device="cuda",
) -> str:
    """Prove one recursion node over two child artifacts; returns the
    node's artifact stem.  Byte layout and checks mirror
    examples/simple_example.py Phase D one level up, through the outer
    prover's `prove_and_save` on `device` ("cpu" for the kernels' plain
    versions).  `out_stem` defaults to $H2A_ARTIFACTS_DIR or build/artifacts,
    and the checked-in docs/artifacts is refused."""
    from ..device import resolve_device
    from ..models import aggregation_circuit as ac
    from ..plonk import kzg
    from ..plonk.verifier import verify_proof
    from ..tools.outer_prove import prove_and_save, writable_stem

    device = resolve_device(device)
    log = progress or (lambda m: print(m, flush=True))
    arts = [load_artifact(stem_a), load_artifact(stem_b)]
    if out_stem is None:
        adir = os.environ.get("H2A_ARTIFACTS_DIR", os.path.join("build", "artifacts"))
        level = max(
            int(a[2].get("level", 1)) for a in arts
        ) + 1
        out_stem = f"{adir}/level{level}_n2_k{k}"
    writable_stem(out_stem)
    vk_o = arts[0][1]
    assert arts[1][1].hash_scalar() == vk_o.hash_scalar(), (
        "child artifacts were made under different vks"
    )
    if reverify_children:
        params_c = kzg.setup(arts[0][2]["k"], device=device)
        t0 = time.time()
        for stem, (proof, _, meta, pis, efw, _) in zip(
            (stem_a, stem_b), arts
        ):
            ok, efw_native = verify_proof(params_c, vk_o, [pis], proof)
            assert ok, f"{stem} does not verify natively"
            assert tuple(map(tuple, efw_native)) == efw, (
                f"{stem} quad mismatch"
            )
        log(f"children re-verify natively ({time.time()-t0:.1f}s)")

    proofs = [arts[0][0], arts[1][0]]
    circ = ac.AggregationCircuit(vk_o, proofs, num_proofs=2)
    pis2 = circ.public_inputs(
        [arts[0][5], arts[1][5]], [arts[0][4], arts[1][4]]
    )
    t0 = time.time()
    cs2, cfg2, asg2, ctx2, (quads, W, RHS) = ac.build(circ, k, pis2)
    for q, art in zip(quads, arts):
        got = (q.e.value(), q.f.value(), q.w.value(), q.zw.value())
        assert got == art[4], "in-circuit quad != native child quad"
    W_want, RHS_want = ac.fold_quads_host([arts[0][4], arts[1][4]])
    assert (W.value(), RHS.value()) == (W_want, RHS_want), "node fold"
    usable = cs2.usable_rows(1 << k)
    assert ctx2.offset <= usable, (
        f"{ctx2.offset} rows do not fit k={k} ({usable} usable)"
    )
    log(f"node circuit synthesized: {ctx2.offset} rows @ k={k} "
        f"({time.time()-t0:.0f}s); quads + fold match")

    meta2 = {
        "k": k,
        "num_proofs": 2,
        "level": max(int(a[2].get("level", 1)) for a in arts) + 1,
        "children": [stem_a, stem_b],
        "constrained_fs": False,
    }
    res = prove_and_save(cs2, asg2, pis2, k, seed=seed, device=device, stem=out_stem, meta=meta2,
                         progress=lambda m, t0=time.time(): log(f"  [node {time.time()-t0:7.0f}s] {m}"))
    del asg2
    assert res["verified"], "node proof rejected"
    return out_stem


def _node_key(stem_a: str, stem_b: str) -> str:
    h = hashlib.blake2b(digest_size=16)
    for s in (stem_a, stem_b):
        with open(f"{s}.proof", "rb") as f:
            h.update(hashlib.blake2b(f.read(), digest_size=16).digest())
    return h.hexdigest()


def run_tree(
    leaf_stems: List[str],
    manifest_path: str,
    k_node: int = 23,
    prove_fn: Callable = prove_node,
    out_dir: Optional[str] = None,
    logger=None,
) -> str:
    """Fold proven artifacts up a binary tree to one root artifact.

    Serial by design (one prove saturates this host); crash-safe: each
    completed node appends {key, stem} to the JSONL manifest, keyed by
    its children's proof digests, and a restarted run reuses any
    manifest entry whose artifact files still exist.  Odd nodes at a
    level carry over unproven (standard binary-tree bye).  Returns the
    root stem."""
    from ..utils.jobs import StageLogger

    log = logger or StageLogger(echo=True)
    out_dir = out_dir or os.path.dirname(manifest_path) or "."
    os.makedirs(out_dir, exist_ok=True)
    done = {}
    if os.path.exists(manifest_path):
        with open(manifest_path) as f:
            for line in f:
                try:
                    rec = json.loads(line)
                    if os.path.exists(rec["stem"] + ".proof"):
                        done[rec["key"]] = rec["stem"]
                except (ValueError, KeyError):
                    continue  # torn write from a crash: recompute
        if done:
            log.log("resume", completed_nodes=len(done))

    level = 1
    stems = list(leaf_stems)
    while len(stems) > 1:
        level += 1
        nxt = []
        for i in range(0, len(stems) - 1, 2):
            a, b = stems[i], stems[i + 1]
            key = _node_key(a, b)
            if key in done:
                nxt.append(done[key])
                log.log("node_cached", level=level, index=i // 2,
                        stem=done[key])
                continue
            out_stem = os.path.join(
                out_dir, f"tree_l{level}_i{i // 2}_k{k_node}"
            )
            t0 = time.time()
            stem = prove_fn(a, b, k=k_node, out_stem=out_stem)
            with open(manifest_path, "a") as f:
                f.write(json.dumps({"key": key, "stem": stem}) + "\n")
            log.log("node_proven", level=level, index=i // 2, stem=stem,
                    prove_s=round(time.time() - t0, 1))
            nxt.append(stem)
        if len(stems) % 2:
            nxt.append(stems[-1])  # bye: fold into the next level up
        stems = nxt
    log.log("tree_done", root=stems[0])
    return stems[0]
