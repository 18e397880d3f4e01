"""The recursion tree through the port: four N = 2 outer proofs folded by
`aggregation/tree.py::run_tree` up to a proved level-3 root, every proof
made on the card.

    python3 -m halo2_aggregation_tpu_torch.tools.tree_prove [--out build/tree] [--leaves A B C D]

8 inner proofs -> 4 level-1 aggregations at k = 22 -> 2 level-2 nodes at
k = 23 -> 1 level-3 root at k = 23: seven outer proofs.

Leaves.  The checked-in `docs/artifacts/outer_n2_k22` and `outer_n2_k22b`
(witness offsets 0 and 2), passed by the relative path that made
`level2_n2_k23`, and two made here by `outer_prove.run_outer` at N = 2,
witness offsets 4 and 6, seed 1, under `--out`, each held to
`outer_prove.run_checks` (with the public inputs' SHA-256 pinned in
`PIS_SHA256`).  `--leaves A B C D` takes four existing stems instead.

The tree.  `run_tree(leaves, <out>/tree.jsonl, k_node=23, prove_fn=...)`,
where the prove is `prove_node` with seed 2 (as `tools/level2_prove.py`
runs it) wrapped by `NodeProver`: each of the node's progress messages
with its second and the RSS and peak RSS then, the stage seconds taken
from them, the rows (from `prove_node`'s "node circuit synthesized"
message), peak device memory, kernel launches, the proof's SHA-256 and the
vk's `hash_scalar`, written beside the node as `<stem>.tree.json`.  The
RSS is printed at the start of each node, and each node's `DeviceSRS` and
pk are gone (and the card's cache emptied) before the next.

Checks, one boolean each; the command exits 1 unless every one holds:
  * each new leaf's `run_checks`;
  * `tree_l2_i0`, when its children are the checked-in pair, byte for byte
    `docs/artifacts/level2_n2_k23` (`outer_prove.expect_checks`);
  * every node: the host `verify_proof` accepting it with the meta's quad,
    `verify_batch(aggregate=True)` on the card accepting it at B = 1 and
    refusing it with one byte flipped, its meta's level and children.  That
    its children verify with quads equal to their metas, that its
    in-circuit quads and fold equal the host's and that its rows fit
    `cs.usable_rows(2^23)`, `prove_node` asserts: it raises, and with it
    the command, when one of them fails;
  * both level-2 nodes under one vk, so the root's children share it;
  * resume: a second `run_tree` over the same leaves and manifest proves
    nothing and returns the same root.

Prints one JSON line: the card, the leaves' and the nodes' records, each
level's vk hash, whether the level-3 vk differs from the level-2 one (the
node circuit loads its child vk's fixed and sigma commitments as constants,
`aggregation/chips.py:263-269`), each node's kernel launches, the resume's
wall, the peak RSS, the stage that reached it and the host's MemTotal.
`--out` in the checked-in `docs/artifacts` is refused before any work.
"""

from __future__ import annotations

import argparse
import gc
import hashlib
import json
import os
import re
import sys
import time

from . import outer_prove
from .outer_prove import card_line, mem_total_mib, peak_rss_mib, peak_rss_stage, rss_mib, writable_stem

ART = outer_prove.CHECKED_IN
K_LEAF = 22
K_NODE = 23
NODE_SEED = 2  # level2_n2_k23's; run_tree's prove_fn call passes none
LEAF_SEED = 1  # run_outer's, as the checked-in leaves were made
NEW_LEAF_OFFSETS = (4, 6)
CHECKED_IN_LEAVES = ("outer_n2_k22", "outer_n2_k22b")  # witness offsets 0 and 2
LEVEL2_ARTIFACT = "level2_n2_k23"
ROWS = re.compile(r"node circuit synthesized: (\d+) rows")
#: a node's stages, each ending at the first progress message that holds
#: its marker (`prove_node`'s and `prove_and_save`'s messages; the verify's
#: ends after the instance commitment)
STAGE_ENDS = (("reverify", "children re-verify natively"), ("synthesis", "node circuit synthesized"),
              ("setup", "SRS at k = "), ("keygen", "keygen done"), ("prove", "multiopen witnesses"),
              ("verify", "proof of "))


def parse_args(argv=None) -> argparse.Namespace:
    """The command's arguments; `--out` in the checked-in `docs/artifacts`
    raises a ValueError."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join("build", "tree"))
    ap.add_argument("--leaves", nargs=4, metavar=("A", "B", "C", "D"),
                    help="four existing level-1 stems in place of the checked-in pair and two new leaves")
    args = ap.parse_args(argv)
    args.manifest = writable_stem(os.path.join(args.out, "tree.jsonl"))
    return args


def checked_in_leaves() -> list:
    """The checked-in pair by the path relative to the working directory, as
    `level2_n2_k23`'s meta names its children when run from the repo root."""
    return [os.path.relpath(os.path.join(ART, name)) for name in CHECKED_IN_LEAVES]


def proof_sha256(stem: str) -> str:
    with open(f"{stem}.proof", "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def prove_leaf(offset: int, out: str, device, progress) -> tuple:
    """One level-1 leaf: `run_outer` at N = 2, k = 22, the Poseidon inner
    transcript, witness offset `offset`, seed 1, written under `out`, then
    `run_checks`.  Returns (stem, record, checks)."""
    import torch

    from ..config import H2AConfig

    cfg = H2AConfig(k_inner=9, k_outer=K_LEAF, num_proofs=2, constrained_fs=True)
    card = torch.device(device).type == "cuda"
    if card:
        torch.cuda.reset_peak_memory_stats()
    before = outer_prove.kernel_launches()
    t0 = time.perf_counter()
    res = outer_prove.run_outer(cfg, device=device, artifacts_dir=out, tag=f"w{offset}", witness_offset=offset,
                                seed=LEAF_SEED, progress=progress)
    wall = time.perf_counter() - t0
    launches = outer_prove.kernel_launches()
    checks = outer_prove.run_checks(res, device)
    record = {
        **{k: v for k, v in outer_prove.result_line(res).items() if k != "host_mem_total_mib"},
        "witness_offset": offset, "wall_s": wall,
        "peak_device_mib": torch.cuda.max_memory_allocated() / 2**20 if card else None,
        "launches": {name: launches[name] - before[name] for name in launches},
    }
    return res["artifact_stem"], record, checks


def stage_seconds(progress: list) -> dict:
    """Each of `STAGE_ENDS`' stages' seconds from a node's progress rows
    ([message, second, ...]): from the end of the stage before (0 for the
    first) to the first message that holds its marker; a stage whose marker
    never came is left out."""
    out, t_prev = {}, 0.0
    for stage, marker in STAGE_ENDS:
        t = next((row[1] for row in progress if marker in row[0]), None)
        if t is not None:
            out[stage], t_prev = t - t_prev, t
    return out


class NodeProver:
    """`run_tree`'s `prove_fn`: `prove_node` on `device` with seed 2, one
    record a node (`<stem>.tree.json`); `calls` counts the proves."""

    def __init__(self, device, progress):
        self.device = device
        self.progress = progress
        self.calls = 0

    def __call__(self, stem_a: str, stem_b: str, k: int, out_stem: str) -> str:
        import torch

        from ..aggregation import tree

        self.calls += 1
        name = os.path.basename(out_stem)
        card = torch.device(self.device).type == "cuda"
        gc.collect()
        if card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        start = rss_mib()
        self.progress(f"{name}: start, RSS {start[0]:.0f} MiB (peak {start[1]:.0f})")
        messages = []
        t0 = time.perf_counter()

        def log(msg):
            messages.append([msg, time.perf_counter() - t0, *rss_mib()])
            self.progress(f"{name}: {msg}")

        before = outer_prove.kernel_launches()
        stem = tree.prove_node(stem_a, stem_b, k=k, out_stem=out_stem, seed=NODE_SEED, progress=log,
                               device=self.device)
        wall = time.perf_counter() - t0
        launches = outer_prove.kernel_launches()
        rows = next((int(m.group(1)) for m in (ROWS.search(row[0]) for row in messages) if m), None)
        record = {
            "stem": stem, "children": [stem_a, stem_b], "k": k, "rows": rows, "wall_s": wall,
            "proof_sha256": proof_sha256(stem), "vk_hash": vk_hash(stem),
            "seconds": stage_seconds(messages), "rss_at_start_mib": start,
            "peak_device_mib": torch.cuda.max_memory_allocated() / 2**20 if card else None,
            "launches": {kname: launches[kname] - before[kname] for kname in launches},
            "progress": messages,
        }
        with open(f"{stem}.tree.json", "w") as f:
            json.dump(record, f)
        gc.collect()
        if card:
            torch.cuda.empty_cache()
        return stem


def node_record(stem: str):
    """The record `NodeProver` wrote beside `stem`, or None."""
    try:
        with open(f"{stem}.tree.json") as f:
            return json.load(f)
    except FileNotFoundError:
        return None


def node_checks(stem: str, level: int, children: list, params, device) -> dict:
    """What a node without an artifact is held to, one boolean each (see the
    module's docstring); `params` is the node's SRS, `kzg.setup(k)`."""
    from ..aggregation.tree import load_artifact
    from ..plonk import verifier

    proof, vk, meta, pis, efw, _ = load_artifact(stem)
    ok, efw_host = verifier.verify_proof(params, vk, [pis], proof)
    args = (params, vk, [pis], [proof])
    return {
        "verified": bool(ok) and efw_host is not None and tuple(map(tuple, efw_host)) == efw,
        "verify_batch_b1_accepts": outer_prove.verify_on_device(*args, [efw], device)[0],
        "flipped_byte_rejected": outer_prove.flipped_byte_verdict(*args, device) is not None,
        "level": meta.get("level") == level,
        "children": meta.get("children") == list(children),
    }


def artifact_checks(stem: str, want: str) -> dict:
    """The node at `stem` against the checked-in artifact `want`
    (`outer_prove.expect_checks`: proof, vk, public inputs, quad, instance
    commitment)."""
    from ..aggregation.tree import load_artifact

    proof, vk, _, pis, efw, inst_comm = load_artifact(stem)
    res = {"proof": proof, "vk": vk, "public_inputs": pis, "efw": efw, "inst_comm": inst_comm}
    return outer_prove.expect_checks(res, want)


def vk_hash(stem: str) -> str:
    from ..utils.artifacts import load_vk

    return str(load_vk(stem).hash_scalar())


def main(argv=None, device="cuda") -> int:
    import torch

    from ..aggregation import tree
    from ..device import resolve_device
    from ..ops import build
    from ..utils.jobs import StageLogger

    args = parse_args(argv)
    device = resolve_device(device)
    # the SRS cache stays inside the checkout (build/ is not committed)
    os.environ.setdefault("H2A_PARAMS_CACHE", str(build.BUILD_ROOT.parent / "h2a-params"))
    card = card_line()
    print(card, flush=True)
    os.makedirs(args.out, exist_ok=True)
    t0 = time.perf_counter()
    rss = []

    def progress(msg):
        rss.append([msg, *rss_mib()])
        print(f"[{time.perf_counter() - t0:8.1f}s] {msg}", flush=True)

    checks, leaves = {}, []
    if args.leaves:
        stems = list(args.leaves)
    else:
        stems = checked_in_leaves()
        for offset in NEW_LEAF_OFFSETS:
            stem, record, leaf_checks = prove_leaf(offset, args.out, device,
                                                   lambda m, o=offset: progress(f"leaf w{o}: {m}"))
            leaves.append(record)
            checks.update({f"leaf_w{offset}.{name}": ok for name, ok in leaf_checks.items()})
            stems.append(stem)
            gc.collect()
            if device.type == "cuda":
                torch.cuda.empty_cache()

    prover = NodeProver(device, progress)
    logger = StageLogger(echo=True)
    root = tree.run_tree(stems, args.manifest, k_node=K_NODE, prove_fn=prover, out_dir=args.out, logger=logger)
    wall_tree = time.perf_counter() - t0
    level2 = [os.path.join(args.out, f"tree_l2_i{i}_k{K_NODE}") for i in range(2)]

    # the level-2 and level-3 nodes share k = 23, hence one SRS (its
    # fixed-base products on the card, else the host engine's)
    from ..plonk import kzg

    params = kzg.setup(K_NODE, device=device if device.type == "cuda" else None)
    for stem, level, children in ((level2[0], 2, stems[:2]), (level2[1], 2, stems[2:]), (root, 3, level2)):
        name = os.path.basename(stem)
        checks.update({f"{name}.{c}": ok for c, ok in node_checks(stem, level, children, params, device).items()})
        progress(f"{name} checked")
    pair = [os.path.join(ART, n) for n in CHECKED_IN_LEAVES]
    if [proof_sha256(s) for s in stems[:2]] == [proof_sha256(s) for s in pair]:
        want = os.path.join(ART, LEVEL2_ARTIFACT)
        name = os.path.basename(level2[0])
        checks.update({f"{name}.{c}": ok for c, ok in artifact_checks(level2[0], want).items()})
    hashes = {"level1": vk_hash(stems[0]), "level2": [vk_hash(s) for s in level2], "level3": vk_hash(root)}
    checks["level2_vks_equal"] = hashes["level2"][0] == hashes["level2"][1]

    calls = prover.calls
    t1 = time.perf_counter()
    root_again = tree.run_tree(stems, args.manifest, k_node=K_NODE, prove_fn=prover, out_dir=args.out,
                               logger=logger)
    resume_s = time.perf_counter() - t1
    checks["resume_proves_nothing"] = prover.calls == calls
    checks["resume_same_root"] = root_again == root

    nodes = [node_record(s) for s in (*level2, root)]
    print(json.dumps({
        "phase": "tree", "card": card, "out": args.out, "leaves_given": bool(args.leaves), "stems": stems,
        "root": root, "checks": checks, "ok": all(checks.values()),
        "leaves": leaves, "nodes": nodes, "proof_sha256": {os.path.basename(s): proof_sha256(s)
                                                           for s in (*stems, *level2, root)},
        "vk_hash": hashes, "level3_vk_differs_from_level2": hashes["level3"] != hashes["level2"][0],
        "launches_a_node": {os.path.basename(n["stem"]): n["launches"] for n in nodes if n},
        "node_proves": calls, "tree_wall_s": wall_tree, "resume_s": resume_s,
        "wall_s": time.perf_counter() - t0,
        # the largest of the leaves' and nodes' peaks (each reset the card's peak) and the checks'
        "peak_device_mib": max([r["peak_device_mib"] for r in (*leaves, *nodes) if r and r.get("peak_device_mib")]
                               + [torch.cuda.max_memory_allocated() / 2**20]) if device.type == "cuda" else None,
        "peak_rss_mib": peak_rss_mib(), "peak_rss_stage": peak_rss_stage(rss), "host_mem_total_mib": mem_total_mib(),
    }), flush=True)
    return 0 if all(checks.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
