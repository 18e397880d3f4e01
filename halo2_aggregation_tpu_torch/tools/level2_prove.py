"""One recursion node proved on the card: `aggregation/tree.py::prove_node`
over two level-1 artifacts, held to a checked-in level-2 artifact.

    python3 -m halo2_aggregation_tpu_torch.tools.level2_prove [--out build/level2] [--children A B]

The counterpart of the JAX package's `tools/level2_prove.py`: the node over
two level-1 stems (`--children`; by default the checked-in
`docs/artifacts/outer_n2_k22` and `outer_n2_k22b`, and the port's own when
given the stems `tools/outer_prove.py --artifacts-dir` wrote) at k = 23 with seed 2
(`prove_node` re-verifies both children on the host, synthesizes the node
circuit once, and hands it to the outer prover's `prove_and_save`:
`keygen_device` on the witness-bearing assignment and `create_proof_device`
through one `DeviceSRS`, then the host verify), written under `--out`.  Prints one JSON line: the proof, vk, quad, instance
commitment and public inputs against `docs/artifacts/level2_n2_k23.*`, the
SHA-256 of both proofs, the card's name and power limit, each progress
message with its seconds since the start and the process's RSS and peak RSS
at it, the message during which the peak was reached, the peak device
memory and the host's MemTotal.  Exits 1 unless every comparison holds.  `--out` in the
checked-in `docs/artifacts` is refused before any work.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time

from .outer_prove import card_line, expect_checks, mem_total_mib, peak_rss_mib, peak_rss_stage, rss_mib, writable_stem

ART = os.path.normpath(os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", "docs", "artifacts"))
K = 23


def parse_args(argv=None) -> argparse.Namespace:
    """The command's arguments; `out_stem` is the node's stem under `--out`,
    refused (ValueError) in the checked-in `docs/artifacts`."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join("build", "level2"))
    ap.add_argument("--children", nargs=2, metavar=("A", "B"),
                    default=[os.path.join(ART, "outer_n2_k22"), os.path.join(ART, "outer_n2_k22b")],
                    help="the two level-1 stems (default: the checked-in outer_n2_k22 and outer_n2_k22b)")
    args = ap.parse_args(argv)
    args.out_stem = writable_stem(os.path.join(args.out, f"level2_n2_k{K}"))
    return args


def main(argv=None) -> int:
    import torch

    from ..aggregation.tree import load_artifact, prove_node

    args = parse_args(argv)
    card = card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    rows, rss = [], []

    def log(msg):
        rows.append([msg, time.perf_counter() - t0])
        rss.append([msg, *rss_mib()])
        print(f"[{time.perf_counter() - t0:8.1f}s] {msg}", flush=True)

    os.makedirs(args.out, exist_ok=True)
    card_run = torch.cuda.is_available()
    if card_run:
        torch.cuda.reset_peak_memory_stats()
    want = os.path.join(ART, f"level2_n2_k{K}")
    stem = prove_node(*args.children, k=K, out_stem=args.out_stem, seed=2, progress=log)
    wall = time.perf_counter() - t0
    proof, vk, _, pis, efw, inst_comm = load_artifact(stem)
    checks = expect_checks({"proof": proof, "vk": vk, "public_inputs": pis, "efw": efw, "inst_comm": inst_comm}, want)
    with open(f"{want}.proof", "rb") as f:
        want_sha = hashlib.sha256(f.read()).hexdigest()
    print(json.dumps({
        "phase": "level2", "k": K, "card": card, "children": args.children, **checks,
        "proof_sha256": hashlib.sha256(proof).hexdigest(), "artifact_sha256": want_sha,
        "wall_s": wall, "progress": rows,
        "peak_device_mib": torch.cuda.max_memory_allocated() / 2**20 if card_run else None,
        "peak_rss_mib": peak_rss_mib(), "rss_mib": rss, "peak_rss_stage": peak_rss_stage(rss),
        "host_mem_total_mib": mem_total_mib(),
    }), flush=True)
    return 0 if all(checks.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
