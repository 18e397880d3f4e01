"""One recursion node proved on the card: `aggregation/tree.py::prove_node`
over two level-1 artifacts, held to a checked-in level-2 artifact.

    python3 -m halo2_aggregation_tpu_torch.tools.level2_prove [--out build/level2]

The counterpart of the JAX package's `tools/level2_prove.py`: the node over
`docs/artifacts/outer_n2_k22` and `outer_n2_k22b` at k = 23 with seed 2
(`prove_node` re-verifies both children on the host, synthesizes the node
circuit once, and hands it to the outer prover's `prove_and_save`:
`keygen_device` on the witness-bearing assignment and `create_proof_device`
through one `DeviceSRS`, then the host verify), written under `--out`.  Prints one JSON line: the proof, vk, quad, instance
commitment and public inputs against `docs/artifacts/level2_n2_k23.*`, the
SHA-256 of both proofs, the card's name and power limit, each progress
message with its seconds since the start, and the peak device memory.
Exits 1 unless every comparison holds.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

ART = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", "docs", "artifacts")


def main(argv=None) -> int:
    import torch

    from ..aggregation.tree import prove_node
    from ..utils.artifacts import load_vk

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join("build", "level2"))
    args = ap.parse_args(argv)
    k = 23
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    t0 = time.perf_counter()
    rows = []

    def log(msg):
        rows.append([msg, time.perf_counter() - t0])
        print(f"[{time.perf_counter() - t0:8.1f}s] {msg}", flush=True)

    os.makedirs(args.out, exist_ok=True)
    torch.cuda.reset_peak_memory_stats()
    want = os.path.normpath(os.path.join(ART, f"level2_n2_k{k}"))
    stem = prove_node(os.path.join(ART, "outer_n2_k22"), os.path.join(ART, "outer_n2_k22b"), k=k,
                      out_stem=os.path.join(args.out, f"level2_n2_k{k}"), seed=2, progress=log)
    wall = time.perf_counter() - t0
    got_proof, want_proof = (open(f"{s}.proof", "rb").read() for s in (stem, want))
    got_meta, want_meta = (json.load(open(f"{s}.meta.json")) for s in (stem, want))
    vk, want_vk = load_vk(stem), load_vk(want)
    checks = {
        "proof_equal_to_artifact": got_proof == want_proof,
        "vk_equal_to_artifact": (vk.hash_scalar() == want_vk.hash_scalar()
                                 and vk.fixed_commitments == want_vk.fixed_commitments
                                 and vk.sigma_commitments == want_vk.sigma_commitments),
        **{f"{key}_equal_to_meta": got_meta[key] == want_meta[key]
           for key in ("public_inputs", "efw", "inst_comm")},
    }
    print(json.dumps({
        "phase": "level2", "k": k, "card": card, **checks,
        "proof_sha256": hashlib.sha256(got_proof).hexdigest(),
        "artifact_sha256": hashlib.sha256(want_proof).hexdigest(),
        "wall_s": wall, "progress": rows,
        "peak_device_mib": torch.cuda.max_memory_allocated() / 2**20,
    }), flush=True)
    return 0 if all(checks.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
