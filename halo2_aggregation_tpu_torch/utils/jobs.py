"""Long-running aggregation jobs: checkpoint/resume + structured logging.

SURVEY.md §5 rows "failure detection / recovery" and "metrics / logging":
the reference has neither (Result propagation + println!); production
aggregation of large proof batches needs to survive preemption — TPU VMs
are preemptible — and to emit machine-readable stage timings.

`aggregate_checkpointed` processes a proof stream in device-batch chunks,
persisting each chunk's verified quads to an append-only JSONL checkpoint;
a restarted job replays the file and continues with the first unfinished
chunk (idempotent: chunks are keyed by index + proof digest).  The final
fold + single pairing check runs over all quads, recomputed deterministically
from the checkpoint.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from typing import List, Optional


class StageLogger:
    """Structured per-stage timing: JSONL records {stage, wall_s, ...}.
    Used by bench.py and the checkpointed aggregator; stdout by default,
    a file when `path` is given."""

    def __init__(self, path: Optional[str] = None, echo: bool = False):
        self.path = path
        self.echo = echo
        self._t0 = time.time()
        self._last = self._t0

    def log(self, stage: str, **fields):
        now = time.time()
        rec = {
            "stage": stage,
            "wall_s": round(now - self._last, 3),
            "total_s": round(now - self._t0, 3),
            **fields,
        }
        self._last = now
        line = json.dumps(rec)
        if self.path:
            with open(self.path, "a") as f:
                f.write(line + "\n")
        if self.echo:
            print(line, flush=True)
        return rec


def _chunk_key(idx: int, proofs: List[bytes]) -> str:
    h = hashlib.blake2b(digest_size=16)
    h.update(idx.to_bytes(4, "little"))
    for p in proofs:
        h.update(hashlib.blake2b(p, digest_size=16).digest())
    return h.hexdigest()


def aggregate_checkpointed(
    params,
    vk,
    instances_list,
    proofs: List[bytes],
    checkpoint_path: str,
    chunk: int = 16,
    logger: Optional[StageLogger] = None,
    *,
    device="cuda",
):
    """Verify a stream of proofs in device-batch chunks with crash-safe
    resume, then ONE folded pairing check over every quad.

    Returns (ok, quads).  A killed job restarted with the same
    checkpoint_path skips every completed chunk (verified against the
    chunk's proof digests, so a changed input invalidates the entry).
    Each chunk's algebra runs on `device`: K2, K1 and the lane sums on a
    card, their plain versions with "cpu"."""
    from ..device import resolve_device
    from ..plonk.verifier_device import (
        batch_proofs, check_aggregate, commit_instance, parse_batch, quads_to_ints, verify_algebra_fast,
    )

    device = resolve_device(device)
    log = logger or StageLogger()
    done = {}
    if os.path.exists(checkpoint_path):
        with open(checkpoint_path) as f:
            for line in f:
                try:
                    rec = json.loads(line)
                    done[rec["key"]] = rec["quads"]
                except (ValueError, KeyError):
                    continue  # torn write from a crash: recompute
        log.log("resume", completed_chunks=len(done))

    quads: List[tuple] = []
    for c0 in range(0, len(proofs), chunk):
        idx = c0 // chunk
        chunk_proofs = proofs[c0 : c0 + chunk]
        chunk_insts = instances_list[c0 : c0 + chunk]
        key = _chunk_key(idx, chunk_proofs)
        if key in done:
            quads.extend(
                tuple(
                    None if pt is None else tuple(int(v) for v in pt)
                    for pt in q
                )
                for q in done[key]
            )
            continue
        usable = vk.cs.usable_rows(vk.n)
        inst_comms = [[commit_instance(params, col, usable) for col in insts] for insts in chunk_insts]
        parsed = parse_batch(vk, inst_comms, chunk_proofs)
        batch = batch_proofs(vk, parsed, device)
        chunk_quads = quads_to_ints(verify_algebra_fast(vk, batch, parsed))
        with open(checkpoint_path, "a") as f:
            f.write(
                json.dumps(
                    {
                        "key": key,
                        "idx": idx,
                        "quads": [
                            [
                                None if pt is None else [str(c) for c in pt]
                                for pt in q
                            ]
                            for q in chunk_quads
                        ],
                    },
                    default=str,
                )
                + "\n"
            )
        log.log("chunk", idx=idx, proofs=len(parsed))
        quads.extend(chunk_quads)

    ok = check_aggregate(quads, params)
    log.log("aggregate_pairing", ok=bool(ok), total_proofs=len(quads))
    return ok, quads
