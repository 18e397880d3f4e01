"""Blake2b Fiat-Shamir transcript (host side).

Re-creates the absorb/squeeze discipline of halo2's Blake2b transcript that
both sides of the reference rely on (`reference/src/transcript.rs:58`
wraps `Blake2bWrite<Vec<u8>, C, Challenge255>`; the verifier replays it at
`reference/src/verifier.rs:341-719`):

* state: blake2b, 64-byte digest, personalization ``b"Halo2-Transcript"``
* domain prefixes: 0 = challenge squeeze, 1 = point absorb, 2 = scalar
* ``common_point`` absorbs the affine x then y coordinate (32-byte LE each)
* ``squeeze_challenge`` appends the challenge prefix, forks the state, and
  maps the 64-byte digest to Fr via little-endian reduction
  (``from_bytes_wide``)
* written points travel compressed (32 bytes); scalars as 32-byte LE

Challenges are plain Python ints; they cross to the device as scalar
inputs of the jitted verifier algebra (the host<->device boundary of
SURVEY.md §7 layer 3).
"""

from __future__ import annotations

import hashlib

from ..fields import R
from .serialization import (
    fq_to_bytes,
    fr_from_bytes,
    fr_to_bytes,
    g1_compress,
    g1_decompress,
)

PERSONALIZATION = b"Halo2-Transcript"
PREFIX_CHALLENGE = b"\x00"
PREFIX_POINT = b"\x01"
PREFIX_SCALAR = b"\x02"


def _new_state():
    return hashlib.blake2b(digest_size=64, person=PERSONALIZATION)


def challenge_from_wide(digest: bytes) -> int:
    """64-byte LE -> Fr (halo2's `from_bytes_wide`)."""
    return int.from_bytes(digest, "little") % R


class _TranscriptBase:
    def __init__(self):
        self.state = _new_state()

    def common_point(self, p):
        self.state.update(PREFIX_POINT)
        if p is None:
            raise ValueError("cannot absorb the identity point")
        x, y = p
        self.state.update(fq_to_bytes(x))
        self.state.update(fq_to_bytes(y))

    def common_scalar(self, s: int):
        self.state.update(PREFIX_SCALAR)
        self.state.update(fr_to_bytes(s))

    def squeeze_challenge(self) -> int:
        self.state.update(PREFIX_CHALLENGE)
        fork = self.state.copy()
        return challenge_from_wide(fork.digest())


class Blake2bWrite(_TranscriptBase):
    """Prover-side transcript: absorb + append to the proof byte stream."""

    def __init__(self):
        super().__init__()
        self.buf = bytearray()

    def write_point(self, p):
        self.common_point(p)
        self.buf += g1_compress(p)

    def write_scalar(self, s: int):
        self.common_scalar(s)
        self.buf += fr_to_bytes(s)

    def finalize(self) -> bytes:
        return bytes(self.buf)


class Blake2bRead(_TranscriptBase):
    """Verifier-side transcript: read from proof bytes + absorb."""

    def __init__(self, proof: bytes):
        super().__init__()
        self.proof = proof
        self.off = 0

    def _take(self, n: int) -> bytes:
        if self.off + n > len(self.proof):
            raise ValueError("transcript exhausted")
        out = self.proof[self.off : self.off + n]
        self.off += n
        return out

    def read_point(self):
        p = g1_decompress(self._take(32))
        self.common_point(p)
        return p

    def read_scalar(self) -> int:
        s = fr_from_bytes(self._take(32))
        self.common_scalar(s)
        return s


# ---------------------------------------------------------------------------
# Poseidon transcript — the in-circuit-friendly variant
# ---------------------------------------------------------------------------
#
# Same read/write framing as Blake2b (points compressed to 32 bytes,
# scalars 32-byte LE in the proof stream), but challenges come from a
# Poseidon sponge over Fr (oracle/poseidon.py), absorbing each point as
# its 2x4 68-bit limbs and each scalar directly — EXACTLY the values the
# constrained transcript chip (aggregation/gadgets/poseidon.py) sees as
# cells, so the in-circuit challenge derivation can be enforced rather
# than witnessed (closes reference/src/transcript.rs:62-65's
# documented soundness gap).


class _PoseidonBase:
    def __init__(self):
        from ..oracle.poseidon import PoseidonSponge

        self.sponge = PoseidonSponge()

    def common_point(self, p):
        if p is None:
            raise ValueError("cannot absorb the identity point")
        from ..aggregation.gadgets.integer import value_to_limbs

        x, y = p
        for v in value_to_limbs(x) + value_to_limbs(y):
            self.sponge.absorb(v)

    def common_scalar(self, s: int):
        self.sponge.absorb(s % R)

    def squeeze_challenge(self) -> int:
        return self.sponge.squeeze()


class PoseidonWrite(_PoseidonBase, Blake2bWrite):
    def __init__(self):
        _PoseidonBase.__init__(self)
        self.buf = bytearray()


class PoseidonRead(_PoseidonBase, Blake2bRead):
    def __init__(self, proof: bytes):
        _PoseidonBase.__init__(self)
        self.proof = proof
        self.off = 0
