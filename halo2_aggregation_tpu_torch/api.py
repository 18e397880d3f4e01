"""Reference-compatible API surface.

A user of `Trapdoor-Tech/halo2-aggregation` + its halo2 fork interacts with
the symbols in SURVEY.md §2b; this module exposes our equivalents under the
same names so the migration is mechanical:

  Rust (fork)                          here
  -----------                          ----
  Setup::<Bn256>::new(k, rng)          Setup.new(k, seed)
  Setup::verifier_params(params, n)    Setup.verifier_params(params)
  Params::{read, write}                Params.load / params.save
  params.commit_lagrange(values)       params.commit_lagrange(values)
  keygen_vk / keygen_pk                keygen_vk / keygen_pk
  create_proof(params, pk, ...)        create_proof(...)
  verify_proof -> (choice, efw)        verify_proof(...) -> (ok, efw)
  MockProver::run + .verify()          MockProver.run(...).verify()
  Blake2bWrite / Blake2bRead           utils.transcript.Blake2bWrite/Read
  VerifierChip / VerifierConfig        aggregation.chips.VerifierChip

Setup.new, keygen_vk/keygen_pk, create_proof and verify_batch take
`device`: "cuda" by default, "cpu" for the kernels' plain versions, and
None (not verify_batch) for the host code the JAX package's api calls.
"""

from __future__ import annotations

from .device import resolve_device
from .plonk import kzg as _kzg
from .plonk.keygen import ProvingKey, VerifyingKey, keygen as _keygen
from .plonk.keygen_device import keygen_device
from .plonk.mock import mock_verify, mock_verify_fast
from .plonk.prover import create_proof as _create_proof
from .plonk.prover_device import create_proof_device
from .plonk.verifier import parse_proof, verify_proof
from .plonk.verifier_device import verify_batch
from .utils.transcript import Blake2bRead, Blake2bWrite

Params = _kzg.Params


class Setup:
    """`Setup::<Bn256>` analog (simple-example.rs:589-590)."""

    @staticmethod
    def new(k: int, seed: int = 0xE5BC0654, *, device="cuda") -> Params:
        return _kzg.setup(k, seed, device=None if device is None else resolve_device(device))

    @staticmethod
    def verifier_params(params: Params, public_inputs_size: int = 0) -> Params:
        # our Params already carries everything the verifier needs
        return params


def _keys(params, cs, assignment, device):
    """(vk, pk): every commitment on `device`, or on the host for None."""
    if device is None:
        return _keygen(params, cs, assignment)
    return keygen_device(params, cs, assignment, device=device)


def keygen_vk(params, cs, assignment, *, device="cuda") -> VerifyingKey:
    vk, _ = _keys(params, cs, assignment, device)
    return vk


def keygen_pk(params, cs, assignment, *, device="cuda") -> ProvingKey:
    _, pk = _keys(params, cs, assignment, device)
    return pk


def create_proof(params, pk, assignment, instances, seed: int = 42, transcript_cls=Blake2bWrite, *,
                 device="cuda") -> bytes:
    """`plonk.prover.create_proof`'s bytes, with the quotient and every
    commitment on `device`, or all on the host for None."""
    if device is None:
        return _create_proof(params, pk, assignment, instances, seed, transcript_cls)
    return create_proof_device(params, pk, assignment, instances, seed, transcript_cls=transcript_cls,
                               device=device)


class MockProver:
    """`halo2::dev::MockProver` analog (simple-example.rs:601-602)."""

    def __init__(self, cs, assignment, fast: bool = True):
        self.cs = cs
        self.assignment = assignment
        self.fast = fast

    @staticmethod
    def run(k, cs, assignment, fast: bool = True) -> "MockProver":
        assert assignment.n == 1 << k
        return MockProver(cs, assignment, fast)

    def verify(self):
        check = mock_verify_fast if self.fast else mock_verify
        failures = check(self.cs, self.assignment)
        return failures if failures else None


__all__ = [
    "Setup",
    "Params",
    "keygen_vk",
    "keygen_pk",
    "create_proof",
    "verify_proof",
    "verify_batch",
    "parse_proof",
    "MockProver",
    "Blake2bRead",
    "Blake2bWrite",
]
