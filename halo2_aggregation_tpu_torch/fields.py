"""BN254 (a.k.a. BN256 / alt_bn128) field and curve constants.

These mirror the parameters the reference crate gets from its `halo2` fork
(`reference/Cargo.toml:12`, curve types used in
`reference/examples/simple-example.rs:552-553`): the scalar field Fr
(circuit field), the base field Fq (coordinate field), and the G1/G2
generators needed for the KZG pairing check.

Everything here is plain Python ints; device-side limb representations are
derived in :mod:`halo2_aggregation_tpu_torch.ops.limbs`.
"""

from __future__ import annotations

# ---------------------------------------------------------------------------
# Field moduli
# ---------------------------------------------------------------------------

#: BN254 base field modulus (coordinates of G1 live in F_q)
Q = 21888242871839275222246405745257275088696311157297823662689037894645226208583

#: BN254 scalar field modulus (the circuit field; |G1| = r)
R = 21888242871839275222246405745257275088548364400416034343698204186575808495617

# Multiplicative generator of Fr* (same value halo2curves uses for bn256::Fr).
FR_GENERATOR = 7
# 2-adicity of r - 1: r - 1 = 2^28 * odd
FR_S = 28
FR_T_ODD = (R - 1) >> FR_S
assert (R - 1) == FR_T_ODD << FR_S and FR_T_ODD % 2 == 1

#: Largest-order root of unity: omega_{2^28} = g^((r-1)/2^28)
FR_ROOT_OF_UNITY = pow(FR_GENERATOR, FR_T_ODD, R)

#: DELTA used by the permutation argument's column cosets
#: (`reference/src/permutation.rs:259`): generator of the group of
#: 2^S-th residues, so powers of DELTA index disjoint cosets.
FR_DELTA = pow(FR_GENERATOR, 1 << FR_S, R)

# Multiplicative generator of Fq* (halo2curves bn256::Fq uses 3; q-1 = 2*odd).
FQ_GENERATOR = 3
FQ_S = 1


def fr_omega(k: int) -> int:
    """Primitive 2^k-th root of unity in Fr (domain generator for size 2^k)."""
    assert 0 <= k <= FR_S
    return pow(FR_ROOT_OF_UNITY, 1 << (FR_S - k), R)


# ---------------------------------------------------------------------------
# Curve: y^2 = x^3 + 3 over Fq; G2 over Fq2 = Fq[u]/(u^2+1), b2 = 3/(9+u)
# ---------------------------------------------------------------------------

CURVE_B = 3

#: G1 generator
G1_GEN = (1, 2)

#: G2 generator, coordinates as (c0, c1) pairs in Fq2 = c0 + c1*u
G2_GEN_X = (
    10857046999023057135944570762232829481370756359578518086990519993285655852781,
    11559732032986387107991004021392285783925812861821192530917403151452391805634,
)
G2_GEN_Y = (
    8495653923123431417604973247489272438418190587263600148770280649306958101930,
    4082367875863433681332203403145435568316851327593401208105741076214120093531,
)

#: BN curve parameter x (for the Miller loop); 6x+2 drives the loop length.
BN_X = 4965661367192848881
BN_SIX_X_PLUS_2 = 6 * BN_X + 2

# ---------------------------------------------------------------------------
# Limb layout (device representation, see ops/limbs.py)
# ---------------------------------------------------------------------------

#: bits per limb on device: 8-bit limbs give MXU-friendly i8/f32-exact matmuls
LIMB_BITS = 8
#: number of limbs: 32 * 8 = 256 bits covers the 254-bit moduli
NLIMBS = 32

#: Montgomery radix for the device representation
MONT_R = 1 << (LIMB_BITS * NLIMBS)

__all__ = [
    "Q",
    "R",
    "FR_GENERATOR",
    "FR_S",
    "FR_ROOT_OF_UNITY",
    "FR_DELTA",
    "FQ_GENERATOR",
    "FQ_S",
    "fr_omega",
    "CURVE_B",
    "G1_GEN",
    "G2_GEN_X",
    "G2_GEN_Y",
    "BN_X",
    "BN_SIX_X_PLUS_2",
    "LIMB_BITS",
    "NLIMBS",
    "MONT_R",
]
