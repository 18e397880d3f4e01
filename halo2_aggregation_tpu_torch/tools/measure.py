"""The card's timer and the bound model of one NVIDIA H100, shared by
`chip_smoke.py` and `halo2_aggregation_tpu_torch/bench.py`.

The bound of a kernel is the least time the card could take for the same
work: the larger of its bytes over the memory rate and its Montgomery
products over the rate at which the card can run them (NVIDIA's H100 SXM
data sheet: 3.35 TB/s of HBM, 67 TFLOP/s of float32 = 132 SMs x 128 lanes
x 2 x 1.98 GHz).  A product of 8 x 32-bit limbs (csrc/field.cuh::fe_mul,
CIOS) is 8 x (8 + 1 + 8) = 136 products of 32 x 32 -> 64 bits, each at
least two 32-bit integer multiply-add instruction slots; the INT32 lanes
are half the float32 lanes, so the card runs 67e12 / 4 = 16.75 T integer
multiply-adds a second: 61.6 G products/s.  Products are counted from the
code and from the run's inputs: 7 a doubling, 16 a full add, 11 a mixed add
(csrc/curve.cuh), a tape's MULs and inversions (K2, K6), a scalar-mul's
nonzero windows (K1).
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
INT32_MADS_PER_S = 67e12 / 4
MADS_PER_PRODUCT = 272
#: Montgomery products a second the card can run: 61.6 G
PRODUCTS_PER_S = INT32_MADS_PER_S / MADS_PER_PRODUCT
# products of the curve formulas (csrc/curve.cuh)
P_DOUBLE, P_ADD, P_ADD_MIXED = 7, 16, 11


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of `fn` on the card (CUDA events).  The
    stream first spins for some 10 ms, so that the calls queue up behind it
    and run back to back: a kernel of tens of microseconds is then timed by
    the card, not by how fast this host launches."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(products: int, nbytes: int) -> dict:
    """The record fields of a kernel's bound, from the Montgomery products
    its inputs need and the bytes it must move (each input read once, each
    output written once).  No PyTorch call computes any of these functions
    (256-bit modular arithmetic), so `library_ms` is null."""
    ops_ms = products * MADS_PER_PRODUCT / INT32_MADS_PER_S * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return {
        "bound_ms": max(ops_ms, bytes_ms), "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": None, "products": int(products), "bytes": int(nbytes),
    }


def inv_products(p: int) -> int:
    """Montgomery products of one inversion (csrc/field.cuh::fe_inv): the 8
    of the odd powers' table, a squaring a bit of p - 2 below bit 254, and
    a product a window of the same sliding 4-bit scan."""
    e, n, bit = p - 2, 8, 253
    while bit >= 0:
        if not (e >> bit) & 1:
            n, bit = n + 1, bit - 1
            continue
        lo = max(bit - 3, 0)
        while not (e >> lo) & 1:
            lo += 1
        n, bit = n + (bit - lo + 1) + 1, lo - 1
    return n


def tape_products(tape) -> int:
    """Montgomery products one lane of a tape needs (K2, K6): one a MUL,
    and those of an inversion an INV."""
    from ..fields import R
    from ..plonk.protocol_ops import OP_INV, OP_MUL

    ops = tape.instrs[:, 0]
    return int((ops == OP_MUL).sum()) + int((ops == OP_INV).sum()) * inv_products(R)


def k1_products(pts, ks) -> int:
    """Montgomery products K1 needs for these lanes (oracle points or None,
    int scalars): a half is its table (4 doublings, 3 adds), 32 x 4
    doublings and an add for every nonzero signed digit but the first (the
    identity absorbs that one, and every add of an identity point); a lane
    is two halves, the product by beta and the add of the two where neither
    is the identity."""
    from ..ops.ec_kernels import glv_split

    eights = int("8" * 33, 16)  # |half| + 0x88..8 has nibbles digit + 8
    products = len(pts) * 2 * (4 + 128) * P_DOUBLE
    for p, k in zip(pts, ks):
        if p is None:
            continue
        halves = glv_split(k)
        adds = sum(max(0, sum(1 for w in range(33) if ((abs(h) + eights) >> (4 * w)) & 15 != 8) - 1)
                   for h in halves)
        products += 1 + (2 * 3 + adds + all(halves)) * P_ADD
    return products
