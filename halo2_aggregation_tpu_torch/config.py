"""Framework configuration: one dataclass, no magic numbers.

Every knob that bench.py / examples / __graft_entry__.py / tests thread
through the stack lives here (SURVEY.md §5 "config/flag system").  Env
vars override defaults so the driver and CI can steer runs without code
changes; `H2AConfig.from_env()` is the single parsing point.

Reference analog: the constants scattered through
`reference/examples/simple-example.rs` (k=9 inner :560, k=23 outer
:654, 68-bit limbs :27-35) — here they are explicit and overridable.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, str(default)))


def _env_bool(name: str, default: bool) -> bool:
    return os.environ.get(name, "1" if default else "0") == "1"


@dataclass(frozen=True)
class H2AConfig:
    # circuit shape
    k_inner: int = 9  # simple-example.rs:560
    # The reference needs k=23 for the outer circuit (simple-example.rs:654);
    # GLV + windowed in-circuit MSMs fit the same statement in k=21 here
    # (H2A_OUTER_K=23 reproduces the reference's size).
    k_outer: int = 21
    num_proofs: int = 1  # inner proofs per outer circuit

    constrained_fs: bool = field(
        default_factory=lambda: _env_bool("H2A_CONSTRAINED_FS", True)
    )  # Poseidon transcript with in-circuit challenge enforcement (our
    # upgrade over the reference's unconstrained transcript.rs:62-65);
    # 0 = reference-parity Blake2b mode

    @classmethod
    def from_env(cls, **overrides) -> "H2AConfig":
        # an overridden num_proofs must drive the derived k_outer too
        # (ADVICE r4: computing k before merging overrides yielded an
        # undersized default k for `from_env(num_proofs=...)` callers)
        num_proofs = overrides.get(
            "num_proofs", _env_int("H2A_NUM_PROOFS", cls.num_proofs)
        )
        # Each proof costs ~1,300,406 rows (docs/AGGREGATION_SCALING.md),
        # so the default outer k grows by ceil(log2 N): N=1->21, 2->22,
        # 4->23, 8->24.  An explicit H2A_OUTER_K or k_outer override
        # always wins.
        k_outer_default = cls.k_outer + (num_proofs - 1).bit_length()
        cfg = cls(
            k_inner=_env_int("H2A_INNER_K", cls.k_inner),
            k_outer=_env_int("H2A_OUTER_K", k_outer_default),
            num_proofs=num_proofs,
        )
        if overrides:
            from dataclasses import replace

            cfg = replace(cfg, **overrides)
        return cfg
