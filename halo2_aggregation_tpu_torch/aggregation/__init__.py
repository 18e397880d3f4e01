"""In-circuit proof verification — the aggregation layer.

Re-creation of the reference crate's actual product (SURVEY.md §2a): a
circuit over Fr that replays the halo2-KZG verification of an inner proof
using non-native RNS arithmetic gadgets, exposing the deferred-pairing quad
`(e, f, w, zw)` through the instance column
(`reference/src/verifier.rs:739-754`).

gadgets/   main gate, range chip, RNS integer chip, EC chip
           (our re-design of the halo2wrong surface in SURVEY.md §2b)
chips      transcript/lookup/permutation/vanishing/multiopen/verifier chips
circuit    SingleProofCircuit — the outer aggregation circuit
"""
