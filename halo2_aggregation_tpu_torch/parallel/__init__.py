"""Multi-device scaling: mesh-sharded MSM and batched multi-proof verification.

Counterpart of `halo2_aggregation_tpu/parallel/`, on `torch.distributed`:
proofs sharded over a `dp` mesh axis, MSM lanes over `mp`.  The JAX package
has one controller over every device; here each rank is a process
(`mesh.run_ranks` starts and joins them), holds the whole batch as a JAX
caller holds a global array, computes its shard, and the partial sums meet
in `all_gather`s over the mesh's process groups.
"""
