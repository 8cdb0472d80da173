"""SPMD pipelines over torch.distributed ranks (counterpart of
fhe_si_tpu/parallel): mesh.py lays the ranks out on named axes, shard.py
runs mul+relin with the CRT prime axis or the phi(m) axis sharded, and
run_distributed.py starts one rank of a world from the command line."""
from .mesh import (Mesh, make_coeff_mesh, make_mesh,  # noqa: F401
                   shard_batched_parts, shard_limb, shard_matrix,
                   sharded_mul_relin)
from .shard import (CoeffShardedPipelines, ShardedPipelines,  # noqa: F401
                    coeff_sharded_ntt, ct_coeff_sharded_ntt)
