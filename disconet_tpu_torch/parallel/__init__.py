"""Data, agent and spatial parallelism over ``torch.distributed`` (the JAX
package's ``disconet_tpu.parallel``)."""

from disconet_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    attach_mesh,
    batch_sharding,
    batch_specs,
    make_mesh,
    replicate_tree,
    replicated,
    shard_batch,
)
from disconet_tpu_torch.parallel.spatial import (  # noqa: F401
    conv2d_spatial_sharded,
    halo_exchange,
    sharded_conv_fn,
)
