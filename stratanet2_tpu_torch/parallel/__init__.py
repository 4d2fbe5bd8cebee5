"""The parallel paths of the port (counterpart of `stratanet2_tpu/parallel/`):
data parallelism and point sharding over `torch.distributed` process
groups. `multihost` starts the group, `mesh` lays ranks out as a (batch x
points) grid, `collectives` are the psum / pmax / all_gather of JAX's
`shard_map`, `point_sharded` the point-sharded ops, forward and train step,
`launch` starts ranks as processes and `dryrun` drives every path once."""
