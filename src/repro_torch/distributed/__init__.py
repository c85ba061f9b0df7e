from repro_torch.distributed.compression import shard_layer_solves  # noqa: F401
