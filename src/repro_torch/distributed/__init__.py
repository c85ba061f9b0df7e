from repro_torch.distributed.compression import (  # noqa: F401
    ef_compressed, quantize, dequantize, shard_layer_solves)
from repro_torch.distributed.straggler import (  # noqa: F401
    StragglerMonitor, StragglerReport)
