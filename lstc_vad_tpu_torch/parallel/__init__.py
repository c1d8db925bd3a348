"""Multi-device runs over torch.distributed: the (data, model) mesh, the
tensor-parallel rules and collectives, process-group set-up and the
multi-process rehearsal (``dryrun``)."""

from .mesh import (batch_sharding, factor_devices,  # noqa: F401
                   make_mesh, param_sharding_rules, shard_params)
