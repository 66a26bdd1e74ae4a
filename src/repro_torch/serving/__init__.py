"""Fleet-scale serving over the uniform Deployment API (port of
``repro/serving``, DESIGN.md §14).

The subsystem that turns single accelerators into a farm: a bounded
admission queue with deadlines (:mod:`repro_torch.serving.queue`), a
dynamic micro-batcher packing ragged windows per (design, window-length
bucket) into single dispatches (:mod:`repro_torch.serving.batcher`), a
program-cache affinity router over healthy pool members
(:mod:`repro_torch.serving.router`), the tick-driven farm runtime composing
them (:mod:`repro_torch.serving.farm`), batch splitting over several
devices (:mod:`repro_torch.serving.shard`), the health-aware
:class:`DeploymentPool` rebuilt on the same primitives
(:mod:`repro_torch.serving.pool`), and the seeded mixed-traffic load
generator (``python -m repro_torch.serving.loadgen``). On the card each
dispatch of an RTL member is one CUDA Graph replay of its emulator's walk
(B1 and B2).
"""
from repro_torch.serving.batcher import (MicroBatch, MicroBatcher,
                                         bucket_for, pack, pad_window,
                                         padded_batch_size, unpack)
from repro_torch.serving.farm import (AcceleratorFarm, DesignPool,
                                      FarmConfig, FarmStats)
from repro_torch.serving.pool import DeploymentPool, PoolStats
from repro_torch.serving.queue import (DONE, EXPIRED, FAILED, QUEUED, SHED,
                                       AdmissionQueue, ServeRequest)
from repro_torch.serving.router import (AffinityRouter, NoServeableMember,
                                        member_holds_program)
from repro_torch.serving.shard import ShardedExecutable, make_serving_mesh

__all__ = [
    "AcceleratorFarm", "AdmissionQueue", "AffinityRouter", "DeploymentPool",
    "DesignPool", "FarmConfig", "FarmStats", "MicroBatch", "MicroBatcher",
    "NoServeableMember", "PoolStats", "ServeRequest", "ShardedExecutable",
    "bucket_for", "make_serving_mesh", "member_holds_program", "pack",
    "pad_window", "padded_batch_size", "unpack",
    "QUEUED", "DONE", "SHED", "EXPIRED", "FAILED",
]
