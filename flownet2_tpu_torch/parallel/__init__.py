"""Data-parallel training over one process per card (flownet2_tpu/parallel).

The reference trains on several GPUs with P2PSync: one solver thread per
GPU, one flat gradient buffer reduced over a tree of device copies
(SURVEY.md section 2.4). The JAX package declares a mesh and XLA places one
fused ``psum`` in the step. The port runs one process per card in a
``torch.distributed`` group, and a step crosses it twice: one flat gradient
``all_reduce`` and one small stats ``all_reduce`` (``data_parallel``).

- ``mesh``          — ``--gpu`` device picking, the group's rank, world,
                      device and backend, and its initialisation;
- ``data_parallel`` — the broadcast from rank 0, a rank's rows of a batch,
                      the two collectives, and ``spawn``.

Not ported, by design: ``annotate.py`` (activation sharding constraints are
GSPMD layout hints, with no counterpart in per-rank data parallelism) and
the ``spatial`` mesh axis with its halo warp (flownet2_tpu/ops/warp.py:215),
which shards one image over several devices and has no use on a one-card
host.
"""

from flownet2_tpu_torch.parallel.data_parallel import (
    REPLICATED_BATCH_KEYS,
    RankFailed,
    allreduce_gradients,
    allreduce_stats,
    broadcast_module,
    gather_to_main,
    rank_rows,
    spawn,
)
from flownet2_tpu_torch.parallel.mesh import DEFAULT_TIMEOUT, Group, default_backend, init_group, pick_devices

__all__ = [
    "DEFAULT_TIMEOUT",
    "Group",
    "REPLICATED_BATCH_KEYS",
    "RankFailed",
    "allreduce_gradients",
    "allreduce_stats",
    "broadcast_module",
    "default_backend",
    "gather_to_main",
    "init_group",
    "pick_devices",
    "rank_rows",
    "spawn",
]
