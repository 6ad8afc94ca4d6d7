"""The port's distributed package; port of ``repro.distributed``.

One process drives a :class:`~repro_torch.launch.mesh.Mesh` of devices
(see :mod:`repro_torch.launch.mesh`): :mod:`.sharding` (axis helpers and
:class:`RowSharded` tensors), :mod:`.ring` (the hierarchical ring MVM),
:mod:`.gp_step` (the distributed GP outer step), :mod:`.ap` (per-shard
greedy AP), :mod:`.elastic` (re-sharding between meshes),
:mod:`.compression` (bf16 error feedback) and :mod:`.checkpoint`
(content-hash manifests). The checkpoints themselves are
:mod:`repro_torch.checkpoint`'s, re-exported here as the reference does.
"""
from repro_torch.checkpoint import (
    latest_step,
    load_metadata,
    restore_checkpoint,
    save_checkpoint,
)
from repro_torch.distributed.compression import (
    EFState,
    compress,
    decompress,
    ef_init,
)
from repro_torch.distributed.elastic import (
    reshard,
    row_sharded_builder,
    unshard,
)
from repro_torch.distributed.sharding import (
    RowSharded,
    get_global_mesh,
    set_global_mesh,
    shard_rows,
    valid_spec,
)

__all__ = [
    "latest_step", "load_metadata", "restore_checkpoint", "save_checkpoint",
    "EFState", "compress", "decompress", "ef_init",
    "reshard", "row_sharded_builder", "unshard",
    "RowSharded", "get_global_mesh", "set_global_mesh", "shard_rows",
    "valid_spec",
]
