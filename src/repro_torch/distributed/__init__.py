"""The port's distributed package; port of ``repro.distributed``.

One process drives a :class:`~repro_torch.launch.mesh.Mesh` of devices
(see :mod:`repro_torch.launch.mesh`): :mod:`.sharding` (axis helpers,
the model policy's logical axes and :class:`RowSharded` tensors),
:mod:`.ring` (the hierarchical ring MVM), :mod:`.gp_step` (the distributed
GP outer step), :mod:`.ap` (per-shard greedy AP), :mod:`.elastic`
(re-sharding between meshes), :mod:`.compression` (bf16 error feedback)
and :mod:`.checkpoint` (checkpoints of any tree of tensors and their
content-hash manifests).
"""
from repro_torch.distributed.checkpoint import (
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
    DP,
    FSDP,
    TP,
    RowSharded,
    constrain,
    get_global_mesh,
    set_global_mesh,
    shard_rows,
    valid_spec,
)

__all__ = [
    "latest_step", "load_metadata", "restore_checkpoint", "save_checkpoint",
    "EFState", "compress", "decompress", "ef_init",
    "reshard", "row_sharded_builder", "unshard",
    "DP", "FSDP", "TP", "constrain", "RowSharded", "get_global_mesh",
    "set_global_mesh", "shard_rows", "valid_spec",
]
