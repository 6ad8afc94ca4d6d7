"""Distributed helpers of the port.

So far only the artifact manifests of ``repro.distributed.checkpoint``
(:mod:`repro_torch.distributed.checkpoint`), which the versioned artifact
store needs; the ring MVM, sharding and multi-process checkpoints come with
the distributed slice.
"""
