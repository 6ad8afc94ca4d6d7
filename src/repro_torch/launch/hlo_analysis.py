"""Roofline terms of the dry-run; port of ``repro.launch.hlo_analysis``.

The reference reads flops and bytes from XLA's ``cost_analysis`` of a
compiled SPMD module, memory from its ``memory_analysis`` and collectives
from a regex over the partitioned HLO text. The port has no compiler, so:

* flops and bytes come from :class:`CostCounter`, a ``TorchDispatchMode``
  run over the pieces under fake tensors: flops by torch's own formulas
  (``torch.utils.flop_counter.flop_registry``, what ``FlopCounterMode``
  counts: matrix products, convolutions, attention), bytes as each
  non-view op's inputs plus outputs (an unfused count; an update in place
  counts its other inputs twice), and the high-water mark of live tensor
  bytes the run made;
* memory (:func:`extract_memory`) is the sum, per position, of every
  argument's and output's piece under its placement;
* collectives are derived from the sharding policy by
  :mod:`repro_torch.launch.analysis`; there is no HLO text, so the
  reference's regex has no input here and is not ported. Each collective
  is costed by the reference's byte model (:func:`collective_bytes`).

Per-collective per-chip transmitted-byte model (bidirectional ring):
  all-reduce       2 * out_bytes * (G-1)/G
  all-gather       out_bytes * (G-1)/G
  reduce-scatter   out_bytes * (G-1)        (= in_bytes * (G-1)/G)
  all-to-all       out_bytes * (G-1)/G
  collective-permute  out_bytes             (one hop)

Terms (seconds):
  compute    = flops_per_chip / peak_flops          [chips cancel]
  memory     = bytes_per_chip / hbm_bw
  collective = coll_bytes_per_chip / link_bw
with the H100's peaks (:mod:`repro_torch.launch.mesh`).
"""
from __future__ import annotations

import json
import weakref
from dataclasses import asdict, dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.launch.mesh import HBM_BW, ICI_BW, PEAK_BF16_FLOPS

_DTYPE_BYTES = {
    torch.bool: 1, torch.int8: 1, torch.uint8: 1, torch.int16: 2,
    torch.bfloat16: 2, torch.float16: 2, torch.int32: 4, torch.float32: 4,
    torch.int64: 8, torch.float64: 8, torch.complex64: 8,
    torch.complex128: 16,
}

# Bytes per pointer of the output tuple's index table, which XLA counts in
# ``output_size_in_bytes`` (one per output leaf).
OUTPUT_TABLE_BYTES = 8


def collective_bytes(op: str, out_bytes: float, g: int) -> float:
    """Per-chip bytes a collective moves: the reference's model."""
    g = max(2, g)
    if op == "all-reduce":
        return 2.0 * out_bytes * (g - 1) / g
    if op == "all-gather":
        return out_bytes * (g - 1) / g
    if op == "reduce-scatter":
        return out_bytes * (g - 1)
    if op == "all-to-all":
        return out_bytes * (g - 1) / g
    return float(out_bytes)  # collective-permute


@dataclass
class CollectiveStats:
    counts: dict = field(default_factory=dict)
    bytes_per_chip: float = 0.0
    by_op_bytes: dict = field(default_factory=dict)

    def add(self, op: str, out_bytes: float, g: int, times: int = 1) -> None:
        """``times`` collectives ``op`` of ``out_bytes`` over a group of
        ``g`` positions; a group of one moves nothing and is not counted."""
        if g <= 1 or times <= 0:
            return
        b = collective_bytes(op, out_bytes, g) * times
        self.counts[op] = self.counts.get(op, 0) + times
        self.by_op_bytes[op] = self.by_op_bytes.get(op, 0.0) + b
        self.bytes_per_chip += b


@dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_chip: float
    bytes_per_chip: float
    collective_bytes_per_chip: float
    collective_counts: dict
    collective_by_op: dict
    # memory analysis (per chip, bytes)
    argument_bytes: int = 0
    output_bytes: int = 0
    temp_bytes: int = 0
    peak_bytes: int = 0
    # derived terms (seconds)
    t_compute: float = 0.0
    t_memory: float = 0.0
    t_collective: float = 0.0
    bottleneck: str = ""
    model_flops: float = 0.0  # 6 * N_active * D (global)
    useful_fraction: float = 0.0  # model_flops / (flops_per_chip * chips)
    roofline_fraction: float = 0.0  # t_compute_model / max(terms)
    notes: str = ""

    def finalise(self):
        self.t_compute = self.flops_per_chip / PEAK_BF16_FLOPS
        self.t_memory = self.bytes_per_chip / HBM_BW
        self.t_collective = self.collective_bytes_per_chip / ICI_BW
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        self.bottleneck = max(terms, key=terms.get)
        total_flops = self.flops_per_chip * self.chips
        if total_flops > 0 and self.model_flops > 0:
            self.useful_fraction = self.model_flops / total_flops
            ideal = self.model_flops / (self.chips * PEAK_BF16_FLOPS)
            self.roofline_fraction = ideal / max(
                max(terms.values()), 1e-30
            )
        return self

    def to_json(self) -> str:
        return json.dumps(asdict(self), indent=2)


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * _DTYPE_BYTES.get(t.dtype, t.element_size())


# Op classes that the accounting divides over different positions: a
# product with a weight (rows over DP, the weight's TP dimension over
# "model") and a batched product of activations (attention, the SSD).
WEIGHT_PRODUCTS = frozenset({"mm", "addmm"})
BATCHED_PRODUCTS = frozenset({"bmm", "baddbmm"})


class CostCounter(TorchDispatchMode):
    """Global flops (per op class: ``weight``, ``batched``, ``other``),
    bytes and the live-bytes high-water mark of the ops run under it.

    Live bytes are those of storages the ops made while the counter was
    on, each counted once however many views share it, freed when the
    storage dies (a weak reference): what the run itself added to the
    memory its inputs already held.
    """

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self._registry = flop_registry
        self.flops = {"weight": 0, "batched": 0, "other": 0}
        self.bytes = {"weight": 0, "batched": 0, "other": 0}
        self.live = 0
        self.peak = 0
        self._storages: dict = {}

    @property
    def total_flops(self) -> int:
        return sum(self.flops.values())

    def _free(self, key) -> None:
        self.live -= self._storages.pop(key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func._overloadpacket
        name = packet.__name__
        cls = ("weight" if name in WEIGHT_PRODUCTS else
               "batched" if name in BATCHED_PRODUCTS else "other")
        if packet in self._registry:
            self.flops[cls] += int(self._registry[packet](*args, **kwargs,
                                                          out_val=out))
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        # a view or an in-place op returns its input's storage: no new bytes
        held = {t.untyped_storage()._cdata for t in ins}
        mutated = {t.untyped_storage()._cdata for t in outs} & held
        if mutated and not func.is_view:
            # an update in place (a cache slot, an accumulator): its other
            # inputs read and written into the target once
            self.bytes[cls] += 2 * sum(
                _nbytes(t) for t in ins
                if t.untyped_storage()._cdata not in mutated)
        elif outs and not func.is_view:  # not a metadata query
            self.bytes[cls] += (sum(_nbytes(t) for t in ins)
                                + sum(_nbytes(t) for t in outs))
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in self._storages or key in held:
                continue
            self._storages[key] = st.nbytes()
            self.live += st.nbytes()
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key)
        return out


def extract_cost(counter: CostCounter, divisors: dict) -> tuple:
    """(flops, bytes) per chip: each op class's global count over the
    positions the policy splits that class's work across."""
    flops = sum(counter.flops[k] / divisors[k] for k in counter.flops)
    byts = sum(counter.bytes[k] / divisors[k] for k in counter.bytes)
    return float(flops), float(byts)


def extract_memory(args, outputs, donated, temp_bytes: int) -> dict:
    """The reference's ``memory_analysis`` fields per chip from the
    placements: ``args`` / ``outputs`` / ``donated`` are lists of (tensor,
    placement) pairs (``donated``: the arguments whose buffers the outputs
    reuse, as ``donate_argnums``), ``temp_bytes`` the estimate of the
    rest. Output bytes include XLA's index table (8 bytes an output)."""
    def per_position(pairs) -> int:
        return sum(sh.shard_bytes(t) for t, sh in pairs)

    arg = per_position(args)
    out = per_position(outputs) + OUTPUT_TABLE_BYTES * len(outputs)
    alias = per_position(donated)
    tmp = int(temp_bytes)
    return {
        "argument_bytes": arg,
        "output_bytes": out,
        "temp_bytes": tmp,
        "peak_bytes": arg + out + tmp - alias,
    }
