"""Three-term roofline of one step on a mesh (``repro.roofline.analysis``
counterpart):

    compute    = FLOPs a rank does / peak FLOP/s
    memory     = bytes a rank moves / HBM bandwidth
    collective = collective bytes a rank receives / link bandwidth

The reference reads these from XLA's compiled module (``from_compiled``,
``collective_bytes``, ``hlo_op_count``, ``memory_stats`` and
``roofline/hlo.py`` parse HLO text and ``cost_analysis``).  PyTorch has no
compiled module to read, so those get no counterpart here; ``trace_step``
takes their place: it runs the step once on ``FakeTensorMode`` tensors
over a mesh (no memory, no kernel) and records, for every aten op a rank
runs, its FLOPs (``torch.utils.flop_counter``'s formulas) and the bytes
of its operands and results (``op_bytes``: the reference's
``bytes accessed``, op by op with no fusion, so more than a fused program
moves), the collectives DTensor and the explicit regions issue, by kind
with the bytes of their outputs (the reference's convention), the
per-rank bytes of the step's inputs and outputs, and the most bytes a
rank holds live at once (``peak_bytes``: every tensor the step keeps,
saved activations included; no allocator rounding).
``from_trace`` builds the ``Roofline`` from the FLOPs, ``op_bytes`` and
the collective bytes; ``fits`` compares the peak with the card's memory.

Hardware constants: the NVIDIA H100 SXM5 80GB's data-sheet peaks, the
card the port runs on (they replace the reference's TPU v5e constants).
``train_model_flops`` / ``prefill_model_flops`` / ``decode_model_flops``
(6·N·D, 2·N·D) and ``layout_comparison`` are the reference's.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

# --- NVIDIA H100 SXM5 80GB ---------------------------------------------------
PEAK_FLOPS = 989.4e12        # dense bf16 FLOP/s per card
HBM_BW = 3.35e12             # HBM3 bytes/s per card
HBM_BYTES = 80e9             # HBM3 bytes per card
NVLINK_BW = 450e9            # NVLink bytes/s per card, one direction

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")


@dataclasses.dataclass
class Roofline:
    flops: float                      # FLOPs a rank does
    bytes_accessed: float             # bytes a rank moves
    coll_bytes: dict[str, int]        # per-rank collective bytes by kind
    chips: int
    model_flops: float = 0.0          # 6·N·D useful FLOPs (whole step)

    @property
    def t_compute(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.bytes_accessed / HBM_BW

    @property
    def t_collective(self) -> float:
        return sum(self.coll_bytes.values()) / NVLINK_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_ratio(self) -> Optional[float]:
        """MODEL_FLOPS / (chips × FLOPs a rank) — redundancy waste."""
        if not self.model_flops or not self.flops:
            return None
        return self.model_flops / (self.chips * self.flops)

    def as_dict(self) -> dict:
        return {
            "flops_per_chip": self.flops,
            "bytes_per_chip": self.bytes_accessed,
            "collective_bytes": self.coll_bytes,
            "chips": self.chips,
            "model_flops": self.model_flops,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "dominant": self.dominant,
            "useful_ratio": self.useful_ratio,
        }


def from_trace(trace: dict, chips: int, model_flops: float = 0.0
               ) -> Roofline:
    """The roofline of a ``trace_step`` trace."""
    return Roofline(flops=float(trace["flops"]),
                    bytes_accessed=float(trace["op_bytes"]),
                    coll_bytes={k: int(v) for k, v in
                                trace["collectives"]["bytes"].items()},
                    chips=chips, model_flops=model_flops)


def layout_comparison(tree: Roofline, flat: Roofline,
                      conversion_bytes: Optional[float] = None) -> dict:
    """The flat-vs-tree layout comparison: the flat round's memory and
    collective bytes next to the tree round's (ratios < 1: the
    single-buffer round moves fewer bytes for the same arithmetic).
    ``conversion_bytes`` is the loss boundary's extra bytes over the tree
    ``value_and_grad``, where measured."""
    coll_t = sum(tree.coll_bytes.values())
    coll_f = sum(flat.coll_bytes.values())
    out = {
        "tree_bytes": tree.bytes_accessed,
        "flat_bytes": flat.bytes_accessed,
        "bytes_ratio": (flat.bytes_accessed / tree.bytes_accessed
                        if tree.bytes_accessed else None),
        "tree_collective_bytes": coll_t,
        "flat_collective_bytes": coll_f,
        "collective_ratio": coll_f / coll_t if coll_t else None,
        "tree_t_memory_s": tree.t_memory,
        "flat_t_memory_s": flat.t_memory,
        "tree_t_collective_s": tree.t_collective,
        "flat_t_collective_s": flat.t_collective,
    }
    if conversion_bytes is not None:
        out["conversion_bytes"] = conversion_bytes
        out["conversion_fraction_of_flat"] = (
            conversion_bytes / flat.bytes_accessed
            if flat.bytes_accessed else None)
    return out


# ---------------------------------------------------------------------------
# MODEL_FLOPS (6·N·D) helpers
# ---------------------------------------------------------------------------

def train_model_flops(cfg, tokens: int) -> float:
    """6·N_active·D for one FedaGrac round (all clients, all local steps)."""
    return 6.0 * cfg.active_param_count() * tokens


def prefill_model_flops(cfg, tokens: int) -> float:
    return 2.0 * cfg.active_param_count() * tokens


def decode_model_flops(cfg, batch: int) -> float:
    return 2.0 * cfg.active_param_count() * batch


# ---------------------------------------------------------------------------
# the trace of one step on fake tensors
# ---------------------------------------------------------------------------

def _collective_kinds() -> dict:
    """aten / c10d op → the reference's collective kind."""
    import torch
    f = torch.ops._c10d_functional
    c = torch.ops.c10d
    return {
        f.all_gather_into_tensor.default: "all-gather",
        f.all_reduce.default: "all-reduce",
        f.reduce_scatter_tensor.default: "reduce-scatter",
        f.all_to_all_single.default: "all-to-all",
        f.broadcast.default: "collective-permute",
        c.allreduce_.default: "all-reduce",
        c.allgather_.default: "all-gather",
        c._allgather_base_.default: "all-gather",
        c._reduce_scatter_base_.default: "reduce-scatter",
        c.alltoall_base_.default: "all-to-all",
        c.broadcast_.default: "collective-permute",
    }


def fits(trace: dict) -> bool:
    """Whether a rank's live bytes at the trace's peak fit in the card's
    memory (``HBM_BYTES``)."""
    return trace["peak_bytes"] <= HBM_BYTES


# ops that move no bytes though they are not marked as views: a reshape
# that aliases, and allocations that write nothing
_NO_BYTES = {"aten::_unsafe_view", "aten::empty", "aten::empty_strided",
             "aten::empty_like", "aten::new_empty", "aten::new_empty_strided"}


def _moves_bytes(func, out) -> bool:
    """Whether the op ``func`` that returned ``out`` reads or writes tensor
    data: not a view, an aliasing reshape, an allocation or a query of
    metadata (one that returns no tensor)."""
    import torch
    if func.is_view or func._schema.name in _NO_BYTES:
        return False
    outs = out if isinstance(out, (list, tuple)) else (out,)
    return any(isinstance(o, torch.Tensor) for o in outs)


def _tensor_bytes(args) -> int:
    """Bytes of the tensors among ``args`` (lists and tuples opened)."""
    import torch
    total = 0
    stack = list(args)
    while stack:
        x = stack.pop()
        if isinstance(x, (list, tuple)):
            stack.extend(x)
        elif isinstance(x, torch.Tensor):
            total += x.numel() * x.element_size()
    return total


class _Live:
    """The bytes of the storages the traced ops made that are still alive,
    and their peak: each new storage is added when an op returns it, and
    after every op the dead ones are dropped before the peak is read."""

    def __init__(self):
        self.refs: dict = {}
        self.live = self.peak = 0

    def add(self, tensors) -> None:
        import torch
        from torch.multiprocessing.reductions import StorageWeakRef
        stack = [tensors]
        while stack:
            x = stack.pop()
            if isinstance(x, (list, tuple)):
                stack.extend(x)
            elif isinstance(x, dict):
                stack.extend(x.values())
            elif isinstance(x, torch.Tensor):
                if hasattr(x, "to_local"):
                    x = x.to_local()
                st = x.untyped_storage()
                key = st._cdata
                old = self.refs.get(key)
                if old is not None and not old[0].expired():
                    continue
                if old is not None:
                    self.live -= old[1]
                self.refs[key] = (StorageWeakRef(st), st.nbytes())
                self.live += st.nbytes()

    def step(self) -> None:
        for key in [k for k, (ref, _) in self.refs.items() if ref.expired()]:
            self.live -= self.refs.pop(key)[1]
        self.peak = max(self.peak, self.live)


def _nbytes(tree) -> int:
    import torch
    total = 0
    stack = [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
        elif isinstance(x, torch.Tensor):
            local = x.to_local() if hasattr(x, "to_local") else x
            total += local.numel() * local.element_size()
    return total


def trace_step(step: Callable, args: Sequence, pspecs: Sequence, mesh
               ) -> dict:
    """Run ``step(*args)`` once on fake tensors over ``mesh``.

    ``args`` are stand-ins (``meta`` tensors, the bundles' ``specs``) made
    fake on the mesh's device type; ``pspecs`` gives each argument's
    specs, or None for a replicated one, so the input bytes are the local
    shards'.  One dispatch mode sees every op below DTensor (it lets
    DTensor turn its ops into local ops and collectives first, as
    ``CommDebugMode`` does), so the figures are this rank's: the FLOPs of
    its local ops (``torch.utils.flop_counter``'s formulas), their operand
    and result bytes (a view, an allocation or a metadata query moves
    none; an in-place op's result is its operand), the collectives with their output bytes, and the live bytes
    at the peak (the inputs' shards counted from the start).  Returns
    ``{"flops", "op_bytes", "peak_bytes", "io_bytes", "in_bytes",
    "out_bytes", "collectives": {"count": {kind: n}, "bytes": {kind: b}},
    "ops"}`` (``ops``: the local aten ops)."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import flop_registry

    from repro_torch.launch import specs as specs_lib
    from repro_torch.launch.serve import place

    kinds = _collective_kinds()
    counts = {k: 0 for k in COLLECTIVES}
    nbytes = {k: 0 for k in COLLECTIVES}
    tally = {"flops": 0, "ops": 0, "bytes": 0}
    live = _Live()

    class _Rank(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, a=(), kw=None):
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented
            kw = kw or {}
            out = func(*a, **kw)
            tally["ops"] += 1
            if _moves_bytes(func, out):
                moved = _tensor_bytes(list(a) + list(kw.values()))
                if not func._schema.is_mutable:
                    moved += _tensor_bytes([out])
                tally["bytes"] += moved
            if not func.is_view:
                live.add(out)
            live.step()
            packet = getattr(func, "_overloadpacket", None)
            if packet in flop_registry:
                tally["flops"] += flop_registry[packet](*a, **kw,
                                                        out_val=out)
            kind = kinds.get(func)
            if kind is not None:
                counts[kind] += 1
                nbytes[kind] += _nbytes(out)
            return out

    device = torch.device(mesh.device_type)
    with FakeTensorMode(allow_non_fake_inputs=True):
        fake = specs_lib.map_with_path(
            lambda _p, t: (torch.empty(t.shape, dtype=t.dtype, device=device)
                           if isinstance(t, torch.Tensor) else t),
            list(args))
        placed = [a if ps is None else place(a, ps, mesh)
                  for a, ps in zip(fake, pspecs)]
        in_bytes = _nbytes(placed)
        live.add(placed)
        live.step()
        with _Rank():
            out = step(*placed)
        out_bytes = _nbytes(out)
    return {"flops": tally["flops"], "op_bytes": tally["bytes"],
            "peak_bytes": live.peak, "in_bytes": in_bytes,
            "out_bytes": out_bytes, "io_bytes": in_bytes + out_bytes,
            "collectives": {"count": counts, "bytes": nbytes},
            "ops": tally["ops"]}
