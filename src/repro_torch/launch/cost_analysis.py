"""Cost of a function run on meta tensors: FLOPs and the peak of live bytes.

Counterpart of ``repro.launch.hlo_analysis``.  The reference compiles a
step and reads its HLO text (dot and convolution FLOPs, loop trip counts,
collective bytes); torch has no HLO, so ``analyze`` runs the function
itself on meta tensors (shapes and dtypes, no storage, no arithmetic) and
watches every op it dispatches:

* FLOPs, by op and by the dtype of the op's inputs, by
  ``torch.utils.flop_counter.FlopCounterMode``'s per-op formulas (its
  ``flop_registry``: matmul-like ops only, as the reference counts dots
  and convolutions only; a loop's body is counted once a trip because it
  runs once a trip).  The formulas are applied here, in one dispatch mode
  with the byte count: ``FlopCounterMode`` itself hooks every module's
  output for its per-module table, which keeps alive the activations a
  remat frees (the whisper-medium step's estimate read 65.7 GB of
  temporaries under it, 16.3 GB without);
* the peak of live bytes: every storage an op makes is counted from its
  creation until it is freed, above the storages of the arguments, which
  stay alive throughout (the caller holds them);
* the bytes of the function's outputs and of the argument storages it
  writes in place, for a bound that reads each argument once and writes
  each output once.

No collectives: the port's one-card paths have none (the hybrid step's
exchange counts its own bytes, ``training.trainer.make_hybrid_train_step``).
"""

from __future__ import annotations

import weakref
from collections import Counter

import torch
from torch import nn
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.launch.mesh import HBM_BW, PEAK_FLOPS_BF16, PEAK_FLOPS_F32

# the card's peak rate for a product's input dtype (fp32 products stay off
# TF32); any other dtype at the fp32 rate
PEAK_FLOPS = {torch.bfloat16: PEAK_FLOPS_BF16, torch.float16: PEAK_FLOPS_BF16,
              torch.float32: PEAK_FLOPS_F32}


def tensors(tree):
    """The tensors of a tree of dicts, tuples and lists whose leaves are
    tensors or ``nn.Module``s (their parameters and buffers)."""
    if isinstance(tree, nn.Module):
        yield from tree.parameters()
        yield from tree.buffers()
    elif isinstance(tree, dict):
        for leaf in tree.values():
            yield from tensors(leaf)
    elif isinstance(tree, (tuple, list)):
        for leaf in tree:
            yield from tensors(leaf)
    elif isinstance(tree, torch.Tensor):
        yield tree


def storage_bytes(tree) -> int:
    """The bytes of the distinct storages under ``tree`` (a view adds none)."""
    seen = WeakIdKeyDictionary()
    for t in tensors(tree):
        seen[t.untyped_storage()] = t.untyped_storage().nbytes()
    return sum(seen.values())


class _Cost(TorchDispatchMode):
    """Counts the FLOPs of every product by op and input dtype, the bytes
    of every storage an op makes while it lives (a weak finalizer takes it
    off when it is freed), and the argument storages an op writes in
    place."""

    def __init__(self, args):
        super().__init__()
        self.args = WeakIdKeyDictionary()
        for t in tensors(args):
            self.args[t.untyped_storage()] = t.untyped_storage().nbytes()
        self.made = WeakIdKeyDictionary()
        self.written = WeakIdKeyDictionary()
        self.live = self.peak = 0
        self.flops: Counter = Counter()  # (op, dtype) -> FLOPs

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        op = func._overloadpacket
        if op in flop_registry:
            dtype = next(a.dtype for a in tree_leaves((args, kwargs))
                         if isinstance(a, torch.Tensor) and a.is_floating_point())
            self.flops[(str(op), dtype)] += flop_registry[op](*args, **kwargs, out_val=out)
        for i, arg in enumerate(func._schema.arguments):
            if arg.alias_info is None or not arg.alias_info.is_write:
                continue
            x = args[i] if i < len(args) else kwargs.get(arg.name)
            if isinstance(x, torch.Tensor) and x.untyped_storage() in self.args:
                self.written[x.untyped_storage()] = self.args[x.untyped_storage()]
        for t in tree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            if st in self.args or st in self.made:
                continue
            n = st.nbytes()
            self.made[st] = n
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, n)
        return out


def analyze(fn, *args) -> dict:
    """Run ``fn(*args)`` (meta tensors, or modules holding them) and return
    its cost: ``flops`` (total), ``flops_by_op``, ``flops_by_dtype``,
    ``argument_bytes`` (the arguments' storages), ``output_bytes`` (new
    storages in the result, and argument storages written in place),
    ``temp_peak_bytes`` (the most bytes the function's own storages held at
    once) and ``peak_bytes`` (arguments plus that)."""
    cost = _Cost(args)
    with cost:
        out = fn(*args)
        made = WeakIdKeyDictionary()
        for t in tensors(out):
            if t.untyped_storage() in cost.made:
                made[t.untyped_storage()] = cost.made[t.untyped_storage()]
        output_bytes = sum(made.values()) + sum(cost.written.values())
        del out, made
    by_op: Counter = Counter()
    by_dtype: Counter = Counter()
    for (op, dtype), n in cost.flops.items():
        by_op[op] += n
        by_dtype[str(dtype).replace("torch.", "")] += n
    arg_bytes = sum(cost.args.values())
    return {
        "flops": float(sum(by_op.values())),
        "flops_by_op": {op: float(n) for op, n in by_op.items()},
        "flops_by_dtype": {dt: float(n) for dt, n in by_dtype.items()},
        "argument_bytes": arg_bytes,
        "output_bytes": output_bytes,
        "temp_peak_bytes": cost.peak,
        "peak_bytes": arg_bytes + cost.peak,
    }


def bound_ms(cost: dict) -> tuple[float, str]:
    """The least time (ms) one H100 takes for the work ``cost`` counts: the
    larger of its products at the card's peak rate for their dtype and its
    bytes (each argument read once, each output written once) at the HBM
    rate; and which of the two ("operations" or "bytes") bounds it."""
    ops_s = sum(n / PEAK_FLOPS.get(getattr(torch, dt), PEAK_FLOPS_F32)
                for dt, n in cost["flops_by_dtype"].items())
    bytes_s = (cost["argument_bytes"] + cost["output_bytes"]) / HBM_BW
    return max(ops_s, bytes_s) * 1e3, "operations" if ops_s >= bytes_s else "bytes"
