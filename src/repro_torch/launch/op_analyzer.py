"""Roofline inputs of one step run on `meta` tensors (counterpart of
`repro/launch/hlo_analyzer.py`, which reads them from compiled HLO).

The port has no HLO: `analyze` runs the step once under dispatch modes
that see every aten op it calls, on tensors that hold no data, and
counts

- FLOPs per device: `torch.utils.flop_counter`'s count of the matmul
  family (mm, bmm, addmm, baddbmm, convolutions, SDPA: the formulas of
  its `flop_registry`, which `FlopCounterMode` applies), plus the work
  the hand-written kernels' `meta` branches tally (`kernels/work.py`,
  the formulas `chip_smoke.py` bounds them by);
- bytes per device, an estimate with no fusion: every op that computes
  (not a view, not an allocation) reads its tensor operands once and
  writes its results once, plus the kernels' tallied bytes;
- peak live bytes per device: every storage the step allocates on the
  device, each rounded up to the CUDA caching allocator's 512-byte
  blocks (what `torch.cuda.max_memory_allocated` counts), held from the
  op that makes it until its last tensor dies (a finalizer on the
  storage), on top of the argument storages; the peak is the largest
  total after any op.

One dispatch mode does all three, and makes the result of a pointwise
op itself (`pointwise`): torch's meta functions for those are Python,
tens to hundreds of microseconds an op, and a loop of thousands of
steps (the sLSTM's recurrence) runs millions of them.

The reference's `while_trips` has no counterpart: a Python loop (the
stack's periods, the sLSTM's steps, the chunks) runs its body once a
trip, and each trip is counted as it runs. `xla_cost_analysis` has none
either; the FLOP and byte counts above take its place.
"""
from __future__ import annotations

import weakref
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import work

BLOCK = 512               # the CUDA caching allocator's rounding (bytes)
# ops that allocate without reading or writing data
_ALLOCS = {"empty", "empty_like", "empty_strided", "new_empty",
           "new_empty_strided"}


def rounded(nbytes: int) -> int:
    """A storage's size as the caching allocator holds it."""
    return -(-nbytes // BLOCK) * BLOCK if nbytes else 0


def _flat(args, kwargs) -> list:
    """The tensors among an aten op's arguments (lists one level
    deep)."""
    out = []
    for a in (*args, *kwargs.values()):
        if isinstance(a, torch.Tensor):
            out.append(a)
        elif isinstance(a, (list, tuple)):
            out.extend(t for t in a if isinstance(t, torch.Tensor))
    return out


def _outs(out) -> list:
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (list, tuple)):
        return [t for t in out if isinstance(t, torch.Tensor)]
    return []


def _broadcast(shapes) -> tuple:
    ndim = max(len(s) for s in shapes)
    out = [1] * ndim
    for s in shapes:
        for i, n in enumerate(s, ndim - len(s)):
            if n != 1:
                if out[i] != 1 and out[i] != n:
                    raise RuntimeError(f"shapes {shapes} do not broadcast")
                out[i] = n
    return tuple(out)


def _contiguous(shape) -> tuple:
    out, n = [], 1
    for d in reversed(shape):
        out.append(n)
        n *= max(d, 1)
    return tuple(reversed(out))


def _dense(shape, stride) -> bool:
    """Non-overlapping and dense: the dimensions, sorted by stride, step
    by the product of the sizes below them (size-1 dimensions aside)."""
    n = 1
    for d, st in sorted(((d, st) for d, st in zip(shape, stride) if d != 1),
                        key=lambda x: x[1]):
        if st != n:
            return False
        n *= d
    return True


def _out_strides(shape, tensors) -> tuple:
    """The strides torch's meta functions give the result of a pointwise
    op (`torch._prims_common.compute_elementwise_output_strides` on the
    operands broadcast to `shape`), on plain integers."""
    nd = len(shape)
    ex = []
    for t in tensors:
        pad = nd - t.dim()
        ex.append(tuple(0 if i < pad or (t.shape[i - pad] == 1 and
                                         shape[i] != 1)
                        else t.stride()[i - pad] for i in range(nd)))
    if nd < 2:
        return (1,) * nd
    if len(ex) == 1:
        return ex[0] if _dense(shape, ex[0]) else _contiguous(shape)

    def should_swap(a, b):
        for st in ex:
            sa, sb = st[a], st[b]
            if sa == 0 or sb == 0:
                continue
            if sa == sb:
                if shape[b] >= shape[a]:
                    continue
                return 1
            return -1 if sb > sa else 1
        return 0

    perm = list(reversed(range(nd)))
    for i in range(1, nd):
        d1 = i
        for d0 in reversed(range(i)):
            c = should_swap(perm[d0], perm[d1])
            if c > 0:
                perm[d0], perm[d1] = perm[d1], perm[d0]
                d1 = d0
            elif c < 0:
                break
    strides = [0] * nd
    n = 1
    for d in perm:                      # perm[0] is the fastest dimension
        strides[d] = n
        n *= max(shape[d], 1)
    return tuple(strides)


def _stand_in(x):
    """A one-element host stand-in of a `meta` tensor, its rank and dtype
    kept; anything else as it is."""
    if isinstance(x, torch.Tensor):
        return torch.zeros((1,) * x.dim(), dtype=x.dtype)
    if isinstance(x, (list, tuple)):
        return type(x)(_stand_in(t) for t in x)
    return x


def _sig(x):
    if isinstance(x, torch.Tensor):
        return (x.dtype, x.dim())
    if isinstance(x, (list, tuple)):
        return tuple(_sig(t) for t in x)
    return type(x)


class Pointwise:
    """Results of pointwise ops on `meta` tensors made directly: the
    broadcast shape, with the strides torch's meta functions give
    (`_out_strides`), in the dtype the op gives one-element host
    stand-ins (cached by the operands' dtypes and ranks and the scalars'
    types). `__call__` gives None for an op that writes an argument,
    gives several results or takes a memory format (a copy), or a tensor
    not on `meta`; the caller runs the op then."""

    def __init__(self):
        self._ops: dict = {}
        self._dtypes: dict = {}

    def __call__(self, func, args, kwargs, tensors):
        ok = self._ops.get(func)
        if ok is None:
            ok = self._ops[func] = (
                torch.Tag.pointwise in func.tags
                and not func._schema.is_mutable
                and len(func._schema.returns) == 1
                and not any(a.name == "memory_format"
                            for a in func._schema.arguments))
        if not ok or not tensors or \
                any(t.device.type != "meta" for t in tensors):
            return None
        shape = _broadcast([t.shape for t in tensors])
        key = (func, _sig(args), _sig(tuple(kwargs.items())))
        dtype = self._dtypes.get(key)
        if dtype is None:
            probe = func(*_stand_in(args),
                         **{k: _stand_in(v) for k, v in kwargs.items()})
            dtype = self._dtypes[key] = probe.dtype
        return torch.empty_strided(shape, _out_strides(shape, tensors),
                                   dtype=dtype, device="meta")


class OpCounter(TorchDispatchMode):
    """FLOPs of the matmul family, live device storages and unfused
    bytes of the ops run within.

    `track(tensors)` registers tensors made before (the step's
    arguments) as live; the peak starts at their total. Only storages on
    `meta` count (the step's device; host tensors are not its memory)."""

    def __init__(self):
        super().__init__()
        self.live = 0
        self.peak = 0
        self.bytes = 0
        self.flops = 0
        self._sizes: dict = {}          # id(storage) -> rounded bytes
        self._pointwise = Pointwise()

    def _add(self, t) -> None:
        """Count t's storage if it is new."""
        if t.device.type != "meta":
            return
        st = t.untyped_storage()
        key = id(st)
        if key in self._sizes:
            return
        size = rounded(st.nbytes())
        self._sizes[key] = size
        self.live += size
        weakref.finalize(st, self._free, key)

    def _free(self, key) -> None:
        self.live -= self._sizes.pop(key)

    def track(self, tensors) -> int:
        """Register existing tensors' storages; returns their bytes as
        held (rounded)."""
        from repro_torch.tree import tree_leaves
        before = self.live
        for t in tree_leaves(tensors):
            if isinstance(t, torch.Tensor):
                self._add(t)
        self.peak = max(self.peak, self.live)
        return self.live - before

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        ins = _flat(args, kwargs)
        out = self._pointwise(func, args, kwargs, ins)
        if out is None:
            out = func(*args, **kwargs)
        outs = _outs(out)
        for t in outs:
            self._add(t)
        if self.live > self.peak:
            self.peak = self.live
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += int(flop_registry[packet](*args, **kwargs,
                                                    out_val=out))
        if not func.is_view and packet.__name__ not in _ALLOCS \
                and func.namespace != "c10d":
            self.bytes += sum(t.numel() * t.element_size()
                              for t in (*ins, *outs))
        return out


@dataclass
class Analysis:
    matmul_flops: int = 0           # the matmul family
    kernel_flops: int = 0           # the kernels' tally
    op_bytes: int = 0               # unfused, ops outside the kernels
    kernel_bytes: int = 0
    peak_bytes: int = 0             # rounded, arguments included
    argument_bytes: int = 0         # rounded, as the tracker holds them
    kernels: dict = field(default_factory=dict)

    @property
    def flops(self) -> int:
        return self.matmul_flops + self.kernel_flops

    @property
    def bytes(self) -> int:
        return self.op_bytes + self.kernel_bytes


class analyze:
    """with analyze(args) as a: step(*args) — everything above counted
    over the block; `args` are the step's device-resident arguments."""

    def __init__(self, args):
        self.args = args
        self.counter = OpCounter()
        self.result = Analysis()

    def __enter__(self) -> Analysis:
        work.reset()
        self.result.argument_bytes = self.counter.track(self.args)
        self.counter.__enter__()
        return self.result

    def __exit__(self, *exc) -> None:
        self.counter.__exit__(*exc)
        r, c = self.result, self.counter
        r.matmul_flops = c.flops
        r.kernel_flops, r.kernel_bytes = work.totals()
        r.kernels = {k: dict(v) for k, v in work.TALLY.items()}
        r.op_bytes, r.peak_bytes = c.bytes, c.peak
