"""The step's control flow as the JAX package writes it.

* ``associative_scan`` — ``jax.lax.associative_scan``'s algorithm
  (``jax/_src/lax/control_flow/loops.py``, ``associative_scan``) in plain
  torch, with its association order: combine the pairs ``elems[0:-1:2]``
  and ``elems[1::2]``, scan that half recursively, combine once more for
  the even positions, interleave.  Log depth, no host read, and it runs
  under ``torch.func.vmap``.  The IMU chains (``imu.py``) use it, so the
  port multiplies in JAX's order.

* ``gate(pred, body, carry)`` — ``lax.cond(pred, body, identity, carry)``.
  ``pred`` is a () bool tensor on the device and ``body`` is functional: a
  carry (a tuple of tensors, or of named tuples of them) to a new carry of
  the same structure.  Two forms:

  - *masked*, everywhere by default (eager, the CPU, and wherever no
    step is being captured with gates): the body runs and its results are
    picked with ``torch.where(pred, new, old)``, out of place.
  - *gated*, only while a step is being captured inside ``gated_capture``
    (``step_graph.StepGraphs`` with ``gates=True``: the single pipeline,
    the batch and the sharded step on NCCL ranks): the body is recorded
    inside a CUDA-graph conditional (IF) node on ``pred``
    (``kernels/graph_if.py``, ``csrc/graph_if.cu``), and its
    results are ``copy_``'d into the carry's own tensors inside that node,
    so a replay runs the body only where ``pred`` holds and leaves the
    carry as it was otherwise.  The gate returns the carry's tensors.  The
    carry must therefore be tensors that nothing reads under another name
    after the gate (``own`` makes such copies), made before the gate.  They
    keep their own memory layout, where the masked form takes the body's
    (a column-major solve, say): a product whose rounding follows its
    operands' layout reads a carried matrix in one layout
    (``filter/ekf.py``'s ``P_post``), so both forms give the same bits.  A
    gated capture that cannot record the node raises.

  Under ``torch.func.vmap`` (the batch) the gate follows JAX's rule for
  ``lax.cond`` under ``jax.vmap``: a batched predicate (one flag a lane)
  always takes the masked form, a select, even inside ``gated_capture``;
  an unbatched one keeps a real conditional, an IF node there.  Inside a
  gated body under vmap the carry's tensors must be batched too (made from
  a batched input: ``new_zeros``, ``new_full``), since vmap writes no
  batched value into an unbatched tensor.

* ``while_loop(body, carry, max_iter)`` — ``lax.while_loop`` with JAX's
  condition on the carry's first two leaves, its loop index ``i`` (int32,
  from -1 or above, which the body raises by one a pass) and flag
  ``done``: ``~done & (i < max_iter)``, so at most ``max_iter + 1`` passes.
  Masked (where ``gate`` is), the ``max_iter + 1`` passes are unrolled,
  each picked with ``torch.where`` of the condition.  Gated, the loop is
  one CUDA-graph WHILE node (``kernels/graph_if.py``): its body, one copy
  of the pass, ``copy_``s the pass's results into the carry's own tensors,
  and one condition kernel reads ``done`` and ``i`` on the device before
  the node and after each pass, so a replay runs the passes JAX's loop
  runs and no more.  Under ``torch.func.vmap`` (one ``done`` and ``i`` a
  lane) the node follows JAX's batching rule for ``while``: the condition
  kernel reads every lane's flags (the physical (B,) tensors beneath the
  batched ones, ``_lanes``), the loop runs while any lane is active, and
  each lane keeps a pass's result only where it is active itself, by a
  mask of the lanes' conditions that the same kernel writes.

  The kernel launch counters (``kernels/counts.py``) count at Python call
  time, and a replay runs a gated body's launches only where its node runs
  it (once, never, or once a pass).  So a gated body takes its own
  launches off the counters while it is recorded and records an add of
  them to a device counter inside the node: they count as run, and the
  host reads them only when asked (``counts.settle``).
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Callable, Optional, TypeVar

import torch

Tree = TypeVar("Tree")

# the device whose step is being captured with gates, or None
_gated_device: contextvars.ContextVar[Optional[torch.device]] = (
    contextvars.ContextVar("gated_device", default=None))


def _interleave(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[a0, b0, a1, b1, ...] along axis 0; ``a`` as long as ``b`` or one
    longer."""
    if a.shape[0] == b.shape[0]:
        return torch.stack([a, b], dim=1).flatten(0, 1)
    return torch.cat([torch.stack([a[:-1], b], dim=1).flatten(0, 1), a[-1:]])


def associative_scan(fn: Callable, elems):
    """``jax.lax.associative_scan(fn, elems)`` along axis 0: element k of
    the result combines ``elems[0..k]`` with ``fn`` (``fn(a, b)``, a before
    b, applied elementwise over axis 0), in JAX's association order.
    ``elems`` is a tensor or a tuple of tensors of one length; ``fn`` takes
    and returns the same structure."""
    single = isinstance(elems, torch.Tensor)
    if single:
        return associative_scan(lambda a, b: (fn(a[0], b[0]),), (elems,))[0]
    elems = tuple(elems)

    def combine(a, b):
        return tuple(fn(a, b))

    def scan(el):
        n = el[0].shape[0]
        if n < 2:
            return el
        reduced = combine(tuple(e[0:-1:2] for e in el),
                          tuple(e[1::2] for e in el))
        odd = scan(reduced)
        if n % 2 == 0:
            even = combine(tuple(o[:-1] for o in odd),
                           tuple(e[2::2] for e in el))
        else:
            even = combine(odd, tuple(e[2::2] for e in el))
        even = tuple(torch.cat([e[:1], r]) for e, r in zip(el, even))
        return tuple(_interleave(a, b) for a, b in zip(even, odd))

    return scan(elems)


def select(flag: torch.Tensor, new, old):
    """``torch.where(flag, new, old)`` leaf by leaf over tensors and (named)
    tuples of them: ``lax.cond``'s pick of a carry, on the device."""
    if isinstance(new, tuple):
        leaves = [select(flag, a, b) for a, b in zip(new, old)]
        return type(new)(*leaves) if hasattr(new, "_fields") else tuple(leaves)
    return torch.where(flag, new, old)


def _assign(dst, src) -> None:
    """Copy ``src`` into ``dst`` leaf by leaf (the same structure)."""
    if isinstance(dst, tuple):
        for d, s in zip(dst, src):
            _assign(d, s)
    elif src is not dst:
        dst.copy_(src)


@contextlib.contextmanager
def gated_capture(device):
    """Within: ``gate`` records IF nodes into the graph being captured on
    ``device`` (``step_graph.StepGraphs`` with ``gates=True``)."""
    token = _gated_device.set(torch.device(device))
    try:
        yield
    finally:
        _gated_device.reset(token)


def gating() -> bool:
    """Whether ``gate`` records IF nodes here (inside ``gated_capture``)."""
    return _gated_device.get() is not None


def own(tree: Tree) -> Tree:
    """A carry of the tensors of ``tree``: copies of them where ``gate``
    writes in place (``gating()``), so that no other name sees the writes;
    ``tree`` itself in the masked form, which writes nothing."""
    if not gating():
        return tree
    if isinstance(tree, tuple):
        leaves = [own(v) for v in tree]
        return type(tree)(*leaves) if hasattr(tree, "_fields") else tuple(
            leaves)
    return tree.clone(memory_format=torch.contiguous_format)


def _record_if(pred: torch.Tensor, fn: Callable[[], None]) -> None:
    """Record ``fn``'s work into a conditional (IF) node on ``pred`` of the
    CUDA graph that the current stream is capturing
    (``kernels.graph_if``); raises where it cannot (nothing is recorded
    unconditionally instead)."""
    if not (torch.cuda.is_available()
            and torch.cuda.is_current_stream_capturing()):
        raise RuntimeError("a gated step records IF nodes, and the current "
                           "stream is not capturing a CUDA graph")
    if (not pred.is_cuda or pred.dtype != torch.bool or pred.numel() != 1
            or not pred.is_contiguous()):
        raise ValueError(f"an IF node's predicate must be a one-element bool "
                         f"CUDA tensor (got {pred.dtype} {tuple(pred.shape)} "
                         f"on {pred.device})")
    from .kernels import graph_if
    graph_if.record_if(pred, fn)


def batched(t: torch.Tensor) -> bool:
    """Whether ``t`` carries a lane axis of ``torch.func.vmap`` (a value
    that may differ from lane to lane)."""
    return torch._C._functorch.is_batchedtensor(t)


def _lanes(t: torch.Tensor) -> torch.Tensor:
    """Every lane's value of the () tensor ``t`` in one tensor whose memory
    is ``t``'s: under ``torch.func.vmap`` the physical (B,) tensor beneath
    the batched one, outside vmap ``t`` as one lane."""
    if not batched(t):
        return t.reshape(1)
    lanes = torch._C._functorch.get_unwrapped(t)
    if batched(lanes) or lanes.dim() != 1 or t.dim() != 0:
        raise ValueError("a WHILE node reads one flag a lane: a () tensor "
                         "under one level of vmap")
    return lanes


def _record_while(done: torch.Tensor, i: torch.Tensor, max_iter: int,
                  fn: Callable[[], None],
                  active: Optional[torch.Tensor] = None) -> None:
    """Record ``fn``'s work as the body of a WHILE node on ``~done & (i <
    max_iter)`` for any lane (``done`` and ``i`` from ``_lanes``), each
    lane's written into ``active`` where given (before every pass), in the
    CUDA graph that the current stream is capturing
    (``kernels.graph_if``); raises where it cannot (nothing is recorded
    unrolled instead)."""
    if not (torch.cuda.is_available()
            and torch.cuda.is_current_stream_capturing()):
        raise RuntimeError("a gated step records WHILE nodes, and the "
                           "current stream is not capturing a CUDA graph")
    if (not done.is_cuda or done.dtype != torch.bool
            or i.dtype != torch.int32 or i.device != done.device
            or i.shape != done.shape or not done.is_contiguous()
            or not i.is_contiguous()):
        raise ValueError(
            f"a WHILE node reads a contiguous bool flag and int32 index of "
            f"one length on a CUDA device (got {done.dtype} "
            f"{tuple(done.shape)} on {done.device}, {i.dtype} "
            f"{tuple(i.shape)} on {i.device})")
    from .kernels import counts, graph_if
    graph_if.record_while(done, i, max_iter, fn, counts.device_slot(
        graph_if.while_launches, 1, done.device), active)


def gate(pred: torch.Tensor, body: Callable[[Tree], Tree], carry: Tree) -> Tree:
    """``lax.cond(pred, body, lambda c: c, carry)`` on the device: the
    masked form (``torch.where`` of the body's results and the carry),
    or inside ``gated_capture`` the body recorded in an IF node that writes
    the carry in place, where ``pred`` is the same for every lane (the
    module's docstring)."""
    device = _gated_device.get()
    if device is None or batched(pred):
        return select(pred, body(carry), carry)
    from .kernels import counts  # the counters import the kernels

    def run():
        before = counts.snapshot()
        _assign(carry, body(carry))
        ran = counts.since(before)
        counts.restore(before)
        counts.add_on_device(ran, device)  # inside the node: counted as run

    _record_if(pred, run)
    return carry


def while_loop(body: Callable[[Tree], Tree], carry: Tree,
               max_iter: int) -> Tree:
    """``lax.while_loop(lambda c: ~c[1] & (c[0] < max_iter), body, carry)``
    on the device, ``carry`` a tuple whose first two leaves the condition
    reads, ``i`` (int32, -1 or above, raised by one a pass) and ``done``
    (bool): masked, ``max_iter + 1`` passes each picked with
    ``torch.where``; inside ``gated_capture`` one WHILE node whose body
    writes the carry in place (the module's docstring)."""
    def active(c):
        return ~c[1] & (c[0] < max_iter)

    device = _gated_device.get()
    if device is None:
        for _ in range(max_iter + 1):
            carry = select(active(carry), body(carry), carry)
        return carry
    i, done = carry[:2]
    mask = None  # each lane's condition, written by the condition kernel
    if batched(done) or batched(i):
        mask = done.new_empty(())
    step = body if mask is None else (lambda c: select(mask, body(c), c))
    from .kernels import counts  # the counters import the kernels

    def run():
        before = counts.snapshot()
        _assign(carry, step(carry))
        ran = counts.since(before)
        counts.restore(before)
        counts.add_on_device(ran, device)  # inside the node: counted as run

    _record_while(_lanes(done), _lanes(i), max_iter, run,
                  None if mask is None else _lanes(mask))
    return carry
