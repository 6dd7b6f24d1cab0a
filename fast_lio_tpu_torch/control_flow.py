"""The step's control flow as the JAX package writes it.

* ``associative_scan`` — ``jax.lax.associative_scan``'s algorithm
  (``jax/_src/lax/control_flow/loops.py``, ``associative_scan``) in plain
  torch, with its association order: combine the pairs ``elems[0:-1:2]``
  and ``elems[1::2]``, scan that half recursively, combine once more for
  the even positions, interleave.  Log depth, no host read, and it runs
  under ``torch.func.vmap``.  The IMU chains (``imu.py``) use it, so the
  port multiplies in JAX's order.

* ``gate(pred, body, carry)`` — ``lax.cond(pred, body, identity, carry)``
  (and, pass by pass, a bounded ``lax.while_loop``).  ``pred`` is a () bool
  tensor on the device and ``body`` is functional: a carry (a tuple of
  tensors, or of named tuples of them) to a new carry of the same
  structure.  Two forms:

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

* ``loop_pass(active, body, carry)`` — one pass of a bounded
  ``lax.while_loop``: ``gate(active, body, carry)``, and for a batched
  ``active`` JAX's batching rule for ``while``: the pass runs while any
  lane is active (``any_lane``, an unbatched flag, so an IF node in a
  gated capture) and each lane keeps its own result only where it is
  active itself.

  The kernel launch counters (``kernels/counts.py``) count at Python call
  time, and a replay skips a gated body's launches where ``pred`` is False.
  So a gated body takes its own launches off the counters while it is
  recorded and records an add of them to a device counter inside the node:
  they count as run, and the host reads them only when asked
  (``counts.settle``).
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


@torch.library.custom_op("fast_lio_tpu_torch::any_lane", mutates_args=())
def _any_lane_op(pred: torch.Tensor) -> torch.Tensor:
    return pred.clone()  # one lane: its own flag


@_any_lane_op.register_fake
def _any_lane_fake(pred):
    return torch.empty_like(pred)


def _any_lane_vmap(info, in_dims, pred):
    """The reduction over the lanes: one unbatched flag, on the device."""
    if in_dims[0] is None:
        return pred.clone(), None
    return pred.any(dim=in_dims[0]), None


torch.library.register_vmap("fast_lio_tpu_torch::any_lane", _any_lane_vmap)


def any_lane(pred: torch.Tensor) -> torch.Tensor:
    """JAX's ``reduce_or`` of a batched ``while_loop`` predicate over the
    lanes: under ``torch.func.vmap`` a () bool that holds where any lane's
    ``pred`` holds, unbatched (the same for every lane) and on the device,
    with no host read; outside vmap ``pred`` itself (one lane)."""
    return torch.ops.fast_lio_tpu_torch.any_lane(pred)


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


def loop_pass(active: torch.Tensor, body: Callable[[Tree], Tree],
              carry: Tree) -> Tree:
    """One pass of a bounded ``lax.while_loop`` whose predicate is
    ``active``: ``gate(active, body, carry)``.  For a batched ``active``
    in a gated capture, the pass is an IF node on ``any_lane(active)``
    whose body keeps each lane's result where that lane is active (JAX's
    batched ``while``); masked, it is the same select as for one lane."""
    if not (batched(active) and gating()):
        return gate(active, body, carry)
    return gate(any_lane(active), lambda c: select(active, body(c), c),
                carry)
