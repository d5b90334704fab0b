"""Segmented CUDA graphs: the CUDA work of one call of a function,
captured as an ordered list of graphs, split wherever the call opens one of
the program's spans (:func:`~openpsg_tpu_torch.utils.profiling.span`) or
calls a module that has forward hooks or forward pre-hooks (read from the
module itself, :func:`hooked`).

A replay walks the list: it launches each graph, opens and closes each span
around the graphs that the span enclosed (so a profiler reads the same
ranges, nested as before, with the same device work inside them), and calls
each hooked module eagerly on the same inputs, so that its hooks see every
call with its real values; the module's outputs are copied into the buffers
that the later graphs read.  Hooks are Python, and a graph runs none; for
the same reason the host counters that the call bumps through :func:`bump`
are bumped again by each replay.

The rules are CUDA graphs' own: the function works on tensors at fixed
addresses (what changes from one replay to the next lives in tensors, not in
Python values), waits for the card nowhere, and draws no random numbers.
The capture is itself a call, executed: each graph is launched as soon as
it is captured, so the hooked modules run, hooks and all, on the values the
call computes (never on memory the capture left unset), and every state the
call updates is updated once.  Every graph of one capture shares one memory
pool, so the graphs replay in the order they were captured, never two at
once."""

from __future__ import annotations

import warnings
from typing import Iterable, List, Tuple

import torch
import torch.nn as nn
from torch.utils._pytree import tree_flatten, tree_unflatten

from openpsg_tpu_torch.utils import profiling


def hooked(module: nn.Module) -> bool:
    """Whether the module has forward hooks or forward pre-hooks."""
    return bool(module._forward_hooks or module._forward_pre_hooks)


def global_hooks() -> bool:
    """Whether forward hooks are registered for every module
    (``nn.modules.module.register_module_forward_hook`` and its pre-hook)."""
    m = nn.modules.module
    return bool(m._global_forward_hooks or m._global_forward_pre_hooks)


def bump(owner, name: str, n: int) -> None:
    """``owner.name += n`` for a host counter, and inside a capture again at
    every replay (a replay runs no Python), so that the counter reads the
    same on the graph path as in the eager call.  A counter bumped inside a
    hooked call is not recorded: the call runs again at every replay."""
    setattr(owner, name, getattr(owner, name) + n)
    rec = getattr(profiling.graph_capture, "recorder", None)
    if rec is not None and not rec.depth:
        rec.counts.append((owner, name, n))


class _Recorder:
    """The capture in progress: the steps so far and the open graph."""

    def __init__(self, pool):
        self.pool = pool
        self.steps: List[Tuple] = []
        # every graph captured, empty ones too: each holds a use of the pool,
        # which the next capture into it needs
        self.held: List[torch.cuda.CUDAGraph] = []
        self.graph = None
        # hooked calls open: their work (spans and hooked calls inside them
        # included) runs eagerly at replay, inside the outermost one
        self.depth = 0
        self.call = None
        # host counters the call bumped (:func:`bump`), bumped again by each replay
        self.counts: List[Tuple] = []

    def begin(self) -> None:
        self.graph = torch.cuda.CUDAGraph()
        self.held.append(self.graph)
        self.graph.capture_begin(pool=self.pool, capture_error_mode="thread_local")

    def end(self) -> None:
        """End the open graph and launch it: the capture executes the call."""
        g, self.graph = self.graph, None
        if g is None:
            return
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            g.capture_end()
        # a graph that captured nothing is not replayed (PyTorch warns of it)
        if not any("empty" in str(w.message) for w in caught):
            g.replay()
            self.steps.append(("graph", g))

    def boundary(self, step: Tuple) -> None:
        """A span opens or closes: the graph ends there."""
        if self.depth:
            return
        self.end()
        self.steps.append(step)
        self.begin()

    def pre_hook(self, module, args, kwargs):
        if not self.depth:
            self.end()
            self.call = (module, args, kwargs)    # as called, before other pre-hooks
        self.depth += 1

    def post_hook(self, module, args, kwargs, out):
        self.depth -= 1
        if self.depth:
            return None
        module, args, kwargs = self.call
        inputs = {id(t) for t in tree_flatten((args, kwargs))[0]}
        leaves, spec = tree_flatten(out)
        # the outputs' buffers, which the later graphs read; an input handed
        # back (a cache written in place) is its own buffer
        static = [x.clone() if isinstance(x, torch.Tensor) and id(x) not in inputs else x
                  for x in leaves]
        self.steps.append(("call", module, args, kwargs, static))
        self.begin()
        return tree_unflatten(static, spec)


class SegmentedGraph:
    """One call's work as graphs, spans and hooked calls (module docstring)."""

    def __init__(self, steps: List[Tuple], held: List[torch.cuda.CUDAGraph],
                 counts: List[Tuple]):
        self.steps, self.held, self.counts = steps, held, counts

    @classmethod
    def capture(cls, fn, modules: Iterable[nn.Module],
                stream: torch.cuda.Stream) -> "SegmentedGraph":
        """Run ``fn()`` once on ``stream``, a side stream, capturing its work,
        split at the spans it opens and at its calls of those of ``modules``
        that are :func:`hooked` (their hooks fire as in any call)."""
        rec = _Recorder(torch.cuda.graph_pool_handle())
        handles = []
        for m in [m for m in modules if hooked(m)]:
            # first of the pre-hooks, last of the hooks
            handles.append(m.register_forward_pre_hook(rec.pre_hook, prepend=True,
                                                       with_kwargs=True))
            handles.append(m.register_forward_hook(rec.post_hook, with_kwargs=True))
        stream.wait_stream(torch.cuda.current_stream())
        profiling.graph_capture.recorder = rec
        try:
            with torch.cuda.stream(stream):
                rec.begin()
                try:
                    fn()
                except BaseException:
                    if rec.graph is not None:
                        try:
                            rec.graph.capture_end()
                        except RuntimeError:   # the capture was invalidated
                            pass
                    raise
                rec.end()
        finally:
            profiling.graph_capture.recorder = None
            for h in handles:
                h.remove()
        torch.cuda.current_stream().wait_stream(stream)
        return cls(rec.steps, rec.held, rec.counts)

    def replay(self) -> None:
        opened = []
        try:
            for step in self.steps:
                kind = step[0]
                if kind == "graph":
                    step[1].replay()
                elif kind == "open":
                    cm = profiling.span(step[1], prefix=step[2])
                    cm.__enter__()
                    opened.append(cm)
                elif kind == "close":
                    opened.pop().__exit__(None, None, None)
                else:
                    _, module, args, kwargs, static = step
                    out = tree_flatten(module(*args, **kwargs))[0]
                    for s, x in zip(static, out):
                        if isinstance(s, torch.Tensor) and s is not x:
                            s.copy_(x)
        finally:
            while opened:
                opened.pop().__exit__(None, None, None)
        for owner, name, n in self.counts:
            setattr(owner, name, getattr(owner, name) + n)
