"""Segmented CUDA graphs: the CUDA work of one call of a function,
captured as an ordered list of graphs, split wherever the call opens one of
the program's spans (:func:`~openpsg_tpu_torch.utils.profiling.span`) or
reaches the hooks of a module (read from the module itself, :func:`hooked`):
just before a module's forward pre-hooks and just after its forward, where
its forward hooks run.  The module's own forward stays inside the graphs.

A replay walks the list: it launches each graph, opens and closes each span
around the graphs that the span enclosed (so a profiler reads the same
ranges, nested as before, with the same device work inside them), and runs
each hooked module's hooks eagerly between the graphs, as PyTorch runs them,
on the values an eager call would hand them.  Each tensor a hook is handed
is a copy, so what a hook keeps is never overwritten by a later replay.  A
copy that a hook edits in place (its version counter moved) is copied back
into the graph's tensor, which the later graphs read, as the eager call
passes the edit on.  A value that a hook returns (new arguments from a
pre-hook, a new output from a forward hook) is copied into the buffer that
the later graphs read; it must match what it replaces in structure, shape
and dtype, or the call raises and names the module.  Hooks are Python, and a graph runs none; for
the same reason the host counters that the call bumps through :func:`bump`
are bumped again by each replay.

The rules are CUDA graphs' own: the function works on tensors at fixed
addresses (what changes from one replay to the next lives in tensors, not in
Python values), waits for the card nowhere, and draws no random numbers.
The capture is itself a call, executed: each graph is launched as soon as
it is captured, so the hooks run on the values the call computes (never on
memory the capture left unset), and every state the call updates is updated
once.  Every graph of one capture shares one memory pool, so the graphs
replay in the order they were captured, never two at once.

:class:`GraphKeeper` keeps a module's captured states, one per shape, and
says where the graph path engages; :func:`graphed_call` serves a whole call
(the segmenters' ``segment``) from it."""

from __future__ import annotations

import contextlib
import itertools
import warnings
from collections import OrderedDict
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

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
    same on the graph path as in the eager call.  A keeper's warm-up call
    (:func:`graphed_call`) counts nothing: it is not a call of the caller's."""
    if getattr(profiling.graph_capture, "muted", False):
        return
    setattr(owner, name, getattr(owner, name) + n)
    rec = getattr(profiling.graph_capture, "recorder", None)
    if rec is not None:
        rec.counts.append((owner, name, n))


@contextlib.contextmanager
def lasting():
    """Where tensors that may outlive the call are made: outside inference
    mode (a later call outside it updates them in place, which an inference
    tensor refuses), without autograd."""
    with torch.inference_mode(False), torch.no_grad():
        yield


def _copied(tree):
    """``tree`` with every tensor leaf cloned."""
    leaves, spec = tree_flatten(tree)
    return tree_unflatten([x.clone() if isinstance(x, torch.Tensor) else x for x in leaves],
                          spec)


def _handed(tree, edits: List[Tuple]):
    """``tree`` with every tensor leaf cloned for a hook, outside inference
    mode (an inference tensor keeps no version counter); each (leaf, its
    clone, the clone's version) is appended to ``edits``."""
    leaves, spec = tree_flatten(tree)
    with lasting():
        for i, x in enumerate(leaves):
            if isinstance(x, torch.Tensor):
                leaves[i] = x.clone()
                edits.append((x, leaves[i], leaves[i]._version))
    return tree_unflatten(leaves, spec)


def _check(new, like, what: str) -> None:
    """Raise unless ``new`` has ``like``'s structure, the shape, dtype and
    device of each of its tensors and its other values."""
    nl, ns = tree_flatten(new)
    ll, ls = tree_flatten(like)
    if ns != ls:
        raise ValueError(f"{what} returned {ns}, where the graphs read {ls}")
    for a, b in zip(nl, ll):
        if isinstance(b, torch.Tensor):
            if not (isinstance(a, torch.Tensor) and a.shape == b.shape and a.dtype == b.dtype
                    and a.device == b.device):
                got = (f"{tuple(a.shape)} {a.dtype} on {a.device}" if isinstance(a, torch.Tensor)
                       else repr(a))
                raise ValueError(f"{what} returned {got}, where the graphs read "
                                 f"{tuple(b.shape)} {b.dtype} on {b.device}")
        elif a is not b and a != b:
            raise ValueError(f"{what} returned {a!r}, where the graphs read {b!r}")


class _HookStep:
    """A hooked module's forward pre-hooks (``pre``) or forward hooks
    (``post``), run eagerly between two graphs, at the capture and at every
    replay, on copies of the module's arguments (and output) as the graphs
    hold them."""

    def __init__(self, kind: str, name: str, module: nn.Module, args, kwargs, out=None):
        self.kind, self.name, self.module = kind, name, module
        self.args, self.kwargs, self.out = args, kwargs, out
        # the buffers the later graphs read a returned value from, made at
        # the capture where a hook returned one
        self.buffers = None

    def hooks(self) -> "OrderedDict":
        m = self.module
        return m._forward_pre_hooks if self.kind == "pre" else m._forward_hooks

    def run(self, hooks, capture: bool):
        """Run ``hooks`` (the module's, as PyTorch's ``Module.__call__``
        runs them) → at the capture, the value PyTorch should go on with
        (None where no hook returned one)."""
        m = self.module
        kw_ids = (m._forward_pre_hooks_with_kwargs if self.kind == "pre"
                  else m._forward_hooks_with_kwargs)
        edits: List[Tuple] = []
        args = _handed(self.args, edits)
        kwargs = (_handed(self.kwargs, edits) if any(i in kw_ids for i in hooks)
                  else self.kwargs)
        returned = False
        if self.kind == "pre":
            for i, hook in list(hooks.items()):
                if i in kw_ids:
                    r = hook(m, args, kwargs)
                    if r is not None:
                        if not (isinstance(r, tuple) and len(r) == 2):
                            raise RuntimeError("forward pre-hook must return None or a tuple "
                                               f"of (new_args, new_kwargs), but got {r}.")
                        (args, kwargs), returned = r, True
                else:
                    r = hook(m, args)
                    if r is not None:
                        args, returned = (r if isinstance(r, tuple) else (r,)), True
            final, like = (args, kwargs), (self.args, self.kwargs)
        else:
            out = _handed(self.out, edits)
            for i, hook in list(hooks.items()):
                r = hook(m, args, kwargs, out) if i in kw_ids else hook(m, args, out)
                if r is not None:
                    out, returned = r, True
            final, like = out, self.out
        for x, c, version in edits:
            if c._version != version:   # edited in place: the eager call passes that on
                x.copy_(c)
        what = f"a forward {'pre-' if self.kind == 'pre' else ''}hook of {self.name}"
        if capture:
            if not returned:
                return None
            _check(final, like, what)
            self.buffers = _copied(final)
            return self.buffers
        if self.buffers is None:
            if returned:
                raise ValueError(f"{what} returned a value, which it did not when the "
                                 "graphs were captured")
            return None
        _check(final, self.buffers, what)
        for b, x in zip(tree_flatten(self.buffers)[0], tree_flatten(final)[0]):
            if isinstance(b, torch.Tensor):
                b.copy_(x)
        return None


class _Recorder:
    """The capture in progress: the steps so far and the open graph."""

    def __init__(self, pool, names: Dict[nn.Module, str], held_hooks: Dict):
        self.pool, self.names, self.held_hooks = pool, names, held_hooks
        self.steps: List = []
        # every graph captured, empty ones too: each holds a use of the pool,
        # which the next capture into it needs
        self.held: List[torch.cuda.CUDAGraph] = []
        self.graph = None
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
        self.end()
        self.steps.append(step)
        self.begin()

    def _hooks(self, step: _HookStep):
        """The graph ends, the module's own hooks run eagerly (spans and
        counters inside them are theirs, not the capture's), the next graph
        begins."""
        self.end()
        self.steps.append(step)
        profiling.graph_capture.recorder = None
        try:
            held = self.held_hooks[step.module][0 if step.kind == "pre" else 1]
            back = step.run(held, capture=True)
        finally:
            profiling.graph_capture.recorder = self
        self.begin()
        return back

    def pre_hook(self, module, args, kwargs):
        return self._hooks(_HookStep("pre", self.names[module], module, args, kwargs))

    def post_hook(self, module, args, kwargs, out):
        return self._hooks(_HookStep("post", self.names[module], module, args, kwargs, out))


@contextlib.contextmanager
def _hooks_held(named: Sequence[Tuple[str, nn.Module]]):
    """The hooked modules' forward pre-hooks and hooks taken off them for the
    block → {module: (pre-hooks, hooks)} as they were; put back after."""
    held = {m: (m._forward_pre_hooks, m._forward_hooks) for _, m in named if hooked(m)}
    for m in held:
        m._forward_pre_hooks, m._forward_hooks = OrderedDict(), OrderedDict()
    try:
        yield held
    finally:
        for m, (pre, post) in held.items():
            m._forward_pre_hooks, m._forward_hooks = pre, post


class SegmentedGraph:
    """One call's work as graphs, spans and hook steps (module docstring)."""

    def __init__(self, steps: List, held: List[torch.cuda.CUDAGraph], counts: List[Tuple]):
        self.steps, self.held, self.counts = steps, held, counts

    @classmethod
    def capture(cls, fn, modules: Iterable[Tuple[str, nn.Module]],
                stream: torch.cuda.Stream) -> "SegmentedGraph":
        """Run ``fn()`` once on ``stream``, a side stream, capturing its work,
        split at the spans it opens and at the hooks of those of ``modules``
        (``named_modules()`` pairs) that are :func:`hooked` (their hooks
        fire as in any call)."""
        named = list(modules)
        with _hooks_held(named) as held:
            names = {m: n or type(m).__name__ for n, m in named}
            rec = _Recorder(torch.cuda.graph_pool_handle(), names, held)
            handles = []
            for m, (pre, post) in held.items():
                if pre:
                    handles.append(m.register_forward_pre_hook(rec.pre_hook, with_kwargs=True))
                if post:
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
                if isinstance(step, _HookStep):
                    step.run(step.hooks(), capture=False)
                elif step[0] == "graph":
                    step[1].replay()
                elif step[0] == "open":
                    cm = profiling.span(step[1], prefix=step[2])
                    cm.__enter__()
                    opened.append(cm)
                else:
                    opened.pop().__exit__(None, None, None)
        finally:
            while opened:
                opened.pop().__exit__(None, None, None)
        for owner, name, n in self.counts:
            setattr(owner, name, getattr(owner, name) + n)


class GraphKeeper:
    """The graph path's states of one module, kept on it (under ``ATTR``),
    so they are freed with it: one per shape, the ``KEPT`` used last.  They
    are dropped when a parameter or buffer of the module (or a tensor the
    call reads besides, ``reads``) moved, or the set of hooked modules
    changed, since a graph reads fixed addresses and splits where hooks
    run."""

    KEPT = 4
    ATTR = "_graph_keeper"

    def __init__(self, dev: torch.device):
        self.signature = None
        self.states: "OrderedDict[tuple, object]" = OrderedDict()
        # the side stream every capture of this module runs on
        self.stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None

    @classmethod
    def of(cls, root: nn.Module, dev: torch.device, methods: Sequence[str] = ("forward",),
           reads: Sequence[torch.Tensor] = ()) -> Optional["GraphKeeper"]:
        """``root``'s keeper where the graph path engages: on CUDA, with
        grad disabled, outside any other capture, no hook on every module,
        none of ``methods`` replaced on the instance (a wrapper put there is
        Python that a replay would not run again), no module tensor-parallel
        or a pipeline stage (collectives stay eager); else None (the call
        runs eagerly)."""
        if (dev.type != "cuda" or torch.is_grad_enabled()
                or torch.cuda.is_current_stream_capturing() or global_hooks()):
            return None
        if any(name in vars(root) for name in methods):
            return None
        if any(getattr(m, "tp", None) is not None or getattr(m, "stage_range", None) is not None
               for m in root.modules()):
            return None
        keeper = root.__dict__.get(cls.ATTR)
        if keeper is None:
            keeper = cls(dev)
            setattr(root, cls.ATTR, keeper)
        keeper.refresh(root, reads)
        return keeper

    def refresh(self, root: nn.Module, reads: Sequence[torch.Tensor] = ()) -> None:
        sig = (tuple(t.data_ptr() for t in itertools.chain(root.parameters(), root.buffers(),
                                                           reads)),
               tuple((i, bool(m._forward_pre_hooks), bool(m._forward_hooks))
                     for i, m in enumerate(root.modules()) if hooked(m)))
        if sig != self.signature:
            self.signature, self.states = sig, OrderedDict()

    def get(self, key: tuple, make: Callable[[], object]):
        """The kept state of ``key``, made by ``make()`` if there is none;
        the least recently used beyond ``KEPT`` is dropped."""
        st = self.states.pop(key, None)
        if st is None:
            st = make()
        self.states[key] = st
        while len(self.states) > self.KEPT:
            self.states.popitem(last=False)
        return st


class _CallGraph:
    """One image shape's graph of a call: a buffer for its input, the
    captured :class:`SegmentedGraph` and the outputs it writes."""

    def __init__(self):
        self.graph: Optional[SegmentedGraph] = None

    def __call__(self, keeper: GraphKeeper, root: nn.Module, fn, image: torch.Tensor):
        if self.graph is not None:
            self.input.copy_(image)
            self.graph.replay()
            return _copied(self.outputs)
        stream, caller = keeper.stream, torch.cuda.current_stream()
        named = list(root.named_modules())
        with lasting():
            # a first eager call on the side stream builds the libraries'
            # plans there; its hooks and counters stay silent
            stream.wait_stream(caller)
            profiling.graph_capture.muted = True
            try:
                with _hooks_held(named), torch.cuda.stream(stream):
                    fn(image)
            finally:
                profiling.graph_capture.muted = False
            caller.wait_stream(stream)
            self.input = image.clone()
            out = []
            self.graph = SegmentedGraph.capture(lambda: out.append(fn(self.input)), named,
                                                stream)
            self.outputs = out[0]
        graphed_call.graph_captures += 1
        return _copied(self.outputs)


def graphed_call(root: nn.Module, fn, image: torch.Tensor,
                 reads: Sequence[torch.Tensor] = ()):
    """``fn(image)``, a call of ``root`` (and of ``reads``, tensors it reads
    besides its own parameters and buffers) → its outputs; one ``fn`` per
    ``root``.  Where the graph path engages (:meth:`GraphKeeper.of`) it is
    replayed from one segmented graph per image shape (shape, dtype,
    device): a shape's first call runs ``fn`` once eagerly on the keeper's
    side stream, then captures it, the capture being the call; the image is
    copied into the graph's buffer, and the outputs returned are copies,
    which the next replay leaves alone.  Elsewhere ``fn`` runs eagerly.
    Counters (host ints): ``graphed_call.graph_captures`` (shapes
    captured), ``.graph_calls`` (calls served from graphs, the captures
    included) and ``.eager_calls``."""
    keeper = GraphKeeper.of(root, image.device, reads=reads)
    if keeper is None:
        graphed_call.eager_calls += 1
        return fn(image)
    key = (tuple(image.shape), image.dtype, image.device)
    out = keeper.get(key, _CallGraph)(keeper, root, fn, image)
    graphed_call.graph_calls += 1
    return out


graphed_call.graph_captures = 0
graphed_call.graph_calls = 0
graphed_call.eager_calls = 0
