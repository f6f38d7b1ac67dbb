"""A call replayed as one captured CUDA graph: the port's counterpart of the
JAX package's ``jax.jit`` for a call whose shapes repeat, such as a
scorer's static batch (``vadcl_tpu/eval/predict.py:260-274``).

``CapturedCall(fn, device)`` runs ``fn(*inputs)`` (tensors in; a tensor, or
a tuple or list of them, out):

* The first call for a key (each input's shape, dtype and device, and the
  grad and inference modes) copies the inputs into static buffers, runs
  ``fn`` eagerly on them ``WARMUP_CALLS`` times on a side stream (which
  fills the memos and packed-operand caches ``fn`` reads, cuDNN's and
  cuBLAS's choices), then captures one call of ``fn`` on the buffers under
  ``torch.cuda.set_sync_debug_mode("error")``, so that a host read or a
  pageable copy inside ``fn`` raises where it lies.
* Every call copies its inputs into the buffers, replays the graph on the
  current stream and returns a copy of the outputs: the static outputs are
  overwritten by the next replay.
* A graph reads every operand by address, so it stays valid only while
  nothing it read changed.  Each tensor the capture read that existed
  before it -- parameters, buffers, memos, constants -- is noted with its
  ``(data_ptr, _version)`` after the capture, beside the sources of every
  packed operand or gathered bias the capture took from a cache
  (``note_sources``: ``ops/packed.py:PackCache``,
  ``models/swin.py:WindowAttention3D.bias``; the capture reads the packed
  tensor, not its source).  Before each replay every noted tensor must be
  alive with that state, and no module may have registered a parameter,
  buffer or submodule since the capture (a replaced parameter); else the
  call captures anew.  So an optimizer's in-place update, a weight swapped
  in, or a memory bank rebound gives a new graph, never the old model's
  scores.  (Of the two designs -- check the recorded sources before each
  replay, or pack inside the captured region -- this is the first: packing
  inside the graph would rerun every pack's library kernels at each
  replay.)

The kernel wrappers' launch counters count the wrappers' calls: the
warm-up calls launch eagerly and the capture's call launches into the
graph, and each counts so; a replay runs no Python and counts nothing.
What a replay launched is read from the device's trace.

The capture step is a parameter (``capture``); the default,
``cuda_graph_capture``, needs a CUDA device, and asking for it on another
raises.  A capture that fails raises: nothing retries eagerly.  One
``CapturedCall`` serves one thread at a time.

``CapturedCall(fn, device, owned=..., inputs=...)`` is a step, the train
step's counterpart of the JAX package's one jitted step
(``vadcl_tpu/train/step.py``): a call that updates ``owned()`` in place
(parameters, moments, counts, the memory bank) and returns its metrics.

* Its warm-ups are real steps: the first ``WARMUP_CALLS`` calls of a key
  run ``fn`` eagerly on their own inputs (the run's first steps; they fill
  the optimizer's state and the libraries' choices), and the capture step
  warms up nothing.  The next call captures ``fn`` (which changes nothing
  on the device: a capture records kernels, it runs none) and replays it
  once, which performs that step.  So every call performs exactly one step.
* A replay runs no Python, so the in-place writes it makes leave every
  ``_version`` where the capture left it, and every cache keyed on
  ``_version`` -- the packed operands (``ops/packed.py``), the bias memo
  (``models/swin.py``), each scorer's ``CapturedCall`` -- would serve the
  weights of an earlier step.  The capture therefore records every tensor
  that existed before it and that an operator wrote in place (the
  operator's schema marks the argument written), and after each replay
  bumps their versions (``torch.autograd.graph.increment_version``).  Its
  own freshness check expects exactly those bumps: these are the writes it
  exempts.
* Every packed operand the captured call reads is made inside the
  captured region (``pack_region``): a pack made before the capture would
  be read by address at every replay, the first capture's weights.
* ``inputs()`` are tensors the caller writes between calls, outside the
  graph (the step count, the learning rate): read by address, never
  checked.  A different set of ``owned()`` tensors (a restore that
  replaced them) captures anew, and so does any tensor the capture read
  that changed otherwise (a restore in place) or died.  A module
  registration elsewhere (a scorer's model built) does not.
"""

from __future__ import annotations

import functools
import itertools
import weakref
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_map

WARMUP_CALLS = 2

# bumped by the module hooks below whenever a module registers a parameter,
# buffer or submodule (also a replacement: ``module.weight = Parameter(...)``)
_generation = [0]
_hooked = [False]
_recordings: List["_Recording"] = []  # the capture under way, if any
_regions = itertools.count(1)  # the pack regions of steps' captures


def _registered(*_args) -> None:
    _generation[0] += 1


def _hook_modules() -> None:
    if not _hooked[0]:
        mod = torch.nn.modules.module
        mod.register_module_parameter_registration_hook(_registered)
        mod.register_module_buffer_registration_hook(_registered)
        mod.register_module_module_registration_hook(_registered)
        _hooked[0] = True


def wants_graph(graph: Optional[bool], device: torch.device | str) -> bool:
    """Whether a scorer on ``device`` replays captured graphs: by default on
    a CUDA device and nowhere else; ``graph=True`` elsewhere raises."""
    device = torch.device(device)
    if graph is None:
        return device.type == "cuda"
    if graph and device.type != "cuda":
        raise ValueError(f"graph=True needs a CUDA device, got {device}: the CPU runs "
                         "eagerly (graph=False)")
    return bool(graph)


def note_sources(sources: Sequence[torch.Tensor]) -> None:
    """Tell a capture under way that it reads a tensor derived from
    ``sources`` (a packed operand, a gathered bias): the graph is stale when
    one of them changes."""
    if _recordings:
        _recordings[-1].note(sources)


def pack_region() -> int:
    """0, or the region of the step's capture under way: a packed
    operand made in a region serves only that region
    (``ops/packed.py:PackCache``)."""
    return _recordings[-1].region if _recordings else 0


def _state(t: torch.Tensor) -> tuple:
    return (t.data_ptr(), None if t.is_inference() else t._version)


_FRESH = (torch.ops.aten.lift_fresh.default, torch.ops.aten.lift_fresh_copy.default)


class _Reads(TorchDispatchMode):
    """Every tensor on ``device`` an operator took that no operator in the
    block made (nor ``made`` at the start), and of those the ones an
    operator wrote in place (``written``).  A constant made in the block
    from Python data (``torch.tensor(...)``) reaches the mode as the
    argument of ``lift_fresh``: it counts as made."""

    def __init__(self, device: torch.device, made: Sequence[torch.Tensor]):
        super().__init__()
        self.device = device
        self.made = {id(t) for t in made}
        self.read: Dict[int, torch.Tensor] = {}
        self.written: Dict[int, torch.Tensor] = {}

    def take(self, tensors) -> None:
        for t in tensors:
            if (isinstance(t, torch.Tensor) and t.device == self.device
                    and id(t) not in self.made):
                self.read.setdefault(id(t), t)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _FRESH:
            self.made.update(id(t) for t in args if isinstance(t, torch.Tensor))
        self.take(tree_flatten((args, kwargs))[0])
        if func._schema.is_mutable:
            for i, arg in enumerate(func._schema.arguments):
                if arg.alias_info is not None and arg.alias_info.is_write:
                    value = args[i] if i < len(args) else kwargs.get(arg.name)
                    for t in tree_flatten(value)[0]:
                        if isinstance(t, torch.Tensor) and id(t) in self.read:
                            self.written.setdefault(id(t), t)
        out = func(*args, **kwargs)
        self.made.update(id(t) for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor))
        return out


class _Recording:
    """The capture of one call: entered once by the capture step around the
    call it records.  Keeps what the call read and wrote in place; with
    ``region`` its packs are made inside it (``pack_region``)."""

    def __init__(self, device: torch.device, static: Sequence[torch.Tensor],
                 region: bool = False):
        self._reads = _Reads(device, static)
        self.entered = False
        self.region = next(_regions) if region else 0

    def note(self, sources: Sequence[torch.Tensor]) -> None:
        self._reads.take(sources)

    def read(self) -> List[torch.Tensor]:
        return list(self._reads.read.values())

    def written(self) -> List[torch.Tensor]:
        return list(self._reads.written.values())

    def __enter__(self):
        if self.entered:
            raise RuntimeError("a capture step records one call")
        self.entered = True
        _recordings.append(self)
        self._reads.__enter__()
        return self

    def __exit__(self, *exc):
        try:
            self._reads.__exit__(*exc)
        finally:
            _recordings.remove(self)
        return False


def cuda_graph_capture(fn: Callable, static: Sequence[torch.Tensor], recording: _Recording,
                       warmups: int = WARMUP_CALLS):
    """The capture step: ``fn`` warmed up ``warmups`` times on a side
    stream, then one call captured into a ``torch.cuda.CUDAGraph``
    (thread-local capture mode: a stager thread may copy on its own stream
    meanwhile) with host syncs made errors.  Returns (replay, static
    outputs)."""
    device = static[0].device if static else torch.device("cuda")
    if device.type != "cuda":
        raise ValueError(f"a CUDA graph is captured on a CUDA device, got {device}")
    if warmups:
        current = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            for _ in range(warmups):
                fn(*static)
        current.wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            with recording:
                outputs = fn(*static)
        finally:
            torch.cuda.set_sync_debug_mode(mode)
    return graph.replay, outputs


class _Entry(NamedTuple):
    static: Tuple[torch.Tensor, ...]
    outputs: object
    replay: Callable[[], None]
    reads: Tuple[weakref.ref, ...]
    states: list  # each read's (data_ptr, _version), as the next call must find it
    generation: Optional[int]  # None: a step's, which no registration elsewhere makes stale
    owned: Tuple[int, ...]  # ids of a step's owned tensors at the capture
    written: Tuple[int, ...]  # a step's in-place writes: indices into reads

    def fresh(self, owned: Tuple[int, ...]) -> bool:
        if owned != self.owned or self.generation not in (None, _generation[0]):
            return False
        for ref, state in zip(self.reads, self.states):
            t = ref()
            if t is None or _state(t) != state:
                return False
        return True

    def replayed(self) -> None:
        """After a replay: bump the version of every tensor it wrote in
        place, and expect the bumps."""
        if self.written:
            ts = [self.reads[i]() for i in self.written]
            torch.autograd.graph.increment_version(ts)
            for i, t in zip(self.written, ts):
                self.states[i] = _state(t)


def _copy(t):
    return t.clone() if isinstance(t, torch.Tensor) else t


class CapturedCall:
    """``fn`` replayed as a captured graph, one per key, returning copies of
    its outputs (module docstring).  With ``owned`` it is a step: ``fn``
    updates ``owned()`` in place, the first ``WARMUP_CALLS`` calls of a key
    run it eagerly, and ``inputs()`` are tensors the caller writes between
    calls.  ``captures`` counts the graphs captured so far."""

    def __init__(self, fn: Callable, device: torch.device | str = "cuda", *,
                 capture: Optional[Callable] = None,
                 owned: Optional[Callable[[], Sequence[torch.Tensor]]] = None,
                 inputs: Callable[[], Sequence[torch.Tensor]] = tuple):
        self.fn = fn
        self.device = torch.device(device)
        self._step = owned is not None
        if capture is None:
            if self.device.type != "cuda":
                raise ValueError(f"graph capture needs a CUDA device, got {self.device}: "
                                 "call the function eagerly (graph=False)")
            capture = (functools.partial(cuda_graph_capture, warmups=0) if self._step
                       else cuda_graph_capture)
        self._capture = capture
        self._owned = owned or tuple
        self._inputs = inputs
        self._entries: Dict[tuple, _Entry] = {}
        self._calls: Dict[tuple, int] = {}
        self.captures = 0
        _hook_modules()

    def __call__(self, *inputs: torch.Tensor):
        key = (tuple((tuple(x.shape), x.dtype, x.device) for x in inputs),
               torch.is_grad_enabled(), torch.is_inference_mode_enabled())
        if self._step:
            calls = self._calls.get(key, 0)
            self._calls[key] = calls + 1
            if calls < WARMUP_CALLS:
                return self.fn(*inputs)
        owned = tuple(id(t) for t in self._owned())
        entry = self._entries.get(key)
        if entry is not None and entry.fresh(owned):
            for s, x in zip(entry.static, inputs):
                s.copy_(x)
        else:
            entry = self._record(inputs, owned)
            # (the old graph goes only now: the capture synchronised the card,
            # so no replay of it is still running)
            self._entries[key] = entry
        entry.replay()
        entry.replayed()
        return tree_map(_copy, entry.outputs)

    def _record(self, inputs: Sequence[torch.Tensor], owned: Tuple[int, ...]) -> _Entry:
        with torch.inference_mode(False):
            static = tuple(torch.empty_like(x) for x in inputs)
        for s, x in zip(static, inputs):
            s.copy_(x)
        # (the inputs' device: "cuda" itself equals no tensor's "cuda:0")
        recording = _Recording(static[0].device if static else self.device,
                               static + tuple(self._inputs()), region=self._step)
        replay, outputs = self._capture(self.fn, static, recording)
        if not recording.entered:
            raise RuntimeError("the capture step recorded no call")
        self.captures += 1
        read = recording.read()
        where = {id(t): i for i, t in enumerate(read)}
        return _Entry(static=static, outputs=outputs, replay=replay,
                      reads=tuple(weakref.ref(t) for t in read),
                      states=[_state(t) for t in read],
                      generation=None if self._step else _generation[0], owned=owned,
                      written=tuple(where[id(t)] for t in recording.written())
                      if self._step else ())
