"""The capture step's double for the port's CPU tests of captured train
steps (``tests/test_torch_port_captured_training.py`` and the gloo workers
of ``tests/torch_dist_worker.py``; torch only, so a worker imports no jax).

Nothing is captured on the CPU (a CUDA graph lives on the card), so a
captured step runs there with its capture step replaced by
``GraphDouble``, which behaves as a CUDA graph does where it matters:

* its capture records the call's operators (``TorchDispatchMode``, below
  autograd, so the backward's and the optimizer's too, and the
  collectives: ``c10d.allreduce_``, ``c10d.broadcast_``,
  ``c10d.allgather_``) and changes no value: every tensor that existed
  before the capture and that it wrote in place gets its value back
  (through ``.data``, which leaves ``_version`` where the capture moved
  it, as a real capture does).  A collective runs in the capture on every
  rank, as every rank captures the same step;
* its replay runs the recorded operators again, with every argument they
  took from before the capture read by reference (a graph's address) and
  every scalar as recorded (a graph's baked constant), no Python in
  between, and leaves every ``_version`` where it was, as a real replay
  does.  A replayed collective runs again over its group, and the replay
  waits on it (a graph's stream waits on the communicator's).  So a value
  the step computed on the host would stay the capture's, and a cache
  keyed on ``_version`` would go stale unless the step bumps the versions
  itself;
* an operator that reads a value on the host (``.item()``, ``bool()`` of
  a tensor) inside the capture raises, as it would on the card.

(``tests/test_torch_port_captured_scoring.py``'s double replays by calling
the function again, which bumps the versions and would hide a stale
cache.)
"""

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_map

_HOST_READS = {torch.ops.aten._local_scalar_dense.default, torch.ops.aten.is_nonzero.default,
               torch.ops.aten.equal.default}


def _works(out):
    """The ``Work`` handles among a collective's outputs."""
    return [o for o in tree_flatten(out)[0]
            if isinstance(o, torch.ScriptObject) and hasattr(o, "wait")]


class _Ops(TorchDispatchMode):
    """Records every operator a block runs; snapshots the value of each
    tensor from before the block at its first in-place write."""

    def __init__(self):
        super().__init__()
        self.ops, self.made, self.saved = [], set(), {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _HOST_READS:
            raise RuntimeError(f"the captured step reads a value on the host ({func})")
        for i, arg in enumerate(func._schema.arguments):
            if arg.alias_info is not None and arg.alias_info.is_write:
                value = args[i] if i < len(args) else kwargs.get(arg.name)
                for t in tree_flatten(value)[0]:
                    if (isinstance(t, torch.Tensor) and id(t) not in self.made
                            and id(t) not in self.saved):
                        self.saved[id(t)] = (t, t.detach().clone())
        out = func(*args, **kwargs)
        self.ops.append((func, args, kwargs, out))
        self.made.update(id(t) for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor))
        return out


class GraphDouble:
    """The capture step's double (module docstring); ``collectives``
    counts the collectives each replay ran."""

    def __init__(self):
        self.captures = self.replays = self.collectives = 0

    def __call__(self, fn, static, recording):
        self.captures += 1
        rec = _Ops()
        with recording, rec:
            outputs = fn(*static)
        for t, value in rec.saved.values():  # a capture runs no kernel
            t.data.copy_(value)
        before = [t for t, _ in rec.saved.values()]

        def replay():
            self.replays += 1
            versions = [t._version for t in before]
            env = {}

            def sub(x):
                return env.get(id(x), x) if isinstance(x, torch.Tensor) else x

            with torch.no_grad():
                for func, args, kwargs, out in rec.ops:
                    got = func(*tree_map(sub, args), **tree_map(sub, kwargs))
                    for work in _works(got):
                        self.collectives += 1
                        work.wait()
                    for o, g in zip(tree_flatten(out)[0], tree_flatten(got)[0]):
                        if isinstance(o, torch.Tensor):
                            env[id(o)] = g
                for o in tree_flatten(outputs)[0]:
                    if isinstance(o, torch.Tensor) and env.get(id(o)) is not o:
                        o.copy_(env[id(o)])
            torch._C._autograd._unsafe_set_version_counter(tuple(before), tuple(versions))

        return replay, outputs
