"""G's forward inside a sampler call, replayed as one captured CUDA graph.

The JAX package runs a denoising step's generator as one jitted program;
the port dispatches G's forward op by op from Python, a few thousand
launches a forward, and at the recipes' batches the host sets the pace.
`GraphedForward(net)` is a `GeneratorFn` for `sample_from_model` that
captures one forward of `net` into a `torch.cuda.CUDAGraph` and replays it,
one launch a denoising step. `make_sampler` is its one caller.

Which path a call takes follows from what it can observe:

  * eager, `net(x, t, z)` as it stands, when x is not on a CUDA device,
    when `net.training` (dropout draws), when grad is enabled, and when no
    graph exists yet for the call's key while a `torch.profiler` records
    (the port's spans would record CUDA events inside the capture);
  * capture, the first call for a key (the shapes and dtypes of x, t and
    z, and x's device): it runs `net` eagerly and returns that output, so
    cuDNN, cuBLAS and the hand kernels are warm; then it copies x, t and z
    into static buffers and captures one forward on a private memory pool,
    in `thread_local` error mode (the FID loop's encoder threads run
    meanwhile). The capture runs no kernel;
  * replay, every later call for that key: three copies into the static
    buffers, one graph launch, and the graph's static output returned.

The output of a replay is valid until the next call of the same wrapper
for the same key: `sample_from_model` consumes x_0 in the posterior before
it calls G again, and a sampler call returns the posterior's own tensor.
No draw is made inside the graph: x_T, each z and each posterior noise
come from the caller's `torch.Generator`, eagerly, so the random stream is
the eager one.

The graph reads the parameters' storage at every replay: a load into the
same tensors (`load_state_dict`, an EMA swap by `copy_`) shows in the next
replay. Rebinding a parameter to a new tensor does not; the sampler's
callers load weights before `make_sampler`.

Counts: the hand kernels' wrappers count launches and calls in Python
(`fir2x.LAUNCHES` / `CALLS`, `pair_conv.LAUNCHES` / `CALLS`), and a model
may count its own steps, handing its tallies in by `register_tallies`
(`models/ncsnpp.py`: the steps of G's pyramids). A capture runs none of
them, so what the capture added is taken back out, and every replay adds
it again, with the matching `trace.count`s: the tallies keep counting
kernels and steps that ran. `CALLS` counts each call's path, and each path
is the span counter `sampler.graph.<path>` too. G's level spans
(`ddgan.G.*`) are recorded on eager calls only: a replay runs no Python of
G.
"""

from __future__ import annotations

import torch
from torch.autograd import profiler as _profiler

from .. import trace
from ..ops import fir2x, pair_conv

PATHS = ("replay", "capture", "eager")
# calls by path since the last reset
CALLS = dict.fromkeys(PATHS, 0)
# the same calls as counters of the innermost open span (`trace.count`)
COUNTERS = {path: f"sampler.graph.{path}" for path in PATHS}


# functions that return more tallies, as `_tallies` does (`register_tallies`)
_SOURCES: list = []


def reset_counts() -> None:
    for path in PATHS:
        CALLS[path] = 0


def register_tallies(source) -> None:
    """Count what `source()` returns, (dict, key, span counter or None)
    triples, as the hand kernels' tallies are: taken out of a capture and
    added at each replay. For the counts that a model keeps in Python."""
    _SOURCES.append(source)


def _tallies() -> list:
    """The hand kernels' and the registered tallies as (dict, key, span
    counter or None), looked up anew on each use: a reset of the kernels'
    counts replaces dicts."""
    out = [(fir2x.LAUNCHES, name, None) for name in fir2x.LAUNCHES]
    out += [(fir2x.CALLS[name], role, fir2x.COUNTERS[name][role])
            for name in fir2x.LAUNCHES for role in fir2x.ROLES]
    out += [(pair_conv.LAUNCHES, name, None) for name in pair_conv.LAUNCHES]
    out += [(pair_conv.CALLS, role, pair_conv.COUNTERS[role]) for role in pair_conv.CALLS]
    for source in _SOURCES:
        out += source()
    return out


class _Graph:
    __slots__ = ("graph", "inputs", "output", "tallies")

    def __init__(self, graph, inputs, output, tallies):
        self.graph, self.inputs, self.output = graph, inputs, output
        self.tallies = tallies  # (index into `_tallies()`, added by a forward)


class GraphedForward:
    """`net` as a `GeneratorFn` whose forwards on CUDA replay a captured
    graph; see the module's docstring."""

    def __init__(self, net: torch.nn.Module):
        self.net = net
        self.graphs: dict = {}

    def __call__(self, x: torch.Tensor, t: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        if x.device.type != "cuda" or self.net.training or torch.is_grad_enabled():
            return self._eager(x, t, z)
        key = (x.device,) + tuple((tuple(a.shape), a.dtype) for a in (x, t, z))
        g = self.graphs.get(key)
        if g is not None:
            return self._replay(g, x, t, z)
        if _profiler._is_profiler_enabled:
            return self._eager(x, t, z)
        out = self.net(x, t, z)
        self.graphs[key] = self._capture(x, t, z)
        self._count("capture")
        return out

    @staticmethod
    def _count(path: str) -> None:
        CALLS[path] += 1
        trace.count(COUNTERS[path])

    def _eager(self, x, t, z):
        self._count("eager")
        return self.net(x, t, z)

    def _capture(self, x, t, z) -> _Graph:
        inputs = tuple(a.clone() for a in (x, t, z))
        before = [d[k] for d, k, _ in _tallies()]
        graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                output = self.net(*inputs)
        finally:
            added = []
            for i, ((d, k, _), n) in enumerate(zip(_tallies(), before)):
                if d[k] != n:
                    added.append((i, d[k] - n))
                    d[k] = n
        return _Graph(graph, inputs, output, tuple(added))

    def _replay(self, g: _Graph, x, t, z) -> torch.Tensor:
        for buf, a in zip(g.inputs, (x, t, z)):
            buf.copy_(a)
        g.graph.replay()
        tallies = _tallies()
        for i, n in g.tallies:
            d, k, counter = tallies[i]
            d[k] += n
            if counter is not None:
                trace.count(counter, n)
        self._count("replay")
        return g.output
