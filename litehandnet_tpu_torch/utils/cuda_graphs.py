"""The served forward captured as CUDA graphs and replayed.

``ForwardGraphs`` keeps what ``serve.Predictor`` captured, by key: the
input's shape, dtype and device and the predictor's compute dtype, for one
model object (another model object forgets them all). A key's first call
runs eagerly; its second, on a CUDA device and unless ``torch.profiler`` is
recording, is captured; every later one replays. So a shape seen once
(a last partial batch) never costs a capture, and a capture lands among a
server's warm-up calls. All of a predictor's graphs capture into one memory
pool, from one stream (the allocator hands a block out again only on the
stream it was made on): they replay one at a time on one stream and the
predictor copies each output out at once, so a forward's working memory is
free again when the next replays, and a server that meets many batch sizes
holds the largest forward's working set besides each key's input and output.

``GraphChain`` captures ``fn(x)`` as CUDA graphs cut wherever a program span
(``utils/profiling.span``) opens or closes inside ``fn``, and replays them in
capture order; under ``torch.profiler`` it enters and exits the spans between
the graphs, so each span still brackets its kernels on the device's stream.
A span that closes where the next opens leaves an empty graph between them,
which replays as nothing. A model without spans in its forward is one graph.

A replay runs no Python of the forward, so the program's counters
(``counters``: the kernel wrappers' launch and shape counts, Lite-HRNet's
gate count) would stand still: the capture records what its own run added to
each, and every replay adds as much again.

Capture needs every launch of the forward on the current stream (the capture
runs on a stream of its own), no synchronisation with the host and no
allocation outside PyTorch's allocator; the hand-written kernels' wrappers
launch on ``torch.cuda.current_stream``. A capture that fails raises.
"""

from __future__ import annotations

import time
import warnings
from typing import Callable, Dict, List, Optional, Tuple

import torch

from litehandnet_tpu_torch.utils import profiling

_profiler = torch.autograd.profiler
# what a wrapper counts, where it counts it
COUNTED = ("launches", "path_launches", "shapes")
DEVICE_TYPE = "cuda"    # the device whose forwards are captured


def counters() -> List[Tuple[object, str]]:
    """The program counters a forward may move, as (owner, attribute): the
    ``COUNTED`` attributes of each wrapper in ``kernels.KERNELS`` and
    ``models.litehrnet.CrossResolutionWeighting.calls``. An attribute is an
    int or a dict of ints."""
    from litehandnet_tpu_torch.kernels import KERNELS
    from litehandnet_tpu_torch.models.litehrnet import (
        CrossResolutionWeighting,
    )

    pairs = [(w, a) for w in KERNELS.values() for a in COUNTED
             if hasattr(w, a)]
    return pairs + [(CrossResolutionWeighting, "calls")]


def snapshot(pairs) -> list:
    """The values of the counters ``pairs`` (as ``counters`` gives them),
    dicts copied."""
    return [dict(v) if isinstance(v, dict) else v
            for v in (getattr(o, a) for o, a in pairs)]


def moved(pairs, before: list, after: list) -> list:
    """(owner, attribute, amount) of each counter of ``pairs`` that moved
    from snapshot ``before`` to ``after``: an int, or a dict of the keys that
    moved."""
    out = []
    for (owner, attr), b, a in zip(pairs, before, after):
        if isinstance(a, dict):
            d = {k: n - b.get(k, 0) for k, n in a.items() if n != b.get(k, 0)}
        else:
            d = a - b
        if d:
            out.append((owner, attr, d))
    return out


def add(amounts: list) -> None:
    """Move the counters by ``amounts``, as ``moved`` gives them."""
    for owner, attr, d in amounts:
        if isinstance(d, dict):
            counts = getattr(owner, attr)
            for k, n in d.items():
                counts[k] = counts.get(k, 0) + n
        else:
            setattr(owner, attr, getattr(owner, attr) + d)


class GraphChain:
    """``fn(x)`` as a chain of captured graphs (see the module docstring).

    ``graph`` makes a graph: ``capture_begin(pool=, capture_error_mode=)``,
    ``capture_end()``, ``replay()``, as ``torch.cuda.CUDAGraph``; ``pool``
    is the memory pool they capture into and ``stream`` the CUDA stream
    they capture on (None off CUDA).
    ``input`` and ``output`` are the static tensors once captured; write the
    next input into ``input`` before ``replay``, which overwrites
    ``output``. ``steps`` holds the graphs and the span marks
    (``("enter", name, device)``, ``("exit",)``) in capture order, a graph
    first, last and between every two marks; ``seconds`` the capture's host
    time.
    """

    def __init__(self, graph, pool, stream):
        self.graph = graph
        self.pool = pool
        self.stream = stream
        self.steps: list = []
        self.graphs: list = []
        self.counts: list = []
        self.input: Optional[torch.Tensor] = None
        self.output: Optional[torch.Tensor] = None
        self.seconds = 0.0

    def capture(self, fn: Callable[[torch.Tensor], torch.Tensor],
                x: torch.Tensor) -> torch.Tensor:
        """Capture ``fn(x)`` with ``x`` as the static input, run it once
        and return the static output. The counters count this call once,
        as an eager call does."""
        t0 = time.perf_counter()
        pairs = counters()
        before = snapshot(pairs)
        if self.stream is not None:
            self.stream.wait_stream(torch.cuda.current_stream(x.device))
        steps: list = []
        graph = None

        def begin():
            nonlocal graph
            graph = self.graph()
            steps.append(graph)
            graph.capture_begin(pool=self.pool,
                                capture_error_mode="thread_local")

        def cut(mark):
            graph.capture_end()
            steps.append(mark)
            begin()

        with torch.cuda.stream(self.stream), warnings.catch_warnings():
            # a span that closes where the next opens leaves an empty graph
            warnings.filterwarnings("ignore", "The CUDA Graph is empty")
            with profiling.cut_at_spans(cut):
                begin()
                try:
                    out = fn(x)
                finally:
                    graph.capture_end()
        if self.stream is not None:
            torch.cuda.current_stream(x.device).wait_stream(self.stream)
        self.steps = steps
        self.graphs = [s for s in steps if not isinstance(s, tuple)]
        self.counts = moved(pairs, before, snapshot(pairs))
        self.input, self.output = x, out
        self.seconds = time.perf_counter() - t0
        self._run()
        return out

    def replay(self) -> torch.Tensor:
        """Run the captured graphs on what ``input`` holds now; the counters
        move as the capture's run moved them. Returns ``output``."""
        self._run()
        add(self.counts)
        return self.output

    def _run(self) -> None:
        if not _profiler._is_profiler_enabled:
            for g in self.graphs:
                g.replay()
            return
        opened = []
        for step in self.steps:
            if not isinstance(step, tuple):
                step.replay()
            elif step[0] == "enter":
                s = profiling.span(step[1], step[2])
                s.__enter__()
                opened.append(s)
            else:
                opened.pop().__exit__(None, None, None)


class ForwardGraphs:
    """A predictor's captured forwards (see the module docstring).

    ``graph`` as ``GraphChain`` takes it; ``pool()`` makes the memory pool
    that all the chains share, at the first capture, with the stream they
    capture on.
    """

    def __init__(self, graph=torch.cuda.CUDAGraph,
                 pool=torch.cuda.graph_pool_handle):
        self.graph = graph
        self.new_pool = pool
        self.pool = self.stream = None
        self.model = None
        self.seen: Dict[tuple, int] = {}
        self.chains: Dict[tuple, GraphChain] = {}

    def chain(self, model, key: tuple, device: torch.device
              ) -> Optional[GraphChain]:
        """The chain that serves this call of ``model`` on ``device``:
        captured already (its ``output`` set), or to capture now; None where
        the call runs eagerly."""
        if model is not self.model:
            self.clear()
            self.model = model
        chain = self.chains.get(key)
        if chain is not None or device.type != DEVICE_TYPE:
            return chain
        seen = self.seen[key] = self.seen.get(key, 0) + 1
        if seen < 2 or _profiler._is_profiler_enabled:
            return None
        if self.pool is None:
            self.pool = self.new_pool()
            self.stream = (torch.cuda.Stream(device)
                           if device.type == "cuda" else None)
        chain = self.chains[key] = GraphChain(self.graph, self.pool,
                                              self.stream)
        return chain

    def clear(self) -> None:
        """Forget every key, graph, the pool and its stream: the next call
        of a key runs eagerly."""
        self.model = self.pool = self.stream = None
        self.seen.clear()
        self.chains.clear()
