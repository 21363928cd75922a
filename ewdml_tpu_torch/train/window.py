"""K training steps per host launch (``--scan-window``): the port's
counterpart of the JAX package's ``lax.scan`` window (``make_window_step``).

On the GPU a window is one CUDA graph: the step body runs once under
``torch.cuda.graph`` with its keys, murmur seeds, feed positions and dropout
generators taken from a :class:`~ewdml_tpu_torch.utils.keytable.KeyTable`,
and each later window is one copy of the table to the device plus one
``replay()``. The state lives in place (parameters, BatchNorm statistics,
momentum, residuals), so a replay finds it where the last one left it.

- The first window of a run is K per-step dispatches (eager), which warms
  cuDNN, cuBLAS and the allocator on the stream the graphs are captured on.
- A graph freezes the step's host decisions, and two depend on the step
  number: the Method 6 sync (``step % sync_every``) and the K-of-N rotation
  (``step % W``). One graph is captured per phase of the window's start
  (:meth:`WindowStep.phase`) and cached.
- The kernel wrappers count their launches while a window is captured,
  when nothing launches; the capture takes those counts back out and every
  replay adds them (``ops/kernels.add_launches``). The ring's moved bytes
  (``LocalWorld.ppermute_bytes``) are kept the same way.
- A capture or replay that fails raises: nothing falls back to eager steps.
- Under ``--trace-dir`` each capture is a ``train/compile`` span.

On the CPU a window is the same K steps run in a loop, with their keys
from a key table (the caller asked for the CPU; there is no graph).
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

from ewdml_tpu_torch.obs import clock
from ewdml_tpu_torch.obs import trace as otrace
from ewdml_tpu_torch.ops import kernels
from ewdml_tpu_torch.utils.keytable import HostKeys, KeyTable


@dataclasses.dataclass
class _Captured:
    """One phase's graph with its key table, its static output and what
    one replay launches and moves."""

    graph: object
    table: KeyTable
    out: torch.Tensor
    launches: dict
    ring_bytes: int


class WindowStep:
    """``(state, data, labels_all, key) -> metrics [K, W, 3]``."""

    def __init__(self, body, cfg, world, window: int, dropout: bool = False):
        self.body = body
        self.cfg = cfg
        self.world = world
        self.window = int(window)
        self.dropout = dropout
        self.device = world.device
        self._graphs = {}
        self._pool = None
        self._warm = False
        self.stream = (torch.cuda.Stream(self.device)
                       if self.device.type == "cuda" else None)
        #: Windows run eagerly (the warm-up), graphs captured, replays, and
        #: the seconds the captures took.
        self.eager_windows = 0
        self.captures = 0
        self.replays = 0
        self.capture_s = 0.0

    def phase(self, start: int) -> tuple:
        """The step-number residues a window's graph freezes: the start
        modulo the Method 6 sync period, and modulo W under K-of-N."""
        cfg, w = self.cfg, self.world.size
        sync = cfg.sync_every if cfg.sync_every > 1 else 1
        rot = w if 0 < cfg.num_aggregate < w else 1
        return start % sync, start % rot

    def stream_context(self):
        """The stream every step of a windowed run is launched on (its
        graphs are captured there); a null context on the CPU."""
        if self.stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self.stream)

    def _steps(self, state, data, labels, keys) -> torch.Tensor:
        return torch.stack([self.body(state, data, labels, keys)
                            for _ in range(self.window)])

    def __call__(self, state, data, labels, key) -> torch.Tensor:
        start = state.step
        if self.device.type != "cuda":
            return self._steps(state, data, labels,
                               KeyTable(key, self.device, start))
        if torch.cuda.current_stream(self.device) != self.stream:
            raise RuntimeError("a window runs on WindowStep.stream; enter "
                               "stream_context() first")
        if not self._warm:
            self._warm = True
            self.eager_windows += 1
            return self._steps(state, data, labels, HostKeys(key))
        cap = self._graphs.get((tuple(key), self.phase(start)))
        if cap is None:
            with otrace.span("train/compile", capture=list(self.phase(start))):
                cap = self._capture(state, data, labels, key)
            self._graphs[(tuple(key), self.phase(start))] = cap
        cap.table.load(start)
        cap.graph.replay()
        kernels.add_launches(cap.launches)
        self.world.ppermute_bytes += cap.ring_bytes
        state.step = start + self.window
        self.replays += 1
        return cap.out.clone()

    def _capture(self, state, data, labels, key) -> _Captured:
        t0 = clock.monotonic()
        start = state.step
        gens = []
        if self.dropout:
            gens = [torch.Generator(device=self.device)
                    for _ in range(self.window * self.world.size)]
        graph = torch.cuda.CUDAGraph()
        for g in gens:
            graph.register_generator_state(g)
        table = KeyTable(key, self.device, start, generators=gens)
        out = torch.empty((self.window, self.world.size, 3),
                          dtype=torch.float32, device=self.device)
        launches = dict(kernels.LAUNCHES)
        ring_bytes = self.world.ppermute_bytes
        try:
            with torch.cuda.graph(graph, pool=self._pool, stream=self.stream):
                for j in range(self.window):
                    out[j].copy_(self.body(state, data, labels, table))
        finally:
            # Nothing ran: the host's step counter, the launch counts and
            # the ring's bytes go back to where the capture found them.
            state.step = start
            launches = {k: v - launches[k] for k, v in kernels.LAUNCHES.items()}
            kernels.add_launches({k: -v for k, v in launches.items()})
            ring_bytes, self.world.ppermute_bytes = (
                self.world.ppermute_bytes - ring_bytes, ring_bytes)
        if self._pool is None:
            self._pool = graph.pool()
        self.captures += 1
        self.capture_s += clock.monotonic() - t0
        return _Captured(graph, table, out, launches, ring_bytes)
