"""CUDA graphs of the port's device loops.

In PyTorch, "one dispatch for many steps" is a CUDA graph: the kernels that
an eager run launches one by one from the host are captured once into a
`torch.cuda.CUDAGraph` and replayed with one launch. That is how the port
runs what sat_tpu runs inside one jitted `lax.while_loop` or `lax.scan`: the
beam's steps, greedy decode, and the train and eval steps of a K-step block.

A captured function works in place on buffers that its caller allocates
once per shape (`Slot.buffers`). The graph reads and writes those addresses
on every replay, so a caller copies its inputs into them before a run and
copies what it keeps out of them after.

`capture` follows PyTorch's recipe:
  - the function runs once eagerly on a side stream first. This warm-up is
    a real run: its writes to the buffers stand, and the caller counts it
    as the first of its runs. It also makes every kernel's first launch of
    its shape before the capture, which the cluster kernels need: their
    placement check (ops/csrc/cluster.cuh) calls cudaFuncSetAttribute and
    cudaOccupancyMaxActiveClusters once per shape, on the first launch;
  - the torch.Generators that the function draws from are registered with
    the graph, so that each replay draws new numbers and advances the
    generator as an eager run does;
  - Python's cyclic garbage collector is off during the capture: a
    collection could destroy some other, dead graph there
    (cudaGraphExecDestroy), which a capturing stream forbids, and the
    capture would fail (seen on the H100 with graphs that died in a
    reference cycle). PyTorch no longer collects before a capture itself;
  - a serving mesh runs one thread a replica (engine/serving.py), so
    captures take a process-wide lock, one at a time, and forbid unsafe
    CUDA calls in the capturing thread only ("thread_local"): another
    replica's thread may allocate, copy or wait meanwhile.

A capture or a replay that fails raises; nothing falls back to eager. A
caller that wants the eager path asks for it: it passes no GraphCache to
the beam, or `graphs=False` to the caption step.
"""

from __future__ import annotations

import gc
import threading
import time
from typing import Callable

import torch


def capture(fn: Callable, buffers, generators=()) -> torch.cuda.CUDAGraph:
    """Run `fn(buffers)` once eagerly on a side stream (the warm-up), then
    capture `fn(buffers)` into a new CUDA graph, drawing from `generators`."""
    with _capturing:
        current = torch.cuda.current_stream()
        side = torch.cuda.Stream()
        side.wait_stream(current)
        with torch.cuda.stream(side):
            fn(buffers)
        current.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        for gen in generators:
            graph.register_generator_state(gen)
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                fn(buffers)
        finally:
            if collecting:
                gc.enable()
    return graph


_capturing = threading.Lock()   # one capture at a time in the process


class Slot:
    """The buffers of one shape and the graphs captured over them, by
    name, with the host seconds their captures took."""

    def __init__(self, buffers, owners):
        self.buffers = buffers
        self._owners = owners      # kept alive: their ids are in the key
        self._graphs: dict[str, torch.cuda.CUDAGraph] = {}
        self.capture_seconds = 0.0

    def run(self, name: str, fn: Callable, generators=()) -> None:
        """`fn(self.buffers)` once: a replay of the graph `name`, or, on its
        first use, its capture, whose warm-up is this run."""
        graph = self._graphs.get(name)
        if graph is not None:
            graph.replay()
            return
        t0 = time.perf_counter()
        self._graphs[name] = capture(fn, self.buffers, generators)
        self.capture_seconds += time.perf_counter() - t0


class GraphCache:
    """Slots by key: the shape and whatever else the captured functions
    were specialised to, and the identity of the objects (modules, an
    optimizer, tensors, generators) whose memory or state the graphs read.
    A slot holds those objects, so no other object can take one of their
    ids while it lives."""

    def __init__(self):
        self._slots: dict = {}

    def slot(self, key, owners, make_buffers: Callable) -> Slot:
        full = (key, tuple(id(o) for o in owners))
        slot = self._slots.get(full)
        if slot is None:
            slot = Slot(make_buffers(), tuple(owners))
            self._slots[full] = slot
        return slot

    @property
    def captures(self) -> int:
        return sum(len(s._graphs) for s in self._slots.values())

    @property
    def capture_seconds(self) -> float:
        """Host seconds of every capture, its warm-up run included."""
        return sum(s.capture_seconds for s in self._slots.values())

