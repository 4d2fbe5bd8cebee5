"""Step programs: each step of the port captured once into a CUDA graph for
each key and replayed after that (counterpart of `jax.jit`'s cache of
compiled programs, of the `lax.scan` epoch and eval of
`stratanet2_tpu/data/device_dataset.py` and of `_PROGRAM_CACHE` /
`_cached_programs` in `stratanet2_tpu/learning/train.py:349-389`).

The JAX package runs a step as one compiled device program. Here a step's
body is Python that issues its kernels one by one, so on the card a
`StepProgram` runs it once eagerly at the first call of a key (the warm-up:
it builds every kernel library at its first launch, creates Adam's state
and fills the allocator), captures it into a `torch.cuda.CUDAGraph` with a
private memory pool, and from the next call on copies the call's inputs
into the graph's static input buffers, replays the graph and hands back
copies of its outputs, which the next replay cannot overwrite.

A graph's key: the inputs' shapes and dtypes, whether the call passes a
generator, the caller's key (the model's mode and opt-ins), and the
identity and address of every tensor the body reads or writes besides its
inputs (the model's parameters and buffers, Adam's state and learning rate,
a device dataset's tables). A new set of those tensors (a new fold's
optimizer, a checkpoint loaded into new tensors) drops every graph of the
program, as `_PROGRAM_CACHE.clear()` does: one set is held at a time.

A generator the body draws from is replaced, in the graph, by one of the
program's own registered with the graph
(`CUDAGraph.register_generator_state`); the caller's state is copied into
it before each replay and back after, so a replay draws what the body
draws eagerly, bit for bit.

Parameters whose gradients the body computes (`params`) get the graph's
own: they are set to None for the capture, so that the captured backward
writes gradients of its own, and point at those after each replay.

A capture that fails, or a body that waits for the card inside it, raises:
nothing falls back to eager execution. The CPU paths, and the mesh paths
(whose collectives run over gloo, which a graph cannot hold), do not go
through a program: their steps run their bodies eagerly (`graphed`).

The kernel wrappers count their launches (`ops/cuda_kernels.LAUNCHES`,
`PATH_LAUNCHES`) when Python calls them; the launches a capture records
are taken back out of the counts and added again at each replay, so the
counts stay the kernels the card ran (`GRAPH_COUNTS` counts captures and
replays). `CudaGraphs` is the one part that touches `torch.cuda`'s graphs
and streams; a test drives the bookkeeping on the CPU with a stand-in of
the same interface.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from stratanet2_tpu_torch.ops import cuda_kernels

__all__ = ["CudaGraphs", "StepProgram", "graphed", "model_tensors", "optimizer_tensors",
           "mode_key"]


def graphed(device: torch.device, group=None) -> bool:
    """Whether a step on `device` runs as a replayed graph: on the card and
    off a mesh (`group` None)."""
    return device.type == "cuda" and group is None


def model_tensors(model: torch.nn.Module) -> Tuple[torch.Tensor, ...]:
    return (*model.parameters(), *model.buffers())


def optimizer_tensors(optimizer: torch.optim.Optimizer) -> Tuple[torch.Tensor, ...]:
    """Every tensor an optimizer step reads or writes besides the
    parameters and their gradients: each group's learning rate where it is
    a tensor, and each parameter's state."""
    lrs = [g["lr"] for g in optimizer.param_groups if isinstance(g["lr"], torch.Tensor)]
    state = [v for st in optimizer.state.values() for v in st.values()
             if isinstance(v, torch.Tensor)]
    return (*lrs, *state)


def mode_key(model: torch.nn.Module, training: bool) -> Tuple:
    """The mode a body runs `model` in (each body sets it, whatever the
    caller's) and the model's opt-ins (`models/pointnet2.OPT_INS`)."""
    from stratanet2_tpu_torch.models.pointnet2 import OPT_INS

    return (training, *(getattr(model.cfg, name) for name in OPT_INS))


class CudaGraphs:
    """Warm-up, capture and replay on the card. The warm-up and the capture
    run on a side stream, which first waits for the current stream, and
    the current stream waits for them; a replay runs on the current
    stream.

    The side stream is one a card for the whole process, shared by every
    program, as `torch.cuda.graph`'s default capture stream is: cuBLAS
    keeps a workspace (32 MiB on an H100) for each stream it has run on
    until the process ends, so a stream of each program's own would leave
    96 MB on the card after every fold (its epoch, eval and final-eval
    programs)."""

    _streams: Dict[int, torch.cuda.Stream] = {}  # card index -> the side stream

    def _side(self, device: torch.device) -> torch.cuda.Stream:
        index = device.index if device.index is not None else torch.cuda.current_device()
        if index not in CudaGraphs._streams:
            CudaGraphs._streams[index] = torch.cuda.Stream(index)
        return CudaGraphs._streams[index]

    @contextlib.contextmanager
    def _on_side(self, device: torch.device):
        side, current = self._side(device), torch.cuda.current_stream(device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            yield
        current.wait_stream(side)

    def run(self, fn: Callable[[], Any], device: torch.device):
        """fn() eagerly: the warm-up, which is the step of the first call."""
        with self._on_side(device):
            return fn()

    def capture(self, fn: Callable[[], Any], device: torch.device,
                generator: Optional[torch.Generator]):
        """(the graph of fn, fn's outputs in its pool). The allocator's
        cache is emptied first, as `torch.cuda.graph` does: the private
        pool cannot reuse it."""
        graph = torch.cuda.CUDAGraph()
        if generator is not None:
            graph.register_generator_state(generator)
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        with self._on_side(device):
            graph.capture_begin()
            try:
                out = fn()
            except BaseException:
                with contextlib.suppress(RuntimeError):  # the capture is invalid: end it
                    graph.capture_end()
                raise
            graph.capture_end()
        return graph, out

    def replay(self, graph) -> None:
        graph.replay()


class _Graph(NamedTuple):
    handle: Any  # the backend's graph
    inputs: Tuple[torch.Tensor, ...]  # static input buffers
    outputs: Any  # static outputs
    generator: Optional[torch.Generator]  # the program's, registered with the graph
    launches: Tuple[Dict[str, int], Dict[str, int]]  # kernel launches it holds
    grads: Tuple[Tuple[torch.Tensor, Optional[torch.Tensor]], ...]  # (param, its gradient)


def _clone(out):
    if isinstance(out, torch.Tensor):
        return out.clone()
    if isinstance(out, dict):
        return {k: _clone(v) for k, v in out.items()}
    if isinstance(out, (tuple, list)):
        return type(out)(_clone(v) for v in out)
    return out


def _identity(tensors: Sequence[torch.Tensor]) -> Tuple[Tuple[int, int], ...]:
    return tuple((id(t), t.data_ptr()) for t in tensors)


class StepProgram:
    """`body` captured once for each key and replayed after that.

    `program(objects, inputs, held, key, generator, params)` runs
    `body(*objects, *inputs)` (with `generator=` when one is given): the
    inputs are tensors on the card, copied into the graph's static buffers;
    `objects` (a model, an optimizer, a dataset) are bound as they are at
    the capture; `held()` returns every tensor the body reads or writes
    outside its inputs. Returns the body's outputs (tensors, or tuples and
    dicts of them), copies of the graph's after a replay."""

    def __init__(self, body: Callable, graphs=None):
        self.body = body
        self.graphs = CudaGraphs() if graphs is None else graphs
        self.current: Optional[_Graph] = None  # the graph of the last call
        self._identity: Optional[Tuple] = None
        self.held: Tuple[torch.Tensor, ...] = ()  # kept alive while their graphs are
        self._graphs: Dict[Tuple, _Graph] = {}

    def _bound(self, objects, generator):
        kw = {} if generator is None else {"generator": generator}
        return lambda *inputs: self.body(*objects, *inputs, **kw)

    def __call__(self, objects: Sequence, inputs: Sequence[torch.Tensor],
                 held: Callable[[], Sequence[torch.Tensor]], key: Tuple = (),
                 generator: Optional[torch.Generator] = None,
                 params: Sequence[torch.Tensor] = ()):
        full_key = (tuple((tuple(x.shape), x.dtype) for x in inputs), generator is None, key)
        graph = self._graphs.get(full_key)
        if graph is None or _identity(tuple(held())) != self._identity:
            return self._first(objects, inputs, held, full_key, generator, params)
        return self.replay(graph, inputs, generator)

    def _first(self, objects, inputs, held, full_key, generator, params):
        """The first call of a key: the body eagerly (the step itself), then
        its capture, which runs nothing."""
        device = inputs[0].device
        out = self.graphs.run(lambda: self._bound(objects, generator)(*inputs), device)
        tensors = tuple(held())
        identity = _identity(tensors)
        if identity != self._identity:  # a new set of tensors: every graph goes
            self._graphs.clear()
            self.current = None
            self._identity, self.held = identity, tensors
        static = tuple(x.clone(memory_format=torch.contiguous_format) for x in inputs)
        gen = None if generator is None else torch.Generator(device=device)
        warm = [p.grad for p in params]
        for p in params:
            p.grad = None
        before = cuda_kernels.launch_snapshot()
        handle, outputs = self.graphs.capture(lambda: self._bound(objects, gen)(*static),
                                              device, gen)
        launches = cuda_kernels.captured_launches(before)
        grads = tuple((p, p.grad) for p in params)
        for p, g in zip(params, warm):  # the first call's own, until a replay
            p.grad = g
        self.current = self._graphs[full_key] = _Graph(handle, static, outputs, gen, launches,
                                                       grads)
        return out

    def replay(self, graph: _Graph, inputs: Sequence[torch.Tensor],
               generator: Optional[torch.Generator] = None):
        """Replay `graph` (`current` after a call) on `inputs`, with the
        tensors it was captured with."""
        for buf, x in zip(graph.inputs, inputs):
            buf.copy_(x)
        if generator is not None:
            graph.generator.set_state(generator.get_state())
        self.graphs.replay(graph.handle)
        if generator is not None:
            generator.set_state(graph.generator.get_state())
        for p, g in graph.grads:
            p.grad = g
        cuda_kernels.replayed(graph.launches)
        self.current = graph
        return _clone(graph.outputs)
