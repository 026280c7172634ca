"""Device loops and captured CUDA graphs: the port's counterpart of the JAX
package's one jitted program a superstep (``jax.jit(superstep_impl)``,
``devicekmc_tpu/engine.py:156``).

* :func:`device_while` is ``lax.while_loop``: under a capture on the card it
  adds a conditional WHILE node (``csrc/graph.cu``) whose body is captured
  from hand-written kernels, the last of which sets the node's condition on
  the device; called inside such a body it nests a WHILE node in it (a loop
  inside a loop, as the refinement rounds around the inner CG of the
  transport solve); its plain version, for CPU tensors only, is a Python
  ``while`` on a read of the predicate.
* :func:`fork` and :func:`join` run work on a branch beside a stream: under
  a capture a second path of nodes in the same graph or WHILE body (edges,
  no event nodes), outside one a second stream with event waits.
* :class:`Graph` captures a function of static buffers once and replays it
  as one launch (``torch.cuda.graph``, every read of the device forbidden
  while it captures); on the CPU it calls the function, the plain version of
  a replay.  A failed capture raises: nothing falls back to running eagerly.

``lax.cond`` becomes a mask (``torch.where``) and ``lax.scan`` a loop
unrolled at capture; those need no helper here.
"""

from __future__ import annotations

import ctypes
import gc
from typing import Callable, Dict, Sequence

import torch

from . import _build

#: the streams the bodies of WHILE nodes are captured on, and those of the
#: branches fork starts, one a device, nesting depth and branch
_side_streams: Dict[tuple, torch.cuda.Stream] = {}
#: WHILE nodes nested deepest: the side streams Graph makes before a capture
MAX_DEPTH = 2
#: branches beside one stream at once, at most
MAX_BRANCHES = 2
#: the WHILE bodies being captured now (0: none)
_depth = 0
#: the stream graphs are captured on, one a device
_capture_streams: Dict[torch.device, torch.cuda.Stream] = {}


def _fn(name: str):
    fn = getattr(_build.load("graph"), name)
    if fn.argtypes is None:
        p, u = ctypes.c_void_p, ctypes.c_ulonglong
        fn.argtypes = {"dkmc_while_begin": [p, p, p, ctypes.POINTER(u)],
                       "dkmc_while_end": [p]}[name]
        fn.restype = ctypes.c_int
    return fn


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.index is None:
        device = torch.device(device.type, torch.cuda.current_device())
    return device


def side_stream(device, depth: int = 0, branch: int = 0) -> torch.cuda.Stream:
    """The stream that captures the bodies of WHILE nodes nested ``depth``
    deep on ``device`` (``branch`` k > 0: that of the k-th branch
    :func:`fork` starts inside ``depth`` bodies being captured, 0: none);
    :class:`Graph` makes them before a capture begins."""
    key = (_device(device), depth, branch)
    if key not in _side_streams:
        _side_streams[key] = torch.cuda.Stream(key[0])
    return _side_streams[key]


def _streams(device, stream, branch) -> tuple:
    """``stream`` (a raw handle on ``device``; None: the current stream) as
    a torch stream, and the stream of its branch ``branch`` (1 ..
    MAX_BRANCHES)."""
    if not 1 <= branch <= MAX_BRANCHES:
        raise ValueError(f"fork: branch {branch} is not in 1 .. {MAX_BRANCHES}")
    device = _device(device)
    base = (torch.cuda.current_stream(device) if stream is None
            else torch.cuda.ExternalStream(stream, device=device))
    return base, side_stream(device, _depth, branch)


def fork(device, stream=None, branch: int = 1) -> int:
    """Start branch ``branch`` beside ``stream`` (a raw stream handle on
    ``device``; None: the current stream): the branch's stream, whose work
    runs after what ``stream`` was given so far and beside what it is given
    next, until :func:`join`.  Inside a capture the branch is captured into
    the same graph, or WHILE body, as a second path of nodes (a third with a
    second branch)."""
    base, side = _streams(device, stream, branch)
    side.wait_stream(base)
    return side.cuda_stream


def join(device, stream=None, branch: int = 1) -> None:
    """``stream`` (None: the current stream) runs what it is given next
    after the work of the branch ``branch`` that :func:`fork` started beside
    it."""
    base, side = _streams(device, stream, branch)
    base.wait_stream(side)


def _predicate(cond: torch.Tensor) -> bool:
    """The plain loop's read of its predicate, once an iteration."""
    return int(cond[0]) != 0


def device_while(cond: torch.Tensor, body: Callable[[int, object], None],
                 stream=None) -> None:
    """Run ``body`` while ``cond[0] != 0``: the counterpart of
    ``lax.while_loop``.  ``cond`` is an int32 [1] tensor that the work before
    the loop sets; ``body(handle, stream)`` runs one iteration and updates it.
    ``stream``: the stream of an enclosing loop's body, when this loop runs
    inside it (None: the current stream, which must be capturing).

    For a CUDA tensor this must run inside a capture (:class:`Graph`): it adds
    a WHILE node to the graph, entered on ``cond[0]``, and captures
    ``body(handle, stream)`` as its body graph, where ``body`` launches
    hand-written kernels on ``stream`` that allocate nothing, and the last of
    them sets the node's condition through ``handle``
    (``cudaGraphSetConditional``) and ``cond[0]`` alike.  Outside a capture,
    or when the node cannot be made, it raises.

    For a CPU tensor (the plain version) it calls ``body(0, None)`` while a
    read of ``cond[0]`` is non-zero."""
    if cond.device.type == "cpu":
        while _predicate(cond):
            body(0, None)
        return
    if cond.device.type != "cuda" or cond.dtype != torch.int32 or cond.numel() != 1:
        raise ValueError("device_while: cond must be an int32 [1] tensor on a CUDA device")
    if not torch.cuda.is_current_stream_capturing():
        raise RuntimeError("device_while runs on the card only inside a CUDA graph capture "
                           "(ops.graph.Graph)")
    global _depth
    if stream is None:
        stream = torch.cuda.current_stream(cond.device).cuda_stream
    if _depth >= MAX_DEPTH:
        raise RuntimeError(f"device_while: WHILE nodes nest {MAX_DEPTH} deep at most")
    side = side_stream(cond.device, _depth)
    handle = ctypes.c_ulonglong(0)
    err = _fn("dkmc_while_begin")(stream, side.cuda_stream, cond.data_ptr(),
                                  ctypes.byref(handle))
    if err != 0:
        raise RuntimeError(f"device_while: the conditional WHILE node could not be added "
                           f"to the graph under capture: cudaError {err}")
    _depth += 1
    try:
        body(handle.value, side.cuda_stream)
    finally:
        _depth -= 1
        err = _fn("dkmc_while_end")(side.cuda_stream)
    if err != 0:
        raise RuntimeError(f"device_while: capturing the loop's body failed: cudaError {err}")


class Graph:
    """``fn()`` captured once as a CUDA graph on ``device`` and replayed as one
    launch by each call, which returns the outputs of the capture (static
    tensors the next replay overwrites).  ``fn`` reads and writes only
    tensors that live as long as the graph; it is captured with every
    synchronizing call an error (``torch.cuda.set_sync_debug_mode``), so a
    read of the device inside it fails the capture.  On the CPU a call runs
    ``fn()`` itself.

    ``counted``: kernel wrappers with a ``launches`` count; the launches a
    capture records are not counted at the capture but at every replay
    (``per_replay`` of each), so the counts stay the kernels' launches on
    the card.  ``pool``: a memory pool shared with other graphs that never
    run concurrently with this one.  ``tickets``: the integer tickets
    (``_build.tickets``) the kernels of ``fn`` draw, made on the capture
    stream before the capture."""

    def __init__(self, fn: Callable, device, counted: Sequence = (), pool=None,
                 tickets: int = 0):
        self.device = torch.device(device)
        self.fn = fn
        self.graph = None
        self.per_replay = {}
        if self.device.type == "cpu":
            return
        for depth in range(MAX_DEPTH + 1):
            for branch in range(MAX_BRANCHES + 1):
                side_stream(self.device, depth, branch)
        stream = _capture_streams.get(self.device)
        if stream is None:
            stream = _capture_streams[self.device] = torch.cuda.Stream(self.device)
        with torch.cuda.stream(stream):
            # the kernels that sum across blocks draw tickets of the current
            # stream: made here, not inside the capture, and held by the
            # graph (a later, larger request replaces the stream's buffer)
            self.tickets = _build.tickets(self.device, tickets)
        _build.launch_counts(self.device)
        before = {f: f.launches for f in counted}
        # no collection while capturing: a graph freed by the collector
        # destroys its executable, which a capture does not permit (it would
        # invalidate this capture)
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        torch.cuda.synchronize(self.device)
        graph = torch.cuda.CUDAGraph()
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            with torch.cuda.graph(graph, pool=pool, stream=stream):
                self.outputs = fn()
        finally:
            torch.cuda.set_sync_debug_mode(mode)
            if collecting:
                gc.enable()
            for f, n in before.items():
                self.per_replay[f] = f.launches - n
                f.launches = n
        self.graph = graph

    def __call__(self):
        if self.graph is None:
            return self.fn()
        self.graph.replay()
        for f, n in self.per_replay.items():
            f.launches += n
        return self.outputs
