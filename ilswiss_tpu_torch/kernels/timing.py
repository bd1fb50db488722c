"""Device time of a short kernel on the card (no JAX counterpart: the JAX
package timed whole jitted programs).

A kernel that runs shorter than the host takes to issue it (K3 and K4, a
few to tens of microseconds against tens of microseconds of Python and
ctypes per call) cannot be timed by CUDA events around a run of eager
launches: that measures the host's issue rate.  `graph_ms` captures `reps`
calls in one CUDA graph and times its replay, so the calls run back to back
on the card as they would inside a captured `forward`.
"""

from __future__ import annotations

import torch


def graph_ms(fn, reps: int = 50, replays: int = 3) -> float:
    """Mean milliseconds per call of `fn`, from `replays` replays of a CUDA
    graph of `reps` calls, after three eager warm-up calls on the capture's
    side stream.  `fn` must launch on the current stream and allocate
    through PyTorch."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (replays * reps)
