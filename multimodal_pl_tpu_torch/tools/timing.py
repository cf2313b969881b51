"""Timing on the card, for chip_smoke.py and the scripts of this package."""

from __future__ import annotations


def graph_ms(fn, reps: int) -> float:
    """Device time of one fn() call: after two warm-up calls fn is captured
    once into a CUDA graph, and the graph is replayed reps times between CUDA
    events, so the host's launch costs stay out of the time."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / reps


def event_ms(fn, reps: int) -> float:
    """Time of one fn() call as the host issues it (launches included): CUDA
    events around reps calls, after two warm-up calls."""
    import torch

    for _ in range(2):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps
