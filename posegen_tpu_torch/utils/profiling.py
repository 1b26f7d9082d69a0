"""Tracing and profiling utilities (port of posegen_tpu/utils/profiling.py)
on torch.profiler, NVTX and the CUDA caching allocator.

- `PhaseTimer`: named phase timers with exponential moving averages; a
  phase may wait for the CUDA work that produced some tensors before its
  clock stops (the counterpart of `jax.block_until_ready`).
- `trace(log_dir)`: a torch.profiler trace of the CPU and, where there is a
  card, CUDA activity, written as a Chrome-trace JSON into `log_dir`
  (Perfetto and TensorBoard read it).
- `annotate(name)`: a named region in such a trace
  (`torch.profiler.record_function`), and an NVTX range once CUDA is
  initialised, so that Nsight Systems sees it too.
- `device_memory_stats(device)`: the allocator's MB in use, its peak and the
  card's total, under the JAX package's key names; {} on the CPU, as JAX
  gives there.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

import torch


def _cuda_devices(tree, out: set) -> set:
    """The CUDA devices of the tensors in a tensor or a nested dict / list /
    tuple of them."""
    if isinstance(tree, torch.Tensor):
        if tree.is_cuda:
            out.add(tree.device)
    elif isinstance(tree, dict):
        for v in tree.values():
            _cuda_devices(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _cuda_devices(v, out)
    return out


class PhaseTimer:
    """Named phase timers with exponential moving averages.

    with timer.phase("render", block_on=out): ...   # waits for out's card
    """

    def __init__(self, alpha: float = 0.1):
        self.alpha = alpha
        self.ema: Dict[str, float] = {}
        self.last: Dict[str, float] = {}
        self.count: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str, block_on=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            for dev in _cuda_devices(block_on, set()):
                torch.cuda.synchronize(dev)
            dt = time.perf_counter() - t0
            self.last[name] = dt
            self.count[name] = self.count.get(name, 0) + 1
            prev = self.ema.get(name)
            self.ema[name] = dt if prev is None else (1 - self.alpha) * prev + self.alpha * dt

    def summary(self) -> str:
        return " | ".join(
            f"{k}: {v * 1e3:.1f}ms (x{self.count[k]})" for k, v in self.ema.items()
        )


class Trace:
    """What `trace` yields: the profiler, and the trace file's path once the
    block has ended."""

    def __init__(self, prof):
        self.prof = prof
        self.path: Optional[str] = None


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block; on exit write `log_dir/trace_<pid>_<ns>.json`
    (Chrome trace format), print its path and set it on the yielded Trace."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        holder = Trace(prof)
        yield holder
    holder.path = os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(holder.path)
    print(f"trace written to {holder.path}")


@contextlib.contextmanager
def annotate(name: str):
    """A named region inside a trace (and an NVTX range where CUDA is
    initialised)."""
    nvtx = torch.cuda.is_available() and torch.cuda.is_initialized()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


def device_memory_stats(device=None) -> Dict[str, float]:
    """Memory of a CUDA device in MB: {'mb_in_use', 'peak_mb_in_use',
    'mb_limit'} from the caching allocator's allocated bytes (current and
    peak) and the card's total memory (the reference logs
    torch.cuda.max_memory_allocated, run_nerf.py:607). device: a CUDA
    device, or None for the current one where there is a card; {} for the
    CPU."""
    if device is None:
        if not torch.cuda.is_available():
            return {}
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return {}
    stats = torch.cuda.memory_stats(device)
    mb = 1.0 / (1024 * 1024)
    return {
        "mb_in_use": stats.get("allocated_bytes.all.current", 0) * mb,
        "peak_mb_in_use": stats.get("allocated_bytes.all.peak", 0) * mb,
        "mb_limit": torch.cuda.get_device_properties(device).total_memory * mb,
    }
