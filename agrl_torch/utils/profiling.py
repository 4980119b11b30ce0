"""Profiling and memory observability (counterpart of
agrl_tpu/utils/profiling.py).

  * `trace(logdir)` — a context manager around `torch.profiler` with the
    CPU and (where there is a card) CUDA activities; on exit it writes a
    Chrome trace (`trace_<pid>_<n>.json`, viewable in Perfetto or
    chrome://tracing) and a table of the top operations by time
    (`ops_<pid>_<n>.txt`) into `logdir`. The CLI's `--profile-dir` wraps
    the first epoch in it.
  * `device_memory_report()` — live device-memory statistics per card from
    `torch.cuda.memory_stats`, with agrl_tpu's `[mem]` line and record keys.
"""

from __future__ import annotations

import itertools
import os
import os.path as osp
from contextlib import contextmanager

import torch

_TRACE_COUNT = itertools.count()


@contextmanager
def trace(logdir: str):
    """Profile the enclosed region; writes its trace files into `logdir`.
    Yields the torch.profiler.profile object."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.__enter__()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.__exit__(None, None, None)
        tag = f"{os.getpid()}_{next(_TRACE_COUNT)}"
        prof.export_chrome_trace(osp.join(logdir, f"trace_{tag}.json"))
        sort_by = "cuda_time_total" if torch.cuda.is_available() else "cpu_time_total"
        with open(osp.join(logdir, f"ops_{tag}.txt"), "w") as f:
            f.write(prof.key_averages().table(sort_by=sort_by, row_limit=40))


def device_memory_report(print_fn=print) -> list[dict]:
    """Live device-memory statistics per CUDA device (bytes): agrl_tpu's
    records {"device", "bytes_in_use", "peak_bytes_in_use", "bytes_limit"},
    from torch.cuda.memory_stats (allocated bytes, their peak) and the
    card's total memory. Without a card: one record for the CPU, its byte
    counts None (torch keeps no statistics there)."""
    if torch.cuda.is_available():
        records = []
        for i in range(torch.cuda.device_count()):
            stats = torch.cuda.memory_stats(i)
            records.append({
                "device": f"cuda:{i} ({torch.cuda.get_device_name(i)})",
                "bytes_in_use": stats.get("allocated_bytes.all.current"),
                "peak_bytes_in_use": stats.get("allocated_bytes.all.peak"),
                "bytes_limit": torch.cuda.get_device_properties(i).total_memory,
            })
    else:
        records = [{"device": "cpu", "bytes_in_use": None, "peak_bytes_in_use": None,
                    "bytes_limit": None}]
    if print_fn is not None:
        def fmt(b):
            return f"{b / 2**20:.1f}MiB" if isinstance(b, int) else "n/a"

        for rec in records:
            print_fn(f"[mem] {rec['device']}: in_use={fmt(rec['bytes_in_use'])} "
                     f"peak={fmt(rec['peak_bytes_in_use'])} limit={fmt(rec['bytes_limit'])}")
    return records
