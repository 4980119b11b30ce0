"""Stdout tee logger + lightweight scalar writer (copy of
agrl_tpu/utils/logger.py).

`Logger` mirrors the reference's behavior (torchreid/utils/logger.py:11-48):
everything printed to stdout is also appended to a log file, each line
prefixed with wall-clock time, flushed + fsynced so logs survive crashes.

`ScalarWriter` replaces tensorboardX's SummaryWriter (the reference's
scalar sink, train_vidreid_xent_htri.py:178,446-447): scalars are appended
to a JSONL file (`scalars.jsonl`) which any plotting tool can consume, AND
to a real TensorBoard event file via the dependency-free writer in
utils.tbevents — a migrating user's TB dashboards keep working.
"""

from __future__ import annotations

import json
import os
import os.path as osp
import sys
import time

from agrl_torch.utils.iotools import mkdir_if_missing


def cur_time() -> str:
    return time.strftime("%Y-%m-%d %H:%M:%S", time.localtime())


class Logger:
    """Write console output to an external text file as well."""

    def __init__(self, fpath: str | None = None):
        self.console = sys.stdout
        self.file = None
        self._at_line_start = True
        if fpath is not None:
            mkdir_if_missing(osp.dirname(fpath))
            self.file = open(fpath, "w")

    def __del__(self):
        self.close()

    def write(self, msg: str) -> None:
        self.console.write(msg)
        if self.file is not None:
            if self._at_line_start and msg.strip():
                self.file.write(f"[{cur_time()}] ")
            self.file.write(msg)
            self._at_line_start = msg.endswith("\n")

    def flush(self) -> None:
        self.console.flush()
        if self.file is not None:
            self.file.flush()
            os.fsync(self.file.fileno())

    def close(self) -> None:
        self.console.flush()
        if self.file is not None:
            self.file.close()
            self.file = None


class ScalarWriter:
    """TB-compatible scalar sink: JSONL + native TB event file, always."""

    def __init__(self, log_dir: str):
        from agrl_torch.utils.tbevents import EventFileWriter

        mkdir_if_missing(log_dir)
        self._jsonl = open(osp.join(log_dir, "scalars.jsonl"), "a")
        self._tb = EventFileWriter(log_dir)

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        rec = {"tag": tag, "value": float(value), "step": int(step), "ts": time.time()}
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        self._tb.add_scalar(tag, value, step)

    def close(self) -> None:
        self._jsonl.close()
        self._tb.close()
