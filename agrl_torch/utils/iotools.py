"""Filesystem helpers: json IO, directory creation, existence checks
(copy of agrl_tpu/utils/iotools.py).

Parity with reference torchreid/utils/iotools.py:13-55 (checkpoint saving
itself lives in agrl_torch.core.checkpoint).
"""

from __future__ import annotations

import errno
import json
import os
import os.path as osp
import warnings


def mkdir_if_missing(directory: str) -> None:
    # '' = bare filename (cwd): nothing to create — os.makedirs('') raises
    if directory and not osp.exists(directory):
        try:
            os.makedirs(directory)
        except OSError as e:
            if e.errno != errno.EEXIST:
                raise


def check_isfile(path: str) -> bool:
    isfile = osp.isfile(path)
    if not isfile:
        warnings.warn(f'No file found at "{path}"')
    return isfile


def read_json(fpath: str):
    with open(fpath, "r") as f:
        return json.load(f)


def write_json(obj, fpath: str) -> None:
    mkdir_if_missing(osp.dirname(fpath))
    with open(fpath, "w") as f:
        json.dump(obj, f, indent=4, separators=(",", ": "))
