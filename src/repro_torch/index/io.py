"""Durable-file helpers shared by the port's atomic savers.

Only ``fsync_dir`` is here so far: the sharded index directory format of the
reference's ``repro.index.io`` arrives with the persistence slice."""
from __future__ import annotations

import os


def fsync_dir(path) -> None:
    """fsync a *directory* so a rename just committed inside it survives
    power failure (``tmp → fsync(file) → os.replace`` makes the bytes
    durable; the new name lives in the directory inode).  No-op where the
    platform refuses directory opens or directory fsync."""
    flags = os.O_RDONLY | getattr(os, "O_DIRECTORY", 0)
    try:
        fd = os.open(os.fspath(path), flags)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)
