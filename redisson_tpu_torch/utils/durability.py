"""Shared durability primitives for the persistence planes.

A copy of ``redisson_tpu/utils/durability.py``.  Checkpoint snapshots
(``core/checkpoint``) need the POSIX discipline: after ``os.replace`` or a
file's creation, the RENAME ITSELF lives in the parent directory's data
blocks, so only an fsync of the directory makes it durable across power
loss.
"""
from __future__ import annotations

import os


def fsync_dir(dirpath: str) -> None:
    """fsync a directory so a just-completed rename/creation is durable."""
    fd = os.open(dirpath or ".", os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)
