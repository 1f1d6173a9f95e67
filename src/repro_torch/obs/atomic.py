"""Crash-safe artifact writes: the tmp + fsync + rename protocol (port of
``repro.obs.atomic``), one durability story for every artifact the port
writes (engine snapshots, the compacted journal, metrics exports):

  * files: write to ``<final>.tmp`` in the same directory, flush, fsync,
    then ``os.replace`` onto the final name. A crash mid-export leaves
    either the old artifact or the new one, never a truncated hybrid.
  * directories: build the whole tree under ``<final>.tmp``, fsync the
    last file written (the manifest), then ``os.rename`` the directory.
    POSIX renames are atomic within a filesystem, so a half-written
    bundle is never visible under the final name.
"""
from __future__ import annotations

import contextlib
import os
import shutil
from typing import Iterator

__all__ = ["atomic_write_text", "atomic_dir"]


def atomic_write_text(path: str, data: str) -> None:
    """Atomically replace ``path`` with ``data`` (tmp + fsync + rename)."""
    final = os.path.abspath(path)
    tmp = final + ".tmp"
    with open(tmp, "w") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, final)


@contextlib.contextmanager
def atomic_dir(path: str) -> Iterator[str]:
    """Context manager yielding a tmp directory that atomically replaces
    ``path`` on clean exit. On exception the tmp tree is removed and the
    final name is untouched."""
    final = os.path.abspath(path)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    try:
        yield tmp
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
