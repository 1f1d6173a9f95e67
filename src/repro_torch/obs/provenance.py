"""Provenance header of every serialized artifact of the port (port of
``repro.obs.provenance``): the versions, device and git revision that
produced it. Where the JAX package records jax and its backend, the port
records torch, CUDA, the backend (``cuda`` or ``cpu``), the card's name
(``torch.cuda.get_device_name``) and the device count.
"""
from __future__ import annotations

import os
import time


def git_revision(root: str | None = None) -> dict:
    """Best-effort (commit, dirty) of the repo this package sits in —
    None values rather than a crash when git or the .git dir is
    unavailable (artifacts get copied around; provenance should survive
    that)."""
    import subprocess
    if root is None:
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__)))))
    try:
        commit = subprocess.run(
            ["git", "rev-parse", "HEAD"], cwd=root, capture_output=True,
            text=True, timeout=10, check=True).stdout.strip()
        dirty = bool(subprocess.run(
            ["git", "status", "--porcelain"], cwd=root,
            capture_output=True, text=True, timeout=10,
            check=True).stdout.strip())
        return {"git_commit": commit, "git_dirty": dirty}
    except Exception:
        return {"git_commit": None, "git_dirty": None}


def provenance(seed=None) -> dict:
    """Environment + revision header embedded in every artifact."""
    import platform

    import torch
    cuda = torch.cuda.is_available()
    return {
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "backend": "cuda" if cuda else "cpu",
        "device_kind": torch.cuda.get_device_name(0) if cuda else "cpu",
        "n_devices": torch.cuda.device_count() if cuda else 1,
        "python": platform.python_version(),
        "platform": platform.platform(),
        "seed": seed,
        "timestamp": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
        **git_revision(),
    }
