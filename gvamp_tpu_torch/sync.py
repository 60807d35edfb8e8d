"""Counted host syncs.

The JAX engine keeps every loop on the device (``lax.while_loop`` /
``lax.cond``).  In the eager port each such exit test or branch reads one
device value on the host, which waits for the device: a host sync.  Every
one of them goes through :func:`host_bool` or :func:`host_values`, so a run
can report how many syncs an iteration cost (``SYNCS``, kept in
``gvamp_tpu_torch.trace``, is read around each VAMP iteration).  Under a
profiler each read is a span (``host_bool`` / ``host_values``): the host's
wait on the device.
"""

from __future__ import annotations

import torch

from gvamp_tpu_torch.trace import SYNCS, span

__all__ = ["SYNCS", "host_bool", "host_values"]


def host_bool(x: torch.Tensor) -> bool:
    """Read one boolean device value on the host (one counted sync)."""
    with span("host_bool"):
        SYNCS["count"] += 1
        return bool(x)


def host_values(tensors: list) -> list:
    """Copy a list of tensors to the host in one transfer (one counted
    sync); returns numpy arrays of the original shapes, in float64."""
    with span("host_values"):
        SYNCS["count"] += 1
        flat = torch.cat([t.detach().reshape(-1).to(torch.float64)
                          for t in tensors]).cpu().numpy()
    out, at = [], 0
    for t in tensors:
        n = t.numel()
        out.append(flat[at:at + n].reshape(tuple(t.shape)))
        at += n
    return out
