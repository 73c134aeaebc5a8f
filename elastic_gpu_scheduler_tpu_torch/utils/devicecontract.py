"""The device plugin's allocation, honoured by this process.

The plugin's ``Allocate`` (``deviceplugin/plugin.py``) gives a fractional
tenant ``TPU_CORE_PERCENT``: its smallest share of a card, in percent.
JAX honours the share by itself (``XLA_PYTHON_CLIENT_MEM_FRACTION``);
PyTorch's caching allocator honours nothing, so a fractional tenant of the
port would grow over its neighbours' share of the card.  Every entry point
of the port (``serve.main``, each ``serve.follow_rank``, ``launcher.main``)
calls :func:`apply_allocation` before its first CUDA allocation, which
caps the allocator at that share of the card's memory.  A share is a cap
on memory only: cores are time-sliced cooperatively, as on the reference's
TPU node.
"""

from __future__ import annotations

import os

__all__ = ["apply_allocation"]


def apply_allocation(device) -> float:
    """Cap the caching allocator of ``device`` (a CUDA device) at the
    allocation's share of the card (``TPU_CORE_PERCENT``; unset: a whole
    card, or no plugin); nothing on the CPU or for a whole card.  Returns
    the fraction applied (1.0: none)."""
    import torch

    device = torch.device(device)
    pct = int(os.environ.get("TPU_CORE_PERCENT", "").strip() or 100)
    if device.type != "cuda" or pct >= 100:
        return 1.0
    if pct <= 0:
        raise ValueError(f"TPU_CORE_PERCENT={pct}: no share of the card to run on")
    fraction = pct / 100
    index = device.index if device.index is not None else torch.cuda.current_device()
    torch.cuda.set_per_process_memory_fraction(fraction, index)
    return fraction
