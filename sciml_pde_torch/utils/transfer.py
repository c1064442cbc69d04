"""Bounded-memory host -> device transfer of large trajectory stores (port
of ``sciml_pde_tpu/utils/transfer.py``).

A store of many GB goes to the card in leading-axis chunks: the device
buffer is allocated once, and each chunk is copied from numpy into one of
two reused pinned staging slots, then to the card with ``non_blocking``
copies.  A slot is refilled only after the event recorded behind its last
copy has completed, so the host keeps at most two chunks of staging memory
(not a second copy of the store) and the copy of chunk k to the card
overlaps the host's copy of chunk k + 1 into the other slot.
"""

from __future__ import annotations

import numpy as np
import torch

from sciml_pde_torch._device import resolve_device

_DEFAULT_CHUNK_BYTES = 1 << 30  # 1 GiB

# the last chunked call's bookkeeping: chunks copied, staging bytes allocated
LAST_STATS: dict = {"chunks": 0, "staging_bytes": 0}


def device_put_chunked(arr, max_chunk_bytes: int | None = None, device=None,
                       dtype: torch.dtype | None = None) -> torch.Tensor:
    """``arr`` (numpy or a tensor) on ``device`` (CUDA unless the CPU is
    asked for), in ``dtype`` (default: its own), equal to
    ``torch.as_tensor(arr, dtype=dtype, device=device)``.

    A tensor already on ``device`` comes back as it is (converted to
    ``dtype``); a numpy array is always copied, on the CPU too.  At or below ``max_chunk_bytes``, a 0-d array and an array
    of one row go in one copy.  Above that the rows go in chunks of
    ``max_chunk_bytes // row_bytes`` rows, the ragged tail last, through
    two staging slots of one chunk each (pinned on CUDA); a chunk converts
    to ``dtype`` as it enters its slot.  ``LAST_STATS`` then holds the
    number of chunks and the staging bytes.  ``max_chunk_bytes`` None reads
    the module's ``_DEFAULT_CHUNK_BYTES`` (1 GiB) at the call."""
    dev = resolve_device(device)
    max_chunk_bytes = _DEFAULT_CHUNK_BYTES if max_chunk_bytes is None else max_chunk_bytes
    if isinstance(arr, torch.Tensor):
        if arr.device.type == dev.type and dev.index in (None, arr.device.index):
            return arr if dtype is None else arr.to(dtype)
        src = arr
    else:
        src = torch.from_numpy(np.ascontiguousarray(arr))
    dtype = src.dtype if dtype is None else dtype
    nbytes = src.numel() * torch.empty((), dtype=dtype).element_size()
    if nbytes <= max_chunk_bytes or src.ndim == 0 or src.shape[0] <= 1:
        return src.to(device=dev, dtype=dtype)
    src = src.contiguous()
    n = src.shape[0]
    row_bytes = max(nbytes // n, 1)
    rows = max(int(max_chunk_bytes // row_bytes), 1)
    out = torch.empty(src.shape, dtype=dtype, device=dev)
    pin = dev.type == "cuda"
    slots = [torch.empty((rows, *src.shape[1:]), dtype=dtype, pin_memory=pin)
             for _ in range(2)]
    events = [None, None]
    chunks = 0
    for i in range(0, n, rows):
        k = chunks % 2
        if events[k] is not None:
            events[k].synchronize()  # the slot's last copy to the card has finished
        m = min(rows, n - i)
        stage = slots[k][:m]
        stage.copy_(src[i:i + m])
        out[i:i + m].copy_(stage, non_blocking=pin)
        if pin:
            events[k] = torch.cuda.Event()
            events[k].record()
        chunks += 1
    if pin:
        torch.cuda.current_stream(dev).synchronize()
    LAST_STATS.update(chunks=chunks, staging_bytes=sum(s.numel() * s.element_size()
                                                       for s in slots))
    return out
