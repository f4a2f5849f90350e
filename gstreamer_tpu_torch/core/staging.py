"""Host -> device staging of the arrays that sources pull (the buffer-pool
analog, gstbufferpool.c:125; the JAX package's ``Pipeline._stage_buf``).

On CUDA a host array is copied into a page-locked buffer, then to the card
with ``non_blocking=True`` on a copy stream of its own; a page-locked CPU
tensor (filesrc reads into one) goes to the card without the first copy.
The page-locked buffers come from torch's caching host allocator, so they
are reused across ticks: a buffer goes back to the cache when its tick is
staged, and the allocator hands it out again only after the copy that read
it has finished (it records the copy's stream).  The compute stream waits
on an event recorded after the copy, and the staged tensor is marked as
used on the compute stream (``record_stream``), so the caching device
allocator gives its memory to nobody else while compute reads it.  The host
never waits for a copy.  With ``Pipeline.compile(prefetch=True)`` the next
tick is staged right after the current tick's step is queued, so its copy
overlaps that step.

On the CPU a host array becomes a tensor without a copy when it is
contiguous and writable.
"""

from __future__ import annotations

import numpy as np
import torch

from .buffer import map_leaves


class Stager:
    def __init__(self, device: torch.device):
        self.device = device
        self._stream = None

    def stage(self, data):
        """`data` (a buffer's data tree) with every array on the device:
        numpy arrays and host tensors are copied there, a tensor already
        there stays, text and bytes leaves stay on the host."""
        return map_leaves(self._leaf, data)

    def _leaf(self, x):
        if isinstance(x, np.ndarray):
            if not x.dtype.isnative:
                x = x.astype(x.dtype.newbyteorder("="))
            if self.device.type != "cuda":
                if not (x.flags.c_contiguous and x.flags.writeable):
                    x = np.array(x)
                return torch.from_numpy(x).to(self.device)
            if x.size == 0:
                return torch.from_numpy(np.array(x)).to(self.device)
            dtype = torch.from_numpy(np.empty(0, x.dtype)).dtype
            pinned = torch.empty(x.shape, dtype=dtype, pin_memory=True)
            np.copyto(pinned.numpy(), x)
            return self._to_card(pinned)
        if isinstance(x, torch.Tensor) and x.device != self.device:
            if self.device.type == "cuda" and x.device.type == "cpu":
                return self._to_card(x if x.is_pinned() else x.pin_memory())
            return x.to(self.device)
        return x

    def _to_card(self, pinned: torch.Tensor) -> torch.Tensor:
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        with torch.cuda.stream(self._stream):
            staged = pinned.to(self.device, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self._stream)
        compute = torch.cuda.current_stream(self.device)
        compute.wait_event(done)
        staged.record_stream(compute)
        return staged
