"""Host->device prefetching: the port of resnet_tpu.data.prefetch for one
CUDA device.

The reference's input path is fully synchronous: fread + memcpy + cudaMemcpy
on the training thread every step (load_new_batch, resnet.cu:1235-1325), a
known bottleneck its own comment concedes (resnet.cu:1233). Here a
background thread stages the next ``depth`` batches onto the device while
the current step computes.

On the card, the worker thread copies each host batch into one of
``depth + 1`` pinned staging slots and enqueues the host-to-device copy on a
side stream, recording an event after it. Two hazards shape the code:

- a slot is refilled only after the event of its previous copy completed,
  or the next batch would overwrite memory the DMA is still reading;
- the consumer makes its stream wait on the batch's event and calls
  ``record_stream`` on each tensor: the tensors were allocated on the side
  stream, and without it the caching allocator could hand their memory out
  again while the step still reads it.

On the CPU (an explicit ``device="cpu"``) the same code runs with plain
copies: no pinning, no stream.

Across ranks each rank runs its own prefetcher onto its own device. Where
its source yields a whole host batch, ``rows`` (``parallel.mesh.rows_of``
bound to the rank) cuts the rank's rows on the host before they are
staged, so only those are copied; on a data x spatial grid it also cuts
the rank's slice of each image's height (``parallel.mesh.height_slice``,
the Trainer's ``_rows``), so a rank copies only its own part of the image.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np
import torch

from ..config import resolve_dtype


def _host_tensor(x) -> torch.Tensor:
    """A CPU tensor of ``x`` (numpy array or tensor), sharing its memory
    where that is safe; a read-only array (a memmapped shard) is copied."""
    if isinstance(x, torch.Tensor):
        return x
    x = np.asarray(x)
    return torch.from_numpy(x) if x.flags.writeable else torch.tensor(x)


class DevicePrefetcher:
    """Iterator of device batches, ``depth`` of them staged ahead of the
    consumer. A batch's ``cursor`` passes through on the host; with
    ``transfer_dtype`` the images are cast on the host before the copy
    (bf16 halves the traffic; the model casts them to its compute dtype)."""

    def __init__(self, source: Iterator, *, depth: int = 2, device="cuda",
                 transfer_dtype=None, rows=None):
        self.source = source
        self.rows = rows
        self.depth = depth
        self.device = torch.device(device)
        self.transfer_dtype = resolve_dtype(transfer_dtype) if transfer_dtype else None
        self._cuda = self.device.type == "cuda"
        if self._cuda and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._done = object()
        self._err: Optional[BaseException] = None
        self._stop = False
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _dtype(self, key, src: torch.Tensor):
        if key == "images" and self.transfer_dtype is not None:
            return self.transfer_dtype
        return src.dtype

    def _put_cpu(self, batch) -> Dict[str, torch.Tensor]:
        out = {}
        for k, v in batch.items():
            src = _host_tensor(v)
            dtype = self._dtype(k, src)
            # an owned copy, as a device transfer would give
            out[k] = src.to(dtype) if dtype != src.dtype else src.clone()
        return out

    def _put_cuda(self, batch, slot, slots, events, stream):
        """Copy ``batch`` through pinned slot ``slot`` on ``stream``."""
        if events[slot] is not None:
            events[slot].synchronize()  # the slot's previous DMA has finished
        pinned = slots[slot]
        out = {}
        for k, v in batch.items():
            src = _host_tensor(v)
            dtype = self._dtype(k, src)
            buf = pinned.get(k)
            if buf is None or buf.shape != src.shape or buf.dtype != dtype:
                buf = pinned[k] = torch.empty(src.shape, dtype=dtype, pin_memory=True)
            buf.copy_(src)  # the bf16 cast, if any, rounds to nearest even
            with torch.cuda.stream(stream):
                out[k] = buf.to(self.device, non_blocking=True)
        event = torch.cuda.Event()
        event.record(stream)
        events[slot] = event
        return out, event

    def _worker(self):
        try:
            if self._cuda:
                torch.cuda.set_device(self.device)  # the current stream is per thread
                stream = torch.cuda.Stream(self.device)
                slots = [{} for _ in range(self.depth + 1)]
                events = [None] * (self.depth + 1)
            n = 0
            for batch in self.source:
                if self._stop:
                    return
                batch = dict(batch)
                # the per-batch shard cursor is host bookkeeping, not device data
                cursor = batch.pop("cursor", None)
                if self.rows is not None:
                    batch = self.rows(batch)
                if self._cuda:
                    out, event = self._put_cuda(batch, n % (self.depth + 1), slots,
                                                events, stream)
                else:
                    out, event = self._put_cpu(batch), None
                n += 1
                self._q.put((out, event, cursor))
                if self._stop:
                    return
        except BaseException as e:  # surfaced on the consumer thread
            self._err = e
        finally:
            if not self._stop:
                self._q.put(self._done)

    def stop(self):
        """Shut the worker down and drain the queue. The owner stops the
        pipeline before exiting: a daemon thread mid-copy at interpreter
        exit can abort the process."""
        self._stop = True
        while self._thread.is_alive():
            try:
                self._q.get_nowait()  # unblock a worker stuck in put()
            except queue.Empty:
                pass
            self._thread.join(timeout=0.2)
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break

    def qsize(self) -> int:
        """Device-ready queue depth: full means the loader outruns the step,
        0 means the step waits for input."""
        return self._q.qsize()

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, torch.Tensor]:
        item = self._q.get()
        if item is self._done:
            if self._err is not None:
                raise self._err
            raise StopIteration
        out, event, cursor = item
        if event is not None:
            current = torch.cuda.current_stream(self.device)
            current.wait_event(event)
            for t in out.values():
                t.record_stream(current)
        if cursor is not None:
            out["cursor"] = cursor
        return out


def prefetch_to_device(source, *, depth: int = 2, device="cuda",
                       transfer_dtype=None, rows=None) -> DevicePrefetcher:
    """Wrap a host batch iterator in a device prefetcher on ``device`` (the
    card unless the caller asks for the CPU); ``rows`` maps each host batch
    to the rows this rank stages."""
    return DevicePrefetcher(source, depth=depth, device=device,
                            transfer_dtype=transfer_dtype, rows=rows)
