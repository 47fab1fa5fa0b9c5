"""Stage batches onto the device ahead of the step (port of ``skillful_nowcasting_tpu/data/prefetch.py``).

A background thread takes items from the iterator, turns each numpy array
into a tensor, casts it to ``transfer_dtype`` on the host if asked, and
copies it to the device: into pinned host memory, then ``non_blocking`` on a
side CUDA stream, recording an event that the consumer's stream waits on
before it uses the batch. So the copy of the next batches overlaps the
current step. Tensors already on the device pass through. An exception
raised by the iterator or the copy reaches the consumer.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional

import numpy as np
import torch


class _PrefetchError:
    """A producer-thread exception, carried to the consumer."""

    def __init__(self, exc: BaseException):
        self.exc = exc


def _map(fn, item):
    if isinstance(item, (tuple, list)):
        return type(item)(_map(fn, x) for x in item)
    if isinstance(item, dict):
        return {k: _map(fn, v) for k, v in item.items()}
    return fn(item)


def prefetch_to_device(
    iterator: Iterator,
    size: int = 2,
    device: torch.device | str = "cuda",
    transfer_dtype: Optional[torch.dtype] = None,
) -> Iterator:
    """Yield the items of ``iterator`` staged on ``device`` up to ``size`` batches ahead.

    An item is an array or tensor, or a tuple, list or dict of them. On a
    CUDA ``device`` (the default; it raises without CUDA) host arrays go
    through pinned memory and a side stream; ``device="cpu"`` only turns
    arrays into tensors.

    ``transfer_dtype`` (e.g. ``torch.bfloat16``) casts floating host leaves
    before the copy, halving the bytes moved. It quantizes the data: with
    ``compute_dtype=torch.bfloat16`` the model's inputs are the same bits
    either way, but consumers at f32 (the grid-loss target) then see
    bf16-rounded values, so it is opt-in. Tensors already on the device are
    not cast.
    """
    device = torch.device(device)
    cuda = device.type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise RuntimeError("prefetch_to_device: CUDA is not available; pass device='cpu'")
    if cuda and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return _prefetch(iterator, size, device, transfer_dtype)


def _prefetch(iterator, size, device, transfer_dtype):
    cuda = device.type == "cuda"
    stream = torch.cuda.Stream(device) if cuda else None
    q: "queue.Queue" = queue.Queue(maxsize=max(size, 1))
    stop = threading.Event()
    end = object()

    def to_host_tensor(x):
        t = torch.from_numpy(np.asarray(x)) if not isinstance(x, torch.Tensor) else x
        if t.device.type == "cpu" and transfer_dtype is not None and t.is_floating_point():
            t = t.to(transfer_dtype)
        return t

    def stage(item):
        host = _map(to_host_tensor, item)
        if not cuda:
            return host, None
        with torch.cuda.stream(stream):
            moved = _map(lambda t: t if t.device == device else
                         (t.pin_memory() if t.device.type == "cpu" else t)
                         .to(device, non_blocking=True), host)
            done = torch.cuda.Event()
            done.record(stream)
        return moved, done

    def put(x) -> bool:
        while not stop.is_set():
            try:
                q.put(x, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for item in iterator:
                if not put(stage(item)):
                    return
        except BaseException as e:  # noqa: BLE001 — forwarded to the consumer
            put(_PrefetchError(e))
        else:
            put(end)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        while True:
            got = q.get()
            if got is end:
                return
            if isinstance(got, _PrefetchError):
                raise got.exc
            item, done = got
            if done is not None:
                torch.cuda.current_stream(device).wait_event(done)
                # The side stream's memory is now used on the consumer's stream.
                _map(lambda t: t.record_stream(torch.cuda.current_stream(device)), item)
            yield item
    finally:
        stop.set()
        thread.join(timeout=10)
