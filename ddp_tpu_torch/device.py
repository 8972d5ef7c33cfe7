"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for another device; with
no GPU and no explicit device they raise instead of dropping to the CPU.
"""
from __future__ import annotations

import collections
import functools
import threading
from typing import Callable, Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means ``"cuda"``. A CUDA device without a visible GPU raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "ddp_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU explicitly")
    return dev


def device_constant(maxsize: int) -> Callable[[Callable], Callable]:
    """A least-recently-used cache of ``maxsize`` entries for a helper that
    builds a constant tensor on a device (an index, a weight, a mask). Run
    eagerly, it builds one copy per arguments and hands it out again: a copy
    from the host cannot be captured in a CUDA graph, and the train step is
    one. While ``torch.export`` or ``torch.compile`` traces, it never fills
    the cache: a constant built there would be a fake tensor, and every later
    eager call would get it. It reads the cache, though: a cached constant is
    a real tensor on the device, which the tracer lifts into the program as
    it is, where one built while tracing becomes a host-to-device copy that
    the program makes at every call."""

    def wrap(fn: Callable) -> Callable:
        cache: "collections.OrderedDict[tuple, torch.Tensor]" = collections.OrderedDict()
        lock = threading.Lock()

        @functools.wraps(fn)
        def call(*args):
            with lock:
                if args in cache:
                    cache.move_to_end(args)
                    return cache[args]
            value = fn(*args)
            if not torch.compiler.is_compiling():
                with lock:
                    value = cache.setdefault(args, value)
                    if len(cache) > maxsize:
                        cache.popitem(last=False)
            return value

        call.cache = cache
        return call

    return wrap
