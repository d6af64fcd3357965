"""Named spans of the port's serving and training steps.

``with span("kv.append"): ...`` marks a stretch of host work for a torch
profiler.  While one records, the span is a ``record_function`` range: an
event in kineto's timeline, on the same clock as the device's activity, so
a trace can say which span held the host while the card sat idle, and
which span launched each device operation.  With no profiler recording, a
span is one module attribute read and a shared empty context: there is no
switch, and nothing to turn on but the profiler itself.

Spans open once per step or layer-step, never once per cache or per row.
Names start with ``serve.``, ``kv.``, ``moe.`` or ``train.``:

    serve.step            SessionScheduler.step
    serve.admit           an admission: caches, prefill, first token
    kv.alloc              the admission's tiered caches (pinned host tier)
    serve.prefill         the model's prefill of the prompt
    serve.decode          a decode dispatch, through its token read
    serve.decode.wait     the read that waits for the dispatch's tokens
    kv.append             a layer-step's appends into every session
    kv.stage              a layer-step's uploads of new cold pages
    kv.flush              a cache's host write-through, where it copies
    kv.ring               a window layer-step's appends into the sliding
                          rings, and its attend over them
    moe.route             an expert share's routing and row layout
    moe.experts           the held experts' grouped product and each
                          token's sum of its assignments
    moe.shared            the shared experts
    serve.retire          a session's retirement (frees pinned memory)
    serve.memory          the per-tier budget walk
    train.forward_backward  the loss and its gradients
    train.optimizer       the optimizer's update and its application
"""

from __future__ import annotations

import contextlib

from torch.autograd import profiler as _profiler
from torch.profiler import record_function

__all__ = ["span"]

_OFF = contextlib.nullcontext()


def span(name: str):
    """A ``record_function(name)`` range while a torch profiler records,
    else one shared null context."""
    if _profiler._is_profiler_enabled:
        return record_function(name)
    return _OFF
