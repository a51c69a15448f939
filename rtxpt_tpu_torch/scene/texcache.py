"""Asynchronous texture decode (counterpart of rtxpt_tpu/scene/texcache.py;
donut TextureCache LoadTextureFromFileAsync,
donut/include/donut/engine/TextureCache.h:127).

Decode jobs run on a host ThreadPoolExecutor, one per unique source, while
geometry flattening and the trace-structure builds proceed; consumers
resolve the futures only where texel data is needed (the texture-stack
build, the opacity-mask bake). A decode error is raised where the future
is resolved."""
from __future__ import annotations

from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Hashable, Optional


class TextureCache:
    """Thread-pool decode with key dedup (one job per unique source)."""

    def __init__(self, max_workers: int = 8):
        self._pool = ThreadPoolExecutor(max_workers=max_workers)
        self._jobs: dict = {}

    def submit(self, key: Optional[Hashable], fn: Callable) -> Future:
        if key is not None and key in self._jobs:
            return self._jobs[key]
        fut = self._pool.submit(fn)
        if key is not None:
            self._jobs[key] = fut
        return fut

    def shutdown(self):
        self._pool.shutdown(wait=False)


def resolve_image(x):
    """Future -> decoded array; decoded arrays pass through."""
    return x.result() if isinstance(x, Future) else x


def resolve_images(images):
    """Join a list of futures and arrays in place order."""
    if not images:
        return images
    return [resolve_image(x) for x in images]
