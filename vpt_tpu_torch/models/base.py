"""Renderer registry + string-keyed factory (counterpart of
``vpt_tpu/models/base.py``).

A renderer exposes ``reset(camera, seed) -> state`` and
``render(state, camera, seed) -> (state, hdr_image)``; progressive
accumulation is repeated ``render`` calls, and any camera or config change
calls ``reset``.
"""

from __future__ import annotations

from typing import Callable, Dict

RENDERERS: Dict[str, Callable] = {}


def register_renderer(key: str):
    def wrap(cls):
        RENDERERS[key] = cls
        cls.key = key
        return cls

    return wrap


def make_renderer(key: str, *args, **kw):
    """Factory dispatch by string key."""
    try:
        cls = RENDERERS[key]
    except KeyError:
        raise ValueError(f"unknown renderer {key!r}; known: {sorted(RENDERERS)}") from None
    return cls(*args, **kw)
