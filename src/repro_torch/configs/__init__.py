"""Architecture registry: one module per assigned architecture, each
exporting full() and smoke() ModelConfigs (copies of the JAX package's).
``get(name, smoke=...)`` is what the chip smoke and the tests use; COBS
index presets live in cobs.py.
"""
from __future__ import annotations

import importlib

ARCHS = (
    "recurrentgemma-2b",
    "phi4-mini-3.8b",
    "qwen3-4b",
    "qwen2.5-3b",
    "granite-3-8b",
    "whisper-large-v3",
    "qwen3-moe-30b-a3b",
    "llama4-scout-17b-a16e",
    "qwen2-vl-7b",
    "xlstm-125m",
)

_MOD = {a: a.replace("-", "_").replace(".", "_") for a in ARCHS}


def get(name: str, smoke: bool = False):
    if name not in _MOD:
        raise KeyError(f"unknown arch {name!r}; one of {ARCHS}")
    mod = importlib.import_module(f"{__name__}.{_MOD[name]}")
    return mod.smoke() if smoke else mod.full()


def list_archs() -> tuple[str, ...]:
    return ARCHS
