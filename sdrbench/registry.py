"""The benchmark's parts found by name, each in a file of its own under
sdrbench/: configurations (configs/), traffic mixes (traffic/), a cell's
limits (checks/) and capture formats (captures/) as JSON; per-layer and
end-to-end metric readers (metrics/), reference chain kinds (chains/)
and RF station kinds (stations/) as Python modules. A new one is a new
file; no file here names them.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def path(folder: str, name: str, ext: str) -> str:
    return os.path.join(HERE, folder, name + ext)


def load_json(folder: str, name: str) -> dict:
    with open(path(folder, name, ".json")) as f:
        return json.load(f)


def module(folder: str, name: str):
    """The module <folder>/<name>.py, loaded once a process."""
    key = f"sdrbench.{folder}.{name}"
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            key, path(folder, name, ".py"))
        if spec is None or not os.path.exists(spec.origin):
            raise KeyError(f"no {folder}/{name}.py in sdrbench")
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        try:
            spec.loader.exec_module(mod)
        except BaseException:
            del sys.modules[key]
            raise
    return sys.modules[key]
