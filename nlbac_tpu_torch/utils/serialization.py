"""Best-effort JSON conversion of arbitrary config objects (the port's
copy of ``nlbac_tpu/utils/serialization.py``): turn any object into
something json-dumpable, recursing through containers and falling back to
repr."""

from __future__ import annotations

import dataclasses
from typing import Any


def _is_json_leaf(v: Any) -> bool:
    return v is None or isinstance(v, (bool, int, float, str))


def convert_json(obj: Any) -> Any:
    if _is_json_leaf(obj):
        return obj
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: convert_json(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, dict):
        return {str(k): convert_json(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple, set)):
        return [convert_json(v) for v in obj]
    if hasattr(obj, "__name__") and not hasattr(obj, "__call__"):
        return str(obj.__name__)
    if hasattr(obj, "tolist"):  # numpy arrays and tensors
        try:
            return obj.tolist()
        except Exception:
            pass
    if hasattr(obj, "__dict__") and obj.__dict__:
        return {"__class__": type(obj).__name__,
                **{str(k): convert_json(v) for k, v in obj.__dict__.items()
                   if not str(k).startswith("_")}}
    return repr(obj)
