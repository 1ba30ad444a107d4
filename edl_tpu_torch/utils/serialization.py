"""JSON round-trip base for cluster-model objects.

A copy of the JAX package's ``utils/serialization.py``: reflection over
``__dict__``, nested objects tagged with ``"__cls__"`` by class name.  The
JSON is the same in both packages, so a ``State`` sidecar written by one
parses in the other.
"""

from __future__ import annotations

import json
from typing import Any


class JsonSerializable:
    def to_dict(self) -> dict:
        def conv(v: Any):
            if isinstance(v, JsonSerializable):
                return {"__cls__": type(v).__name__, **v.to_dict()}
            if isinstance(v, (list, tuple)):
                return [conv(x) for x in v]
            if isinstance(v, dict):
                return {k: conv(x) for k, x in v.items()}
            return v

        return {k: conv(v) for k, v in self.__dict__.items() if not k.startswith("__")}

    def from_dict(self, d: dict) -> "JsonSerializable":
        for k, v in d.items():
            if k == "__cls__":
                continue
            cur = self.__dict__.get(k)
            self.__dict__[k] = _rebuild(v, cur, type(self), k)
        return self

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)

    def from_json(self, s: str) -> "JsonSerializable":
        return self.from_dict(json.loads(s))

    def __eq__(self, other) -> bool:
        return type(self) is type(other) and self.to_dict() == other.to_dict()

    def __ne__(self, other) -> bool:
        return not self.__eq__(other)

    def __hash__(self):
        return hash(self.to_json())

    def __str__(self):
        return self.to_json()


# registry of concrete classes for nested reconstruction
_CLASSES: dict[str, type] = {}


def register_serializable(cls):
    """Class decorator: make nested instances reconstructible by name."""
    _CLASSES[cls.__name__] = cls
    return cls


def _rebuild(v: Any, current: Any, owner: type, key: str) -> Any:
    if isinstance(v, dict):
        if "__cls__" in v:
            cls = _CLASSES.get(v["__cls__"])
            if cls is None:
                raise KeyError(f"unregistered serializable class {v['__cls__']} (field {owner.__name__}.{key})")
            return cls.__new__(cls).from_dict(v)
        return {k: _rebuild(x, None, owner, key) for k, x in v.items()}
    if isinstance(v, list):
        return [_rebuild(x, None, owner, key) for x in v]
    return v
