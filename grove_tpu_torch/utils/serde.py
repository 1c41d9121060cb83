"""Typed JSON codec for the port's objects (grove_tpu/utils/serde.py
counterpart): a journal's wave records carry their gangs and pods in it.

Encoding rules:
  dataclass -> {"!t": "<registered name>", <field>: <encoded>, ...}
  Enum      -> {"!e": "<registered name>", "v": <value>}
  set       -> {"!s": [..]}     tuple -> {"!u": [..]}
  dict with non-str keys -> {"!d": [[k, v], ..]}
  primitives/list/str-key dict pass through.

Decoding maps each tag onto the registered port type of that name. The
port's host model has every field of the JAX package's (a Pod's lifecycle,
a PodGang's queue and status, a Node's revocation state), so a document
written by either package decodes whole; a field the port's type lacks
would be dropped without being decoded. A tag with no port type of that
name is a hard error, as in the reference: state must not truncate
quietly.
"""

from __future__ import annotations

import dataclasses
import enum
import json
import threading
from json.encoder import encode_basestring_ascii as _quote
from pathlib import Path
from typing import Any

_CLASSES: dict[str, type] = {}


def register(cls: type) -> type:
    """Register a dataclass/enum for decoding (idempotent; name-keyed)."""
    _CLASSES[cls.__name__] = cls
    return cls


def register_module(module) -> None:
    """Register every dataclass and Enum defined in `module`."""
    for name in dir(module):
        obj = getattr(module, name)
        if isinstance(obj, type) and obj.__module__ == module.__name__:
            if dataclasses.is_dataclass(obj) or issubclass(obj, enum.Enum):
                register(obj)


# dataclass -> its field names, looked up once per class (a journal encodes
# thousands of pods per drain).
_FIELD_NAMES: dict[type, tuple[str, ...]] = {}


def encode(obj: Any) -> Any:
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, enum.Enum):
        return {"!e": type(obj).__name__, "v": obj.value}
    cls = type(obj)
    names = _FIELD_NAMES.get(cls)
    if names is None and dataclasses.is_dataclass(cls):
        names = _FIELD_NAMES[cls] = tuple(f.name for f in dataclasses.fields(cls))
    if names is not None:
        doc: dict[str, Any] = {"!t": cls.__name__}
        for name in names:
            doc[name] = encode(getattr(obj, name))
        return doc
    if isinstance(obj, list):
        return [encode(x) for x in obj]
    if isinstance(obj, tuple):
        return {"!u": [encode(x) for x in obj]}
    if isinstance(obj, (set, frozenset)):
        return {"!s": sorted(encode(x) for x in obj)}
    if isinstance(obj, dict):
        if all(isinstance(k, str) for k in obj):
            return {k: encode(v) for k, v in obj.items()}
        return {"!d": [[encode(k), encode(v)] for k, v in obj.items()]}
    raise TypeError(f"cannot encode {type(obj).__name__}: {obj!r}")


def dumps(obj: Any) -> str:
    """`json.dumps(encode(obj))`, byte for byte, without building the
    encoded document (`dumpb`, decoded)."""
    return dumpb(obj).decode("ascii")


def dumpb(obj: Any) -> bytes:
    """`json.dumps(encode(obj)).encode()`, rendered by the C renderer
    (csrc/serde_render.c, built at first use like the CUDA kernels; a build
    that fails raises). The renderer hands a value it has no rule for (a
    set, a plain Enum, an unknown type) back to `_general`."""
    r = _renderer
    if r is None:
        r = _load_renderer()
    return r(obj)


def _general(obj: Any) -> str:
    return json.dumps(encode(obj))


def render_wave(capture: tuple, field) -> bytearray:
    """A journal's wave record as JSON text, rendered by the C renderer
    straight from a capture tuple (trace/recorder.py's CAPTURE slots);
    `field(key, capture)` gives the general path's value of a field whose
    inputs the renderer does not take as they are. The text is a bytearray:
    a text given back by `recycle` that nothing else holds any more, where
    there is one, so records freed together are not faulted in anew, page by
    page, by the next ones."""
    if _module is None:
        _load_renderer()
    return _module.render_wave(capture, field)


def recycle(texts: list) -> None:
    """Give back the texts of `texts` (render_wave's bytearrays among other
    chunks) that nothing but the list holds, for render_wave to reuse: the
    journal's writer lets a segment's texts go together."""
    if _module is not None:
        _module.recycle(texts)


def same_fleet(a, b):
    """The C renderer's comparison of two snapshots' fleets (the recorder's
    fleet digest): False or True, or None where the caller must compare the
    topologies (or arrays the renderer cannot read) itself."""
    if _module is None:
        _load_renderer()
    return _module.same_fleet(a, b)


# type -> what the C renderer does with an object of exactly that type: 0
# hand it to `_general`, 1 a list, 2 a tuple, 3 a dict, or for a dataclass
# (b'{"!t": <name>', field names, b', <name>: ' per field). Filled at a
# type's first sight (`_classify`), in encode's order of checks.
_KINDS: dict[type, Any] = {list: 1, tuple: 2, dict: 3}


def _classify(cls: type) -> Any:
    if issubclass(cls, enum.Enum):
        kind: Any = 0
    else:
        names = _FIELD_NAMES.get(cls)
        if names is None and dataclasses.is_dataclass(cls):
            names = _FIELD_NAMES[cls] = tuple(f.name for f in dataclasses.fields(cls))
        if names is not None:
            kind = (('{"!t": ' + _quote(cls.__name__)).encode(), names,
                    tuple((", " + _quote(n) + ": ").encode() for n in names))
        elif issubclass(cls, tuple):
            kind = 2
        else:  # a list or dict subclass takes encode's way (its own iteration)
            kind = 0
    _KINDS[cls] = kind
    return kind


# Scalar types (numpy's, registered by their user) whose bool() and float()
# equal those of their .item(): render_wave reads a verdict or a score of
# such a type as it is, without the .item() call.
SCALAR_TYPES: set[type] = set()

_renderer = None
_module = None
_renderer_lock = threading.Lock()
# The loaded renderer's file (under grove_tpu_torch/_build/), once built.
renderer_file: str | None = None


def _load_renderer():
    global _renderer, _module, renderer_file
    with _renderer_lock:
        if _renderer is None:
            from grove_tpu_torch.kernels import build

            mod = build.load_extension("_serde_render", _CSRC / "serde_render.c")
            mod.configure(_KINDS, _classify, _general, SCALAR_TYPES)
            renderer_file = mod.__file__
            _module = mod
            _renderer = mod.render
    return _renderer


_CSRC = Path(__file__).resolve().parent / "csrc"


def load_renderer():
    """Build (at first use) and load the C renderer; a failed build raises.
    The manager calls this at start, so its first journaled wave does not
    wait for the compiler."""
    return _renderer if _renderer is not None else _load_renderer()


def _camel(name: str) -> str:
    parts = name.split("_")
    return parts[0] + "".join(w.capitalize() for w in parts[1:])


def to_k8s(obj: Any) -> Any:
    """Dataclass -> k8s-wire-shaped plain dict: camelCase keys, enum values,
    empty/None fields dropped (CR status subresource convention). The watch
    driver's status push renders PodCliqueSet status with it, as the
    reference persists it through the apiserver (reconcilestatus.go)."""
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, enum.Enum):
        return obj.value
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        out: dict[str, Any] = {}
        for f in dataclasses.fields(obj):
            v = to_k8s(getattr(obj, f.name))
            if v is None or v == [] or v == {}:
                continue
            out[_camel(f.name)] = v
        return out
    if isinstance(obj, (list, tuple)):
        return [to_k8s(x) for x in obj]
    if isinstance(obj, dict):
        return {str(k): to_k8s(v) for k, v in obj.items()}
    if isinstance(obj, (set, frozenset)):
        return sorted(to_k8s(x) for x in obj)
    raise TypeError(f"cannot render {type(obj).__name__} for the k8s wire")


def decode(doc: Any) -> Any:
    if doc is None or isinstance(doc, (bool, int, float, str)):
        return doc
    if isinstance(doc, list):
        return [decode(x) for x in doc]
    if isinstance(doc, dict):
        if "!e" in doc:
            return _lookup(doc["!e"])(doc["v"])
        if "!t" in doc:
            cls = _lookup(doc["!t"])
            fields = {f.name: f for f in dataclasses.fields(cls)}
            kept = {k: decode(v) for k, v in doc.items() if k in fields}
            obj = cls(**{k: v for k, v in kept.items() if fields[k].init})
            for k, v in kept.items():
                if not fields[k].init:
                    setattr(obj, k, v)
            return obj
        if "!s" in doc:
            return set(decode(x) for x in doc["!s"])
        if "!u" in doc:
            return tuple(decode(x) for x in doc["!u"])
        if "!d" in doc:
            return {decode(k): decode(v) for k, v in doc["!d"]}
        return {k: decode(v) for k, v in doc.items()}
    raise TypeError(f"cannot decode {type(doc).__name__}: {doc!r}")


def _lookup(name: str) -> type:
    cls = _CLASSES.get(name)
    if cls is None:
        raise KeyError(
            f"serde: type {name!r} not registered — a document from a newer "
            "schema, or a type the port does not have"
        )
    return cls
