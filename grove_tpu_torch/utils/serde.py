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
from json.encoder import encode_basestring_ascii as _quote
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
    encoded document: each dataclass gets a renderer of its own, compiled
    once, and plain values go straight to JSON text. A type with no fast
    rule (a set) takes the general path for its subtree."""
    return _render(obj)


def _render(obj: Any) -> str:
    r = _RENDER.get(type(obj))
    if r is None:
        r = _renderer(type(obj))
    return r(obj)


def _render_float(o: float) -> str:
    # json.dumps's float rule (allow_nan=True).
    if o != o:
        return "NaN"
    if o == _INF:
        return "Infinity"
    if o == -_INF:
        return "-Infinity"
    return float.__repr__(o)


def _render_list(o: list) -> str:
    if not o:
        return "[]"
    if _PLAIN.issuperset(map(type, o)):
        return _plain_dumps(o)  # plain values: json's own encoder
    return "[" + ", ".join([_render(x) for x in o]) + "]"


def _render_dict(o: dict) -> str:
    if not o:
        return "{}"
    if _STR.issuperset(map(type, o)) and _PLAIN.issuperset(map(type, o.values())):
        return _plain_dumps(o)
    if all(isinstance(k, str) for k in o):
        return "{" + ", ".join([_quote(k) + ": " + _render(v) for k, v in o.items()]) + "}"
    return '{"!d": [' + ", ".join(
        ["[" + _render(k) + ", " + _render(v) + "]" for k, v in o.items()]) + "]}"


def _render_tuple(o: tuple) -> str:
    return '{"!u": ' + _render_list(o) + "}"


def _render_general(o: Any) -> str:
    return json.dumps(encode(o))


def _renderer(cls: type):
    """The renderer of `cls`, made and kept on first use."""
    # encode() passes a subclass of a plain type through (a str or int
    # Enum): json.dumps writes it as its plain value.
    for base, plain in ((str, _quote), (int, int.__repr__), (float, _render_float)):
        if issubclass(cls, base):
            _RENDER[cls] = plain
            return plain
    names = _FIELD_NAMES.get(cls)
    if names is None and dataclasses.is_dataclass(cls):
        names = _FIELD_NAMES[cls] = tuple(f.name for f in dataclasses.fields(cls))
    if names is not None:
        # Each field's text: a str, None, bool or empty container inline,
        # anything else by its type's renderer.
        template = ('{"!t": ' + _quote(cls.__name__)
                    + "".join(", " + _quote(n) + ": %s" for n in names) + "}")
        values = "".join(
            f"'null' if (v := o.{n}) is None else q(v) if (t := type(v)) is str"
            " else ('true' if v else 'false') if t is bool"
            " else (render_list(v) if v else '[]') if t is list"
            " else (render_dict(v) if v else '{}') if t is dict"
            " else (get(t) or make(t))(v), " for n in names)
        body = f"{template!r} % ({values})" if names else repr(template)
        scope = {"q": _quote, "get": _RENDER.get, "make": _renderer,
                 "render_list": _render_list, "render_dict": _render_dict}
        exec(f"def render_{cls.__name__}(o):\n    return {body}\n", scope)
        r = scope[f"render_{cls.__name__}"]
    elif issubclass(cls, enum.Enum):
        head = '{"!e": ' + _quote(cls.__name__) + ', "v": '

        def r(o, head=head):  # encode() leaves an Enum's value as it is
            return head + json.dumps(o.value) + "}"
    else:
        r = _render_general
    _RENDER[cls] = r
    return r


_INF = float("inf")
_PLAIN = frozenset((str, int, float, bool, type(None)))
_STR = frozenset((str,))


def _plain_encoder():
    """json.dumps's own C encoder, made once (json.dumps makes one per
    call); json.dumps itself where the C encoder is missing."""
    from json import encoder as j

    if j.c_make_encoder is None:
        return json.dumps
    try:  # 3.12's signature; earlier ones also take the float formatter
        c = j.c_make_encoder(None, None, _quote, None, ": ", ", ", False, False, True)
    except TypeError:
        c = j.c_make_encoder(None, None, _quote, None, _render_float, ": ", ", ",
                             False, False, True)
    return lambda o: "".join(c(o, 0))


_plain_dumps = _plain_encoder()
_RENDER: dict[type, Any] = {
    str: _quote,
    int: int.__repr__,
    float: _render_float,
    bool: lambda o: "true" if o else "false",
    type(None): lambda o: "null",
    list: _render_list,
    dict: _render_dict,
    tuple: _render_tuple,
}


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
