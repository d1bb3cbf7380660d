"""Reflection serde: compact self-describing binary for registered dataclasses.

Mirrors the reference's serde layer (common/serde/Serde.h SERDE_STRUCT_FIELD):
message structs are plain dataclasses registered with @serde_struct; encoding
is a compact tagged binary (varints, length-prefixed bytes/str, lists, maps,
typed structs by registered name).  Decode reconstructs the registered class
and coerces enum/nested fields from type hints.

The reference pays its reflection cost at COMPILE time (template machinery in
Serde.h); the python analog of that decision is the per-class plan compiled
here on first use — precomputed struct headers, field-name tuples, and
per-field coercer closures — so the per-message hot path never touches
`dataclasses.fields`, `typing.get_origin` or `get_type_hints` (profiled at
~40% of storage-node CPU on the small-IO path before this).

Bulk data (chunk payloads) does NOT travel through serde — it rides the
transport's out-of-band buffer path (net/transport.py), like the reference's
RDMA bufs vs serde messages split.
"""

from __future__ import annotations

import enum
import struct
import types
import typing
from dataclasses import fields, is_dataclass

_registry: dict[str, type] = {}
_plan_cache: dict[type, "_Plan"] = {}


def serde_struct(cls):
    """Register a dataclass for typed wire encoding.

    Names are globally unique on the wire: a second registration of the same
    name from a DIFFERENT module is a hard error — otherwise decode would
    silently build the wrong class for every peer (the reference avoids this
    by fully-typed per-method reflection, Serde.h:25-59)."""
    assert is_dataclass(cls), f"{cls} must be a dataclass"
    prev = _registry.get(cls.__name__)
    if prev is not None and prev.__module__ != cls.__module__:
        raise TypeError(
            f"serde name collision: {cls.__name__} already registered by "
            f"{prev.__module__}, redefined in {cls.__module__}")
    _registry[cls.__name__] = cls
    return cls


# --- tags ---
T_NONE, T_FALSE, T_TRUE, T_INT, T_NEGINT, T_FLOAT = 0, 1, 2, 3, 4, 5
T_BYTES, T_STR, T_LIST, T_MAP, T_STRUCT = 6, 7, 8, 9, 10

_B_NONE, _B_FALSE, _B_TRUE = bytes([T_NONE]), bytes([T_FALSE]), bytes([T_TRUE])
_pack_d = struct.Struct("<d").pack
_unpack_d = struct.Struct("<d").unpack_from


def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


class _Plan:
    """Per-class compiled serde plan (built once, on first encode/decode).

    `enc` is a type-specialized encoder generated from the class's hints
    (the python analog of the reference's compile-time template encoders):
    each field gets an inline fast path for its hinted type with a
    byte-identical `_encode` fallback on any runtime type mismatch —
    tests/test_utils.py fuzzes every registered struct against the generic
    path to hold that equivalence."""

    __slots__ = ("cls", "header", "names", "enc", "dec", "dec_raw",
                 "_coercers", "_hint_err")

    def __init__(self, cls: type):
        self.cls = cls
        fs = fields(cls)
        nb = cls.__name__.encode()
        self.header = (bytes([T_STRUCT]) + _varint(len(nb)) + nb
                       + _varint(len(fs)))
        self.names = tuple(f.name for f in fs)
        # hint resolution may fail (e.g. TYPE_CHECKING-only imports);
        # encode doesn't need hints, so defer the failure to the DECODE
        # boundary where the old reflective path raised it loudly
        self._coercers: tuple | None = None
        self._hint_err: Exception | None = None
        hints: dict = {}
        try:
            hints = typing.get_type_hints(cls)
        except Exception as e:
            self._hint_err = e
        else:
            self._coercers = tuple(_compile_coercer(hints.get(n))
                                   for n in self.names)
        try:
            self.enc = _compile_encoder(self, hints)
        except Exception:          # codegen must never break encoding
            self.enc = self._generic_enc
        try:
            if self._coercers is None:
                raise ValueError("hints unresolved")
            self.dec_raw = _compile_decoder_raw(self, hints)
            self.dec = _make_dec_shim(self.dec_raw)
        except Exception:          # codegen must never break decoding
            self.dec_raw = self._generic_dec_raw
            self.dec = self._generic_dec

    def _generic_enc(self, w: bytearray, obj) -> None:
        w += self.header
        for name in self.names:
            _encode(w, getattr(obj, name))

    def _generic_dec(self, r: "_Reader"):
        return _decode_struct_body(r, self.cls, self)

    def _generic_dec_raw(self, buf: bytes, pos: int):
        r = _Reader(buf)
        r.pos = pos
        return _decode_struct_body(r, self.cls, self), r.pos

    @property
    def coercers(self) -> tuple:
        if self._coercers is None:
            raise ValueError(
                f"serde: cannot resolve type hints of "
                f"{self.cls.__name__}: {self._hint_err}") from self._hint_err
        return self._coercers


def _unwrap_optional(hint):
    """Optional[T] -> (T, True); otherwise (hint, False)."""
    origin = typing.get_origin(hint)
    if origin is typing.Union or origin is types.UnionType:
        args = [a for a in typing.get_args(hint) if a is not type(None)]
        if len(args) == 1:
            return args[0], True
    return hint, False


def _emit_varint(lines, ind, v):
    lines += [f"{ind}while True:",
              f"{ind}    _b = {v} & 0x7F",
              f"{ind}    {v} >>= 7",
              f"{ind}    if {v}:",
              f"{ind}        w.append(_b | 0x80)",
              f"{ind}    else:",
              f"{ind}        w.append(_b)",
              f"{ind}        break"]


def _emit_value(lines, ns, ind, v, hint, depth):
    """Emit encoding code for one value `v` of hinted type: an inline fast
    path where a specialization exists, a generic `_encode(w, v)` call
    otherwise — and ALWAYS a generic fallback branch on runtime type
    mismatch, so output is byte-identical to the reflective path."""
    hint, optional = _unwrap_optional(hint)
    if optional:
        lines.append(f"{ind}if {v} is None:")
        lines.append(f"{ind}    w += _B_NONE")
        lines.append(f"{ind}else:")
        ind += "    "
    if isinstance(hint, type) and issubclass(hint, enum.Enum):
        en = f"_E{len(ns)}"
        ns[en] = hint
        lines.append(f"{ind}if isinstance({v}, {en}):")
        lines.append(f"{ind}    {v} = {v}.value")
        hint = int if issubclass(hint, int) else (
            str if issubclass(hint, str) else None)
        if hint is None:
            lines.append(f"{ind}_encode(w, {v})")
            return True
    if hint is bool:
        lines += [f"{ind}if {v} is True:",
                  f"{ind}    w += _B_TRUE",
                  f"{ind}elif {v} is False:",
                  f"{ind}    w += _B_FALSE",
                  f"{ind}else:",
                  f"{ind}    _encode(w, {v})"]
        return True
    if hint is int:
        lines += [f"{ind}if type({v}) is int:",
                  f"{ind}    if {v} >= 0:",
                  f"{ind}        w.append({T_INT})"]
        _emit_varint(lines, ind + "        ", v)
        lines += [f"{ind}    else:",
                  f"{ind}        w.append({T_NEGINT})",
                  f"{ind}        {v} = -{v} - 1"]
        _emit_varint(lines, ind + "        ", v)
        lines += [f"{ind}else:",
                  f"{ind}    _encode(w, {v})"]
        return True
    if hint is float:
        lines += [f"{ind}if type({v}) is float:",
                  f"{ind}    w.append({T_FLOAT})",
                  f"{ind}    w += _pack_d({v})",
                  f"{ind}else:",
                  f"{ind}    _encode(w, {v})"]
        return True
    if hint is str:
        lines += [f"{ind}if type({v}) is str:",
                  f"{ind}    _sb = {v}.encode('utf-8')",
                  f"{ind}    w.append({T_STR})",
                  f"{ind}    w += _varint(len(_sb))",
                  f"{ind}    w += _sb",
                  f"{ind}else:",
                  f"{ind}    _encode(w, {v})"]
        return True
    if hint is bytes:
        lines += [f"{ind}if type({v}) is bytes:",
                  f"{ind}    w.append({T_BYTES})",
                  f"{ind}    w += _varint(len({v}))",
                  f"{ind}    w += {v}",
                  f"{ind}else:",
                  f"{ind}    _encode(w, {v})"]
        return True
    origin = typing.get_origin(hint)
    if origin in (list, tuple) and depth < 2:
        args = typing.get_args(hint)
        elem_hint = args[0] if args else None
        x = f"_x{depth}_{len(ns)}"
        lines.append(f"{ind}if type({v}) is list or type({v}) is tuple:")
        lines.append(f"{ind}    w.append({T_LIST})")
        lines.append(f"{ind}    _n = len({v})")
        _emit_varint(lines, ind + "    ", "_n")
        lines.append(f"{ind}    for {x} in {v}:")
        if elem_hint is None:
            lines.append(f"{ind}        _encode(w, {x})")
        else:
            _emit_value(lines, ns, ind + "        ", x, elem_hint, depth + 1)
        lines.append(f"{ind}else:")
        lines.append(f"{ind}    _encode(w, {v})")
        return True
    if isinstance(hint, type) and is_dataclass(hint) \
            and _registry.get(hint.__name__) is hint:
        cn = f"_C{len(ns)}"
        ns[cn] = hint
        lines += [f"{ind}if type({v}) is {cn}:",
                  f"{ind}    _plan_of({cn}).enc(w, {v})",
                  f"{ind}else:",
                  f"{ind}    _encode(w, {v})"]
        return True
    lines.append(f"{ind}_encode(w, {v})")
    return True


def _struct_by_name(r: "_Reader", name_b: bytes):
    cls = _registry.get(name_b.decode())
    if cls is None:
        raise ValueError(f"serde: unknown struct {name_b!r}")
    return _plan_of(cls).dec(r)


def _compile_encoder(plan: "_Plan", hints: dict):
    """exec-generate enc(w, obj) for one registered dataclass."""
    ns: dict = {"_encode": _encode, "_varint": _varint, "_pack_d": _pack_d,
                "_B_NONE": _B_NONE, "_B_TRUE": _B_TRUE, "_B_FALSE": _B_FALSE,
                "_plan_of": _plan_of, "_HDR": plan.header}
    lines = ["def enc(w, obj):", "    w += _HDR"]
    for i, name in enumerate(plan.names):
        v = f"v{i}"
        lines.append(f"    {v} = obj.{name}")
        _emit_value(lines, ns, "    ", v, hints.get(name), 0)
    exec("\n".join(lines), ns)          # noqa: S102 (trusted codegen)
    return ns["enc"]


def _fallback_read(buf: bytes, pos: int, tag: int):
    """Raw-decoder escape hatch: decode one tag-consumed value via the
    generic reader path; returns (value, new_pos)."""
    r = _Reader(buf)
    r.pos = pos
    v = _decode_with_tag(r, tag)
    return v, r.pos


def _emit_varint_read(lines, ind, v):
    """Inline little-endian-base-128 read of `v` from (buf, pos)."""
    lines += [f"{ind}_b = buf[pos]; pos += 1",
              f"{ind}if _b < 128:",
              f"{ind}    {v} = _b",
              f"{ind}else:",
              f"{ind}    {v} = _b & 0x7F",
              f"{ind}    _s = 7",
              f"{ind}    while True:",
              f"{ind}        _b = buf[pos]; pos += 1",
              f"{ind}        {v} |= (_b & 0x7F) << _s",
              f"{ind}        if _b < 128:",
              f"{ind}            break",
              f"{ind}        _s += 7"]


def _emit_read_raw(lines, ns, ind, v, hint):
    """Raw-buffer twin of _emit_read: straight-line reads over local
    (buf, pos) with zero per-field method calls on the fast paths.
    Single-byte reads bounds-check via IndexError (the dec shim converts
    it); slice reads check against _blen explicitly (slices never
    raise).  Any tag mismatch falls back to the generic reader path —
    outcome-identical to the reflective decoder."""
    hint, optional = _unwrap_optional(hint)
    lines.append(f"{ind}_t = buf[pos]; pos += 1")
    if optional:
        lines.append(f"{ind}if _t == {T_NONE}:")
        lines.append(f"{ind}    {v} = None")
        lines.append(f"{ind}else:")
        ind += "    "
    enum_name = None
    enum_map = None
    if isinstance(hint, type) and issubclass(hint, enum.Enum):
        enum_name = f"_E{len(ns)}"
        enum_map = f"_EM{len(ns)}"
        ns[enum_name] = hint
        # value->member dict lookup beats Enum.__call__ ~10x; __call__
        # stays the fallback for aliases/unknowns so behavior matches
        ns[enum_map] = dict(hint._value2member_map_)
        hint = int if issubclass(hint, int) else (
            str if issubclass(hint, str) else None)
        if hint is None:
            lines.append(f"{ind}{v}, pos = _FB(buf, pos, _t)")
            lines.append(f"{ind}if {v} is not None "
                         f"and not isinstance({v}, {enum_name}):")
            lines.append(f"{ind}    _m = {enum_map}.get({v})")
            lines.append(f"{ind}    {v} = _m if _m is not None "
                         f"else {enum_name}({v})")
            return
    if hint is bool:
        lines += [f"{ind}if _t == {T_TRUE}:",
                  f"{ind}    {v} = True",
                  f"{ind}elif _t == {T_FALSE}:",
                  f"{ind}    {v} = False",
                  f"{ind}else:",
                  f"{ind}    {v}, pos = _FB(buf, pos, _t)"]
    elif hint is int:
        lines.append(f"{ind}if _t == {T_INT}:")
        _emit_varint_read(lines, ind + "    ", v)
        lines.append(f"{ind}elif _t == {T_NEGINT}:")
        _emit_varint_read(lines, ind + "    ", v)
        lines.append(f"{ind}    {v} = -{v} - 1")
        lines.append(f"{ind}else:")
        lines.append(f"{ind}    {v}, pos = _FB(buf, pos, _t)")
    elif hint is float:
        lines += [f"{ind}if _t == {T_FLOAT}:",
                  f"{ind}    if pos + 8 > _blen:",
                  f"{ind}        raise ValueError('serde: truncated input')",
                  f"{ind}    {v} = _unpack_d(buf, pos)[0]",
                  f"{ind}    pos += 8",
                  f"{ind}else:",
                  f"{ind}    {v}, pos = _FB(buf, pos, _t)"]
    elif hint is str or hint is bytes:
        tagc = T_STR if hint is str else T_BYTES
        suffix = ".decode('utf-8')" if hint is str else ""
        lines.append(f"{ind}if _t == {tagc}:")
        _emit_varint_read(lines, ind + "    ", "_l")
        lines += [f"{ind}    if pos + _l > _blen:",
                  f"{ind}        raise ValueError('serde: truncated input')",
                  f"{ind}    {v} = buf[pos:pos + _l]{suffix}",
                  f"{ind}    pos += _l",
                  f"{ind}else:",
                  f"{ind}    {v}, pos = _FB(buf, pos, _t)"]
    elif isinstance(hint, type) and is_dataclass(hint) \
            and _registry.get(hint.__name__) is hint:
        cn = f"_C{len(ns)}"
        nb = f"_N{len(ns)}"
        nl = f"_L{len(ns)}"
        ns[cn] = hint
        # expected-name compare via one slice: the wire is
        # tag + varint(len) + name, and registered names are < 128 chars
        # so the varint is one byte — compare varint+name wholesale; any
        # other struct (or a pathological long name) takes the generic
        # fallback, which re-reads the name correctly
        hb = _varint(len(hint.__name__.encode())) + hint.__name__.encode()
        ns[nb] = hb
        ns[nl] = len(hb)
        lines += [f"{ind}if _t == {T_STRUCT} "
                  f"and buf[pos:pos + {nl}] == {nb}:",
                  f"{ind}    {v}, pos = _plan_of({cn}).dec_raw("
                  f"buf, pos + {nl})",
                  f"{ind}else:",
                  f"{ind}    {v}, pos = _FB(buf, pos, _t)"]
    elif (typing.get_origin(hint) is list and typing.get_args(hint)
          and (lambda e: isinstance(e[0], type) and is_dataclass(e[0])
               and _registry.get(e[0].__name__) is e[0])(
              _unwrap_optional(typing.get_args(hint)[0]))):
        ecls, eopt = _unwrap_optional(typing.get_args(hint)[0])
        cn = f"_C{len(ns)}"
        nb = f"_N{len(ns)}"
        nl = f"_L{len(ns)}"
        ns[cn] = ecls
        hb = _varint(len(ecls.__name__.encode())) + ecls.__name__.encode()
        ns[nb] = hb
        ns[nl] = len(hb)
        none_arm = ([f"{ind}        elif _et == {T_NONE}:",
                     f"{ind}            _ap(None)"] if eopt else [])
        lines += [f"{ind}if _t == {T_LIST}:"]
        _emit_varint_read(lines, ind + "    ", "_n")
        lines += [f"{ind}    {v} = []",
                  f"{ind}    _ap = {v}.append",
                  f"{ind}    _dr = _plan_of({cn}).dec_raw",
                  f"{ind}    for _ in range(_n):",
                  f"{ind}        _et = buf[pos]; pos += 1",
                  f"{ind}        if _et == {T_STRUCT} "
                  f"and buf[pos:pos + {nl}] == {nb}:",
                  f"{ind}            _o, pos = _dr(buf, pos + {nl})",
                  f"{ind}            _ap(_o)",
                  *none_arm,
                  f"{ind}        else:",
                  f"{ind}            _o, pos = _FB(buf, pos, _et)",
                  f"{ind}            _ap(_o)",
                  f"{ind}else:",
                  f"{ind}    {v}, pos = _FB(buf, pos, _t)"]
    elif typing.get_origin(hint) is list and typing.get_args(hint) \
            and typing.get_args(hint)[0] in (int, str, bytes):
        elem = typing.get_args(hint)[0]
        lines += [f"{ind}if _t == {T_LIST}:"]
        _emit_varint_read(lines, ind + "    ", "_n")
        lines += [f"{ind}    {v} = []",
                  f"{ind}    _ap = {v}.append",
                  f"{ind}    for _ in range(_n):",
                  f"{ind}        _et = buf[pos]; pos += 1"]
        ind2 = ind + "        "
        if elem is int:
            lines.append(f"{ind2}if _et == {T_INT}:")
            _emit_varint_read(lines, ind2 + "    ", "_e")
            lines.append(f"{ind2}    _ap(_e)")
            lines.append(f"{ind2}elif _et == {T_NEGINT}:")
            _emit_varint_read(lines, ind2 + "    ", "_e")
            lines.append(f"{ind2}    _ap(-_e - 1)")
        else:
            tagc = T_STR if elem is str else T_BYTES
            suffix = ".decode('utf-8')" if elem is str else ""
            lines.append(f"{ind2}if _et == {tagc}:")
            _emit_varint_read(lines, ind2 + "    ", "_l")
            lines += [f"{ind2}    if pos + _l > _blen:",
                      f"{ind2}        raise ValueError("
                      f"'serde: truncated input')",
                      f"{ind2}    _ap(buf[pos:pos + _l]{suffix})",
                      f"{ind2}    pos += _l"]
        lines += [f"{ind2}else:",
                  f"{ind2}    _e, pos = _FB(buf, pos, _et)",
                  f"{ind2}    _ap(_e)",
                  f"{ind}else:",
                  f"{ind}    {v}, pos = _FB(buf, pos, _t)"]
    else:
        lines.append(f"{ind}{v}, pos = _FB(buf, pos, _t)")
        coercer = _compile_coercer(hint)
        if coercer is not None:
            cc = f"_c{len(ns)}"
            ns[cc] = coercer
            lines.append(f"{ind}{v} = {cc}({v})")
        return
    if enum_name is not None:
        lines.append(f"{ind}if {v} is not None "
                     f"and not isinstance({v}, {enum_name}):")
        lines.append(f"{ind}    _m = {enum_map}.get({v})")
        lines.append(f"{ind}    {v} = _m if _m is not None "
                     f"else {enum_name}({v})")


def _compile_decoder_raw(plan: "_Plan", hints: dict):
    """exec-generate dec_raw(buf, pos) -> (obj, pos): the compiled
    decoder over raw buffer offsets.  The reader-object variant paid ~3
    bound-method calls per field (tag/varint/exact); this emits the
    byte reads inline — the difference is ~4x on decode-heavy paths
    (readdir_plus: 128 inodes/listing), which dominated the FUSE
    listing profile."""
    ns: dict = {"_decode_struct_body": _decode_struct_body,
                "_unpack_d": _unpack_d, "_plan_of": _plan_of,
                "_FB": _fallback_read, "_Reader": _Reader,
                "_CLS": plan.cls, "_PLAN": plan}
    n = len(plan.names)
    lines = ["def dec_raw(buf, pos):",
             "    _blen = len(buf)"]
    _emit_varint_read(lines, "    ", "_nf")
    lines += ["    if _nf != %d:" % n,
              "        _r = _Reader(buf)",
              "        _r.pos = pos",
              "        _o = _decode_struct_body(_r, _CLS, _PLAN, _nf)",
              "        return _o, _r.pos"]
    for i, name in enumerate(plan.names):
        _emit_read_raw(lines, ns, "    ", f"v{i}", hints.get(name))
    args = ", ".join(f"v{i}" for i in range(n))
    lines.append(f"    return _CLS({args}), pos")
    exec("\n".join(lines), ns)          # noqa: S102 (trusted codegen)
    return ns["dec_raw"]


def _make_dec_shim(dec_raw):
    """Reader-interface wrapper over a raw decoder (IndexError from a
    single-byte read past the end becomes the reader's ValueError)."""
    def dec(r):
        try:
            obj, r.pos = dec_raw(r.buf, r.pos)
        except IndexError:
            raise ValueError("serde: truncated input") from None
        return obj
    return dec


def _plan_of(cls: type) -> _Plan:
    plan = _plan_cache.get(cls)
    if plan is None:
        plan = _plan_cache[cls] = _Plan(cls)
    return plan


def _compile_coercer(hint):
    """hint -> None (identity) or a fn(value) -> coerced value, mirroring the
    best-effort semantics: unexpected runtime types pass through unchanged."""
    if hint is None:
        return None
    origin = typing.get_origin(hint)
    if origin is typing.Union or origin is types.UnionType:
        args = [a for a in typing.get_args(hint) if a is not type(None)]
        if len(args) != 1:
            return None
        inner = _compile_coercer(args[0])
        if inner is None:
            return None
        return lambda v: v if v is None else inner(v)
    if isinstance(hint, type) and issubclass(hint, enum.Enum):
        return lambda v: v if v is None or isinstance(v, hint) else hint(v)
    if origin in (list, tuple):
        args = typing.get_args(hint)
        elem = _compile_coercer(args[0]) if args else None
        if origin is tuple:
            if elem is None:
                return lambda v: tuple(v) if isinstance(v, list) else v
            return lambda v: (tuple(elem(x) for x in v)
                              if isinstance(v, list) else v)
        if elem is None:
            return None
        return lambda v: ([elem(x) for x in v]
                          if isinstance(v, list) else v)
    if origin is dict:
        kt, vt = (typing.get_args(hint) + (None, None))[:2]
        kc, vc = _compile_coercer(kt), _compile_coercer(vt)
        if kc is None and vc is None:
            return None
        kc = kc or (lambda x: x)
        vc = vc or (lambda x: x)
        return lambda v: ({kc(k): vc(x) for k, x in v.items()}
                          if isinstance(v, dict) else v)
    return None


def _encode(w: bytearray, obj) -> None:
    if obj is None:
        w += _B_NONE
    elif obj is False:
        w += _B_FALSE
    elif obj is True:
        w += _B_TRUE
    elif isinstance(obj, enum.Enum):
        _encode(w, obj.value)
    elif isinstance(obj, int):
        if obj >= 0:
            w.append(T_INT)
            while True:
                b = obj & 0x7F
                obj >>= 7
                if obj:
                    w.append(b | 0x80)
                else:
                    w.append(b)
                    break
        else:
            w.append(T_NEGINT)
            obj = -obj - 1
            while True:
                b = obj & 0x7F
                obj >>= 7
                if obj:
                    w.append(b | 0x80)
                else:
                    w.append(b)
                    break
    elif isinstance(obj, float):
        w.append(T_FLOAT)
        w += _pack_d(obj)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        b = bytes(obj)
        w.append(T_BYTES)
        w += _varint(len(b))
        w += b
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        w.append(T_STR)
        w += _varint(len(b))
        w += b
    elif isinstance(obj, (list, tuple)):
        w.append(T_LIST)
        w += _varint(len(obj))
        for x in obj:
            _encode(w, x)
    elif isinstance(obj, dict):
        w.append(T_MAP)
        w += _varint(len(obj))
        for k, v in obj.items():
            _encode(w, k)
            _encode(w, v)
    elif is_dataclass(obj):
        cls = type(obj)
        if _registry.get(cls.__name__) is None:
            raise TypeError(
                f"serde: {cls.__name__} not registered (@serde_struct)")
        _plan_of(cls).enc(w, obj)
    else:
        raise TypeError(f"serde: cannot encode {type(obj)}")


class _Reader:
    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def varint(self) -> int:
        buf, pos = self.buf, self.pos
        out = 0
        shift = 0
        try:
            while True:
                b = buf[pos]
                pos += 1
                out |= (b & 0x7F) << shift
                if not (b & 0x80):
                    self.pos = pos
                    return out
                shift += 7
        except IndexError:
            raise ValueError("serde: truncated varint") from None

    def tag(self) -> int:
        pos = self.pos
        if pos >= len(self.buf):
            raise ValueError("serde: truncated input")
        self.pos = pos + 1
        return self.buf[pos]

    def exact(self, n: int) -> bytes:
        b = self.buf[self.pos:self.pos + n]
        if len(b) != n:
            raise ValueError(
                f"serde: truncated input (wanted {n}, got {len(b)})")
        self.pos += n
        return b


def _decode_struct_body(r: _Reader, cls, plan, nfields=None) -> object:
    """Generic field loop for a struct whose header+name are consumed.
    Forward/backward compat: extra fields dropped, missing use defaults.
    Positional construction (fields in declaration order) skips a kwargs
    dict per struct."""
    if nfields is None:
        nfields = r.varint()
    coercers = plan.coercers
    nown = len(coercers)
    args = []
    for i in range(nfields):
        v = _decode(r)
        if i < nown:
            c = coercers[i]
            args.append(v if c is None else c(v))
    return cls(*args)


def _decode(r: _Reader):
    buf, pos = r.buf, r.pos
    if pos >= len(buf):
        raise ValueError("serde: truncated input")
    tag = buf[pos]
    r.pos = pos + 1
    return _decode_with_tag(r, tag)


def _decode_with_tag(r: _Reader, tag: int):
    if tag == T_INT:
        return r.varint()
    if tag == T_STRUCT:
        return _struct_by_name(r, r.exact(r.varint()))
    if tag == T_BYTES:
        return r.exact(r.varint())
    if tag == T_STR:
        return r.exact(r.varint()).decode("utf-8")
    if tag == T_LIST:
        return [_decode(r) for _ in range(r.varint())]
    if tag == T_NONE:
        return None
    if tag == T_FALSE:
        return False
    if tag == T_TRUE:
        return True
    if tag == T_NEGINT:
        return -r.varint() - 1
    if tag == T_FLOAT:
        return _unpack_d(r.exact(8))[0]
    if tag == T_MAP:
        return {_decode(r): _decode(r) for _ in range(r.varint())}
    raise ValueError(f"serde: bad tag {tag}")


def dumps(obj) -> bytes:
    w = bytearray()
    _encode(w, obj)
    return bytes(w)


def loads(data: bytes | memoryview):
    return _decode(_Reader(bytes(data)))


def loads_many(blobs: list, cls: type) -> list:
    """Decode many same-typed struct blobs with the dispatch hoisted:
    one plan lookup + one expected-header compare per element instead of
    the generic tag walk + registry lookup.  Empty/None blobs decode to
    None (the batched-read convention for raced-away rows).  A blob
    whose header isn't `cls` falls back to the generic decoder —
    outcome-identical to [loads(b) for b in blobs]."""
    plan = _plan_of(cls)
    name_b = cls.__name__.encode()
    hdr = bytes([T_STRUCT]) + _varint(len(name_b)) + name_b
    hlen = len(hdr)
    out = []
    dec_raw = plan.dec_raw
    ap = out.append
    try:
        for b in blobs:
            if not b:
                ap(None)
                continue
            if type(b) is not bytes:
                b = bytes(b)
            if b.startswith(hdr):
                ap(dec_raw(b, hlen)[0])
            else:
                ap(loads(b))
    except IndexError:
        raise ValueError("serde: truncated input") from None
    return out



