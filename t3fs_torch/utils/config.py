"""Declarative config with TOML load, validation, and hot update.

Mirrors the reference's ConfigBase reflection macros (CONFIG_ITEM /
CONFIG_HOT_UPDATED_ITEM / CONFIG_OBJ, common/utils/ConfigBase.h:44-116):
configs are dataclasses whose fields carry `hot` and `validator` metadata;
`update()` applies a dict of dotted-key overrides, enforcing hot-update
rules, and returns what changed so services can react (onConfigUpdated).
"""

from __future__ import annotations

try:
    import tomllib
except ImportError:  # Python < 3.11: the API-compatible backport
    import tomli as tomllib  # type: ignore[no-redef]
from dataclasses import dataclass, field, fields, is_dataclass
from typing import Any, Callable


def citem(default: Any = None, *, hot: bool = True,
          validator: Callable[[Any], bool] | None = None,
          factory: Callable[[], Any] | None = None):
    """Declare a config item (CONFIG_ITEM / CONFIG_HOT_UPDATED_ITEM analog)."""
    meta = {"hot": hot, "validator": validator}
    if factory is not None:
        return field(default_factory=factory, metadata=meta)
    return field(default=default, metadata=meta)


def cchoice(*options: str) -> Callable[[Any], bool]:
    """Validator factory for enumerated string items: accepts exactly the
    given options.  The option list rides on the validator (`.options`) so
    error messages and docs can render it."""
    allowed = frozenset(options)

    def check(v: Any) -> bool:
        return isinstance(v, str) and v in allowed
    check.options = tuple(options)  # type: ignore[attr-defined]
    return check


def cobj(cls: type, **overrides):
    """Declare a nested config object (CONFIG_OBJ analog)."""
    if overrides:
        return field(default_factory=lambda: cls(**overrides), metadata={"hot": True})
    return field(default_factory=cls, metadata={"hot": True})


class ConfigError(ValueError):
    pass


@dataclass
class ConfigBase:
    """Base for all config dataclasses."""

    @classmethod
    def from_dict(cls, d: dict) -> "ConfigBase":
        kwargs = {}
        known = {f.name: f for f in fields(cls)}
        for key, val in d.items():
            if key not in known:
                raise ConfigError(f"{cls.__name__}: unknown config key {key!r}")
            ftype = known[key].type
            sub = _resolve_nested(cls, key)
            if sub is not None and isinstance(val, dict):
                kwargs[key] = sub.from_dict(val)
            else:
                kwargs[key] = val
        cfg = cls(**kwargs)
        cfg.validate()
        return cfg

    @classmethod
    def from_toml(cls, text_or_path: str) -> "ConfigBase":
        if "\n" not in text_or_path and text_or_path.endswith(".toml"):
            with open(text_or_path, "rb") as f:
                d = tomllib.load(f)
        else:
            d = tomllib.loads(text_or_path)
        return cls.from_dict(d)

    def to_dict(self) -> dict:
        out = {}
        for f in fields(self):
            v = getattr(self, f.name)
            out[f.name] = v.to_dict() if isinstance(v, ConfigBase) else v
        return out

    def validate(self) -> None:
        for f in fields(self):
            v = getattr(self, f.name)
            if isinstance(v, ConfigBase):
                v.validate()
                continue
            validator = f.metadata.get("validator") if f.metadata else None
            if validator is not None and not validator(v):
                raise ConfigError(f"{type(self).__name__}.{f.name}: invalid value {v!r}")

    def update(self, overrides: dict, *, hot_only: bool = True) -> list[str]:
        """Apply {dotted.key: value} or nested-dict overrides atomically:
        every override is validated first, then all are applied — a rejected
        key leaves the config untouched.  With hot_only, refuses items
        declared hot=False (reference semantics: non-hot items need a
        restart).  Returns dotted names that changed."""
        # normalize dotted keys into nested dicts
        nested: dict = {}
        for k, v in overrides.items():
            parts = k.split(".")
            cur = nested
            for p in parts[:-1]:
                cur = cur.setdefault(p, {})
            if isinstance(v, dict) and isinstance(cur.get(parts[-1]), dict):
                cur[parts[-1]].update(v)
            else:
                cur[parts[-1]] = v
        plan: list[tuple[ConfigBase, str, object, str]] = []
        self._plan_update(nested, hot_only, "", plan)   # validates everything
        for obj, key, val, _ in plan:
            setattr(obj, key, val)
        return [dotted for _, _, _, dotted in plan]

    def _plan_update(self, nested: dict, hot_only: bool, prefix: str,
                     plan: list) -> None:
        known = {f.name: f for f in fields(self)}
        for key, val in nested.items():
            if key not in known:
                raise ConfigError(f"{type(self).__name__}: unknown config key {key!r}")
            f = known[key]
            cur = getattr(self, key)
            dotted = f"{prefix}{key}"
            if isinstance(cur, ConfigBase):
                if not isinstance(val, dict):
                    raise ConfigError(f"{dotted}: expected table, got {val!r}")
                cur._plan_update(val, hot_only, dotted + ".", plan)
                continue
            if cur == val:
                continue
            if hot_only and not (f.metadata or {}).get("hot", True):
                raise ConfigError(f"{dotted}: not hot-updatable (requires restart)")
            validator = (f.metadata or {}).get("validator")
            if validator is not None:
                try:
                    ok = bool(validator(val))
                except Exception as e:  # e.g. TypeError from 'str' > 0
                    raise ConfigError(f"{dotted}: invalid value {val!r} ({e})") from None
                if not ok:
                    raise ConfigError(f"{dotted}: invalid value {val!r}")
            plan.append((self, key, val, dotted))


def _resolve_nested(cls: type, key: str) -> type | None:
    """Return the nested ConfigBase subclass type for field `key`, if any."""
    import typing
    hints = typing.get_type_hints(cls)
    t = hints.get(key)
    if isinstance(t, type) and is_dataclass(t) and issubclass(t, ConfigBase):
        return t
    return None


def _toml_value(v: Any) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (int, float)):
        return repr(v)
    if isinstance(v, str):
        out = []
        for ch in v:
            if ch == "\\":
                out.append("\\\\")
            elif ch == '"':
                out.append('\\"')
            elif ch == "\n":
                out.append("\\n")
            elif ch == "\r":
                out.append("\\r")
            elif ch == "\t":
                out.append("\\t")
            elif ord(ch) < 0x20 or ch == "\x7f":
                out.append(f"\\u{ord(ch):04X}")
            else:
                out.append(ch)
        return '"' + "".join(out) + '"'
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_toml_value(x) for x in v) + "]"
    raise ConfigError(f"cannot render {type(v).__name__} as TOML value")


def to_toml(d: dict, _prefix: str = "") -> str:
    """Render a (possibly nested) dict as TOML text — the config-introspection
    wire format (reference: RenderConfig templating, common/utils/RenderConfig.h).
    Round-trips through tomllib for everything ConfigBase.to_dict produces."""
    scalars, tables = [], []
    for k, v in d.items():
        if isinstance(v, dict):
            tables.append((k, v))
        elif v is None:
            continue  # TOML has no null; absent key means default
        else:
            scalars.append(f"{k} = {_toml_value(v)}")
    out = []
    if scalars:
        out.append("\n".join(scalars))
    for k, v in tables:
        name = f"{_prefix}{k}"
        body = to_toml(v, name + ".")
        out.append(f"[{name}]" + ("\n" + body if body else ""))
    return "\n\n".join(out).strip() + ("\n" if out else "")
