"""The parts of the spec layer that the lane schedulers need.

A copy of ``Registry``, ``_coerce``, ``_SpecBase``, ``TICK_SCHED_FIELDS``
and ``SchedulerSpec`` from ``repro.core.spec`` (the JAX package's module).
The scheduler registry's provider names this package's
``repro_torch.serving.schedulers``, so a lookup never imports the JAX
package.
"""
from __future__ import annotations

import dataclasses
import importlib

__all__ = ["Registry", "SCHEDULER_REGISTRY", "SchedulerSpec",
           "TICK_SCHED_FIELDS"]

# ---------------------------------------------------------------------------
# Registries
# ---------------------------------------------------------------------------


class Registry:
    """Name -> implementation class registry with decorator registration.

    ``provider`` is the module whose import populates the registry; it is
    imported lazily on first lookup, so specs can be parsed and compared
    without pulling any engine code.
    """

    def __init__(self, kind: str, provider: str):
        self.kind = kind
        self.provider = provider
        self._classes: dict = {}
        self._loaded = False

    def register(self, name: str):
        def deco(cls):
            prev = self._classes.get(name)
            if prev is not None and (prev.__module__, prev.__qualname__) \
                    != (cls.__module__, cls.__qualname__):
                raise ValueError(
                    f"duplicate {self.kind} registration: {name!r}")
            # same module+qualname == a provider re-import (reload, or a
            # retried import after a transient failure): last wins
            self._classes[name] = cls
            return cls
        return deco

    def _ensure(self):
        # gate on successful provider import, not on _classes being
        # non-empty — a partial (failed) import must be retried, not
        # frozen as "these are all the implementations"
        if not self._loaded:
            importlib.import_module(self.provider)
            self._loaded = True

    def names(self) -> tuple:
        self._ensure()
        return tuple(self._classes)

    def get(self, name: str):
        self._ensure()
        try:
            return self._classes[name]
        except KeyError:
            raise ValueError(f"unknown {self.kind} {name!r}; "
                             f"expected one of {tuple(self._classes)}") \
                from None

    def __contains__(self, name) -> bool:
        self._ensure()
        return name in self._classes

    def __iter__(self):
        self._ensure()
        return iter(self._classes)


SCHEDULER_REGISTRY = Registry("scheduler", "repro_torch.serving.schedulers")


# ---------------------------------------------------------------------------
# name:key=val spec grammar
# ---------------------------------------------------------------------------


def _coerce(v: str):
    """Parse one spec value: int, float, bool, None, else string."""
    s = str(v).strip()
    low = s.lower()
    if low == "true":
        return True
    if low == "false":
        return False
    if low == "null" or s == "None":
        return None
    for cast in (int, float):
        try:
            return cast(s)
        except ValueError:
            pass
    return s


class _SpecBase:
    """Shared behaviour of the ``name + args`` spec family.

    ``args`` is a canonically-sorted tuple of ``(key, value)`` pairs —
    hashable, order-independent, and alias-normalized at construction,
    so two specs that mean the same thing compare equal regardless of
    how they were written.
    """

    ALIASES: dict = {}

    def __post_init__(self):
        raw = self.args.items() if isinstance(self.args, dict) else self.args
        seen: dict = {}
        for k, v in raw:
            k = self.ALIASES.get(str(k), str(k))
            if not k or any(c in k for c in ":,= "):
                raise ValueError(f"spec arg key {k!r} contains grammar "
                                 "separators")
            # fail fast on values the unquoted grammar cannot carry —
            # non-scalars, separators, and strings that reparse as
            # another literal ("true", "5", ...) — keeping
            # parse(str(spec)) == spec an invariant, not a convention
            if not isinstance(v, (str, int, float, bool, type(None))):
                raise ValueError(f"spec arg {k}={v!r}: only scalar "
                                 "values survive the string grammar")
            if isinstance(v, str):
                if any(c in v for c in ":,="):
                    raise ValueError(f"spec arg {k}={v!r} contains "
                                     "grammar separators")
                if _coerce(v) != v:
                    raise ValueError(
                        f"spec arg {k}={v!r} would not round-trip "
                        f"through the string form (parses as "
                        f"{_coerce(v)!r})")
            seen[k] = v
        object.__setattr__(self, "args", tuple(sorted(seen.items())))

    @property
    def kwargs(self) -> dict:
        return dict(self.args)

    @classmethod
    def parse(cls, spec):
        """``"name"`` / ``"name:k=v,k=v"`` (or an instance) -> spec."""
        if isinstance(spec, cls):
            return spec
        if isinstance(spec, _SpecBase):
            raise TypeError(f"cannot parse {type(spec).__name__} "
                            f"as {cls.__name__}")
        name, _, argstr = str(spec).partition(":")
        args = []
        for part in argstr.split(",") if argstr else ():
            k, eq, v = part.partition("=")
            if not eq:
                raise ValueError(f"malformed spec arg {part!r} in {spec!r} "
                                 "(expected key=value)")
            args.append((k.strip(), _coerce(v)))
        return cls(name=name.strip(), args=tuple(args))

    def __str__(self) -> str:
        if not self.args:
            return self.name
        return self.name + ":" + ",".join(f"{k}={v}" for k, v in self.args)

    def with_args(self, **kw):
        """New spec with ``kw`` set (overriding existing keys)."""
        merged = self.kwargs
        merged.update(kw)
        return dataclasses.replace(self, args=tuple(merged.items()))

    def with_defaults(self, **kw):
        """New spec with ``kw`` filled in only where not already set."""
        have = self.kwargs
        merged = {self.ALIASES.get(k, k): v for k, v in kw.items()}
        merged.update(have)
        return dataclasses.replace(self, args=tuple(merged.items()))


# canonical scheduler knob -> tick-engine make_scheduler kwarg (ticks)
TICK_SCHED_FIELDS = {
    "slice": "slice_ticks",
    "slice_init": "slice_init",
    "adaptive_window": "adaptive_window",
    "overload_factor": "overload_factor",
    "stall_aware": "stall_aware",
    "hinted_demotion": "hinted_demotion",
}


@dataclasses.dataclass(frozen=True)
class SchedulerSpec(_SpecBase):
    """Per-server scheduling policy + knobs, engine-agnostic.

    Knob names are canonical (``slice``, ``slice_init``,
    ``adaptive_window``, ``overload_factor``, …);
    :func:`repro_torch.serving.schedulers.make_scheduler` maps them onto
    the tick engine's native field names through ``TICK_SCHED_FIELDS``.
    """

    name: str = "sfs"
    args: tuple = ()

    ALIASES = {"O": "overload_factor", "N": "adaptive_window",
               "window": "adaptive_window", "S": "slice",
               "init": "slice_init"}
