"""Name -> factory registries for every pluggable component of the port.

The port's copy of the JAX package's registry, with the same strict
semantics: an unknown name raises listing what is registered, an unknown
keyword raises listing what the factory accepts.  Components register with
the ``register_<kind>`` decorators and are built with :func:`make`::

    @register_compressor("qinf")
    @dataclasses.dataclass(frozen=True)
    class QInf(Compressor):
        ...

    registry.make("compressor", "qinf", bits=2)
"""
from __future__ import annotations

import dataclasses
import inspect
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

KINDS = ("compressor", "prox", "oracle", "topology", "schedule", "fault",
         "algorithm", "problem", "engine")

_REGISTRIES: Dict[str, Dict[str, "Registration"]] = {k: {} for k in KINDS}


@dataclasses.dataclass(frozen=True)
class Registration:
    kind: str
    name: str
    factory: Callable
    accepts: Tuple[str, ...]     # keyword names the factory can take
    var_kwargs: bool             # factory has **kwargs (accepts anything)


def _signature_of(factory: Callable) -> Tuple[Tuple[str, ...], bool]:
    try:
        sig = inspect.signature(factory)
    except (TypeError, ValueError):          # builtins without signatures
        return (), True
    accepts, var = [], False
    for p in sig.parameters.values():
        if p.kind in (inspect.Parameter.POSITIONAL_OR_KEYWORD,
                      inspect.Parameter.KEYWORD_ONLY):
            accepts.append(p.name)
        elif p.kind is inspect.Parameter.VAR_KEYWORD:
            var = True
    return tuple(accepts), var


def register(kind: str, name: Optional[str] = None):
    """Decorator: ``@register("compressor", "qinf")`` on a class or factory.

    Returns the decorated object unchanged, so it stacks with
    ``@dataclass``.  Re-registering a name overwrites (last wins)."""
    if kind not in _REGISTRIES:
        raise ValueError(f"unknown registry kind {kind!r}; have {KINDS}")

    def deco(factory):
        nm = name or getattr(factory, "name", None) or factory.__name__
        accepts, var = _signature_of(factory)
        _REGISTRIES[kind][nm] = Registration(kind, nm, factory, accepts, var)
        return factory

    return deco


def _reg_for(kind: str, name: str) -> Registration:
    if kind not in _REGISTRIES:
        raise ValueError(f"unknown registry kind {kind!r}; have {KINDS}")
    table = _REGISTRIES[kind]
    if name not in table:
        raise ValueError(f"unknown {kind} {name!r}; have {sorted(table)}")
    return table[name]


def make(kind: str, name: str, **kwargs) -> Any:
    """Build ``kind``/``name`` strictly: unknown names and unknown kwargs
    both raise with the list of valid options."""
    reg = _reg_for(kind, name)
    if not reg.var_kwargs:
        bad = sorted(set(kwargs) - set(reg.accepts))
        if bad:
            raise ValueError(
                f"{kind} {name!r} does not accept {bad}; "
                f"accepted keywords: {sorted(reg.accepts)}")
    return reg.factory(**kwargs)


def names(kind: str) -> Tuple[str, ...]:
    if kind not in _REGISTRIES:
        raise ValueError(f"unknown registry kind {kind!r}; have {KINDS}")
    return tuple(sorted(_REGISTRIES[kind]))


def accepts(kind: str, name: str) -> Tuple[str, ...]:
    """The keyword names the ``kind``/``name`` factory takes."""
    return _reg_for(kind, name).accepts


def kwargs_subset(kind: str, name: str,
                  candidates: Mapping[str, Any]) -> Dict[str, Any]:
    """The subset of ``candidates`` the factory accepts (unknown candidates
    are dropped, not rejected: the caller offers a superset on purpose)."""
    reg = _reg_for(kind, name)
    if reg.var_kwargs:
        return dict(candidates)
    return {k: v for k, v in candidates.items() if k in reg.accepts}


def _family(kind: str):
    def deco(name: Optional[str] = None):
        return register(kind, name)
    deco.__name__ = f"register_{kind}"
    deco.__doc__ = f"``@register_{kind}('name')`` -> register a {kind} factory."
    return deco


register_compressor = _family("compressor")
register_prox = _family("prox")
register_oracle = _family("oracle")
register_topology = _family("topology")
register_schedule = _family("schedule")
register_fault = _family("fault")
register_algorithm = _family("algorithm")
register_problem = _family("problem")
register_engine = _family("engine")
