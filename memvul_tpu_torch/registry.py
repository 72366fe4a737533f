"""A small Registrable/FromParams-style component registry (the JAX
package's ``registry.py``, carried over as it is: plain Python).

The reference framework wires every component through AllenNLP's registry:
``@Model.register("model_memory")`` etc., constructed from JSON configs by
``"type"`` key (reference: MemVul/model_memory.py:39, reader_memory.py:35,
custom_trainer.py:38).  This module provides the same ergonomics without
AllenNLP: any class deriving from :class:`Registrable` gains ``register``,
``by_name`` and ``from_config``; ``from_config`` recursively constructs
nested registrable components found in the config dict by inspecting the
constructor's type annotations.  The port registers its tokenizers
(``TextTokenizer``: "wordpiece", "word") and readers (``DatasetReader``:
"reader_memory", "reader_single"), so a bad config raises the JAX
package's errors: :class:`RegistryError` for an unknown ``type``, a
``TypeError`` naming unexpected or missing keys.
"""

from __future__ import annotations

import inspect
import types
import typing
from typing import Any, Callable, Dict, Optional, Type, TypeVar

T = TypeVar("T", bound="Registrable")


class RegistryError(KeyError):
    pass


class Registrable:
    """Base class giving subclasses a per-hierarchy name registry.

    The registry is keyed by the *base* class (the direct subclass of
    ``Registrable``), so e.g. readers and models live in separate
    namespaces even if they share a type name.
    """

    _registry: Dict[type, Dict[str, type]] = {}
    default_implementation: Optional[str] = None

    @classmethod
    def _base(cls) -> type:
        # walk up to the class directly under Registrable
        for klass in cls.__mro__:
            if Registrable in klass.__bases__:
                return klass
        return cls

    @classmethod
    def register(cls, name: str, exist_ok: bool = False) -> Callable[[Type[T]], Type[T]]:
        base = cls._base() if cls is not Registrable else cls

        def decorator(subclass: Type[T]) -> Type[T]:
            space = Registrable._registry.setdefault(base, {})
            if name in space and not exist_ok and space[name] is not subclass:
                raise RegistryError(
                    f"{name!r} already registered for {base.__name__} "
                    f"as {space[name].__name__}"
                )
            space[name] = subclass
            subclass.registered_name = name
            return subclass

        return decorator

    @classmethod
    def by_name(cls, name: str) -> type:
        base = cls._base() if cls is not Registrable else cls
        space = Registrable._registry.get(base, {})
        if name not in space:
            known = sorted(space)
            raise RegistryError(
                f"{name!r} is not a registered {base.__name__}; known: {known}"
            )
        return space[name]

    @classmethod
    def list_available(cls) -> list:
        base = cls._base() if cls is not Registrable else cls
        return sorted(Registrable._registry.get(base, {}))

    @classmethod
    def from_config(cls: Type[T], config: Any, **extras: Any) -> T:
        """Construct a component from a config dict.

        ``config`` may be an instance (returned as-is), or a dict with an
        optional ``"type"`` key selecting the registered subclass (falling
        back to ``default_implementation``).  Remaining keys become
        constructor kwargs; nested dicts whose parameter annotation is a
        Registrable subclass are constructed recursively.  ``extras`` are
        injected for matching parameter names not present in the config.
        """
        if isinstance(config, cls):
            return config
        if config is None:
            config = {}
        if not isinstance(config, dict):
            raise TypeError(f"cannot construct {cls.__name__} from {type(config)}")
        params = dict(config)
        type_name = params.pop("type", None) or cls.default_implementation
        subclass = cls.by_name(type_name) if type_name else cls
        return _construct(subclass, params, extras)


def _construct(subclass: type, params: Dict[str, Any], extras: Dict[str, Any]) -> Any:
    sig = inspect.signature(subclass.__init__)
    hints = typing.get_type_hints(subclass.__init__) if subclass.__init__ is not object.__init__ else {}
    kwargs: Dict[str, Any] = {}
    accepts_kwargs = any(
        p.kind is inspect.Parameter.VAR_KEYWORD for p in sig.parameters.values()
    )
    for pname, param in sig.parameters.items():
        if pname == "self" or param.kind in (
            inspect.Parameter.VAR_POSITIONAL,
            inspect.Parameter.VAR_KEYWORD,
        ):
            continue
        if pname in params:
            value = params.pop(pname)
            kwargs[pname] = _resolve(hints.get(pname), value, extras)
        elif pname in extras:
            kwargs[pname] = extras[pname]
        elif param.default is inspect.Parameter.empty:
            raise TypeError(
                f"{subclass.__name__} missing required config key {pname!r}"
            )
    if params:
        if accepts_kwargs:
            kwargs.update(params)
        else:
            raise TypeError(
                f"{subclass.__name__} got unexpected config keys {sorted(params)}"
            )
    return subclass(**kwargs)


def _resolve(annotation: Any, value: Any, extras: Dict[str, Any]) -> Any:
    """Recursively build registrable sub-components from nested dicts."""
    if annotation is None or value is None:
        return value
    origin = typing.get_origin(annotation)
    if origin in (typing.Union, types.UnionType):
        # prefer an arm that actually transforms the value (a Registrable
        # built from a dict); plain arms like int would pass it through raw
        arms = [a for a in typing.get_args(annotation) if a is not type(None)]
        for arg in arms:
            if (
                inspect.isclass(arg)
                and issubclass(arg, Registrable)
                and isinstance(value, dict)
            ):
                try:
                    return _resolve(arg, value, extras)
                except (TypeError, RegistryError):
                    continue
        for arg in arms:
            try:
                return _resolve(arg, value, extras)
            except (TypeError, RegistryError):
                continue
        return value
    if (
        inspect.isclass(annotation)
        and issubclass(annotation, Registrable)
        and isinstance(value, dict)
    ):
        return annotation.from_config(value, **extras)
    if origin in (list, tuple) and isinstance(value, (list, tuple)):
        args = typing.get_args(annotation)
        inner = args[0] if args else None
        return type(value)(_resolve(inner, v, extras) for v in value)
    if origin is dict and isinstance(value, dict):
        args = typing.get_args(annotation)
        inner = args[1] if len(args) == 2 else None
        return {k: _resolve(inner, v, extras) for k, v in value.items()}
    return value
