"""YAML pipeline templates — ``pw.load_yaml`` (reference:
``internals/yaml_loader.py:74-214``).

Semantics matched from the reference:
- ``!module.path.obj`` tags resolve to python objects; a mapping node calls
  the object with the mapping as kwargs, an empty scalar node calls it with no
  arguments (or yields the object itself when it isn't callable).
- ``$name`` scalars are variables; top-level mapping keys of the form
  ``$name`` DEFINE them. References resolve lazily and each definition is
  instantiated at most once (shared instances). Undefined ALL-UPPERCASE
  variables fall back to the environment (their text parsed as YAML).
- Tags shortened to ``!pw.xxx`` resolve inside ``pathway_tpu_torch``.

Carried from ``pathway_tpu/internals/yaml_loader.py``. PyYAML is imported
when ``load_yaml`` is called, not when the package is: on a machine without
it the package imports and the call raises an ``ImportError`` naming PyYAML.
"""

from __future__ import annotations

import importlib
import os
from typing import Any, IO


class Variable:
    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __repr__(self) -> str:
        return f"${self.name}"

    def __hash__(self) -> int:
        return hash(("pw-yaml-var", self.name))

    def __eq__(self, other) -> bool:
        return isinstance(other, Variable) and other.name == self.name


class Value:
    """Deferred constructor call (``!tag`` node)."""

    __slots__ = ("constructor", "kwargs", "constructed", "value")

    def __init__(self, constructor=None, kwargs=None, constructed=False, value=None):
        self.constructor = constructor
        self.kwargs = kwargs or {}
        self.constructed = constructed
        self.value = value


def _import_object(tag: str) -> Any:
    path = tag.lstrip("!")
    if path.startswith("pw."):
        path = "pathway_tpu_torch." + path[3:]
    parts = path.split(".")
    for split in range(len(parts), 0, -1):
        module_name = ".".join(parts[:split])
        try:
            obj: Any = importlib.import_module(module_name)
        except ImportError:
            continue
        try:
            for attr in parts[split:]:
                obj = getattr(obj, attr)
        except AttributeError:
            break
        return obj
    raise ValueError(f"pw.load_yaml: cannot import {tag!r}")


def _yaml():
    try:
        import yaml
    except ImportError as e:
        raise ImportError(
            "pw.load_yaml needs PyYAML (the `yaml` module), which is not installed"
        ) from e
    return yaml


_LOADER: Any = None


def _loader() -> Any:
    """The template loader class, built on first use (it subclasses
    ``yaml.SafeLoader``)."""
    global _LOADER
    if _LOADER is not None:
        return _LOADER
    yaml = _yaml()

    class PathwayYamlLoader(yaml.SafeLoader):
        def construct_pathway_variable(self, node: yaml.Node) -> Variable:
            name = self.construct_yaml_str(node)
            if not name.startswith("$") or not name[1:].isidentifier():
                raise yaml.MarkedYAMLError(
                    problem=f"invalid variable name {name!r}",
                    problem_mark=node.start_mark,
                )
            return Variable(name[1:])

        def construct_pathway_value(self, tag: str, node: yaml.Node) -> Value:
            constructor = _import_object(tag)
            if isinstance(node, yaml.ScalarNode) and node.value == "":
                if callable(constructor):
                    return Value(constructor, {})
                return Value(constructed=True, value=constructor)
            if isinstance(node, yaml.MappingNode) and callable(constructor):
                return Value(constructor, self.construct_mapping(node, deep=True))
            raise yaml.MarkedYAMLError(
                problem=f"tag {tag!r} expects a mapping or an empty node"
                + ("" if callable(constructor) else f" ({tag!r} is not callable)"),
                problem_mark=node.start_mark,
            )

    PathwayYamlLoader.add_implicit_resolver("!pw-variable", __import__("re").compile(r"^\$"), "$")
    PathwayYamlLoader.add_constructor("!pw-variable", PathwayYamlLoader.construct_pathway_variable)
    PathwayYamlLoader.add_multi_constructor("!", PathwayYamlLoader.construct_pathway_value)

    _LOADER = PathwayYamlLoader
    return _LOADER


class _Resolver:
    def __init__(self, definitions: dict[Variable, Any]):
        self.definitions = definitions
        self.cache: dict[Variable, Any] = {}
        self.value_cache: dict[int, Any] = {}
        self.resolving: set[Variable] = set()

    def resolve(self, obj: Any) -> Any:
        if isinstance(obj, Variable):
            return self._resolve_variable(obj)
        if isinstance(obj, Value):
            if id(obj) in self.value_cache:
                return self.value_cache[id(obj)]
            if obj.constructed:
                result = obj.value
            else:
                kwargs = {k: self.resolve(v) for k, v in obj.kwargs.items()}
                result = obj.constructor(**kwargs)
            self.value_cache[id(obj)] = result
            return result
        if isinstance(obj, dict):
            return {k: self.resolve(v) for k, v in obj.items()}
        if isinstance(obj, list):
            return [self.resolve(v) for v in obj]
        return obj

    def _resolve_variable(self, v: Variable) -> Any:
        if v in self.cache:
            return self.cache[v]
        if v in self.resolving:
            raise ValueError(f"pw.load_yaml: circular definition of ${v.name}")
        if v in self.definitions:
            self.resolving.add(v)
            try:
                result = self.resolve(self.definitions[v])
            finally:
                self.resolving.discard(v)
        elif v.name.isupper() or all(c.isupper() or c == "_" for c in v.name):
            raw = os.environ.get(v.name)
            if raw is None:
                raise KeyError(f"pw.load_yaml: variable ${v.name} is not defined")
            result = _yaml().safe_load(raw)
        else:
            raise KeyError(f"pw.load_yaml: variable ${v.name} is not defined")
        self.cache[v] = result
        return result


def load_yaml(stream: str | bytes | IO) -> Any:
    """Load a YAML pipeline template: ``!tags`` construct python objects,
    ``$variables`` declared as top-level keys resolve lazily and are shared."""
    raw = _yaml().load(stream, _loader())  # noqa: S506 — custom SafeLoader subclass
    definitions: dict[Variable, Any] = {}
    if isinstance(raw, dict):
        definitions = {k: v for k, v in raw.items() if isinstance(k, Variable)}
    resolver = _Resolver(definitions)
    if isinstance(raw, dict):
        return {
            k: resolver.resolve(v)
            for k, v in raw.items()
            if not isinstance(k, Variable)
        }
    return resolver.resolve(raw)
