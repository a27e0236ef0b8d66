"""String-keyed registries of the pipelines' runners and projects.

The port's copy of the JAX package's ``registry.py``, with the registries
the ported pipelines need: the YAML key ``pipeline_project`` picks the
project (``main``) and the project picks its runner, the contrastive
step picks a loss by ``loss_name``, by the same strings as there, and
``ModelRegistry`` names the LocCa decoder as the JAX package does. ``register_all`` imports every module under ``runners/`` and
``projects/`` so that their decorators run. Configs are picked by
``configs.CONFIG_CLASSES``.
"""

from __future__ import annotations

import importlib
import pkgutil
from typing import Callable, Dict, Type


class RegistryError(KeyError):
    """Raised when a name is missing from a registry."""


class BaseRegistry:
    """A name -> class map with a decorator-based ``register``; each
    subclass holds its own ``_registry``."""

    _registry: Dict[str, Type]

    @classmethod
    def register(cls, *names: str) -> Callable[[Type], Type]:
        """Decorator: register a class under one or more string keys."""

        def deco(klass: Type) -> Type:
            for name in names:
                cls._registry[name] = klass
            return klass

        return deco

    @classmethod
    def get(cls, name: str) -> Type:
        if name not in cls._registry:
            known = ", ".join(sorted(cls._registry)) or "<empty>"
            raise RegistryError(
                f"{cls.__name__}: unknown key {name!r}. Registered: {known}"
            )
        return cls._registry[name]


class RunnerRegistry(BaseRegistry):
    """Runners keyed by pipeline_project."""

    _registry: Dict[str, Type] = {}


class ProjectRegistry(BaseRegistry):
    """Projects keyed by pipeline_project."""

    _registry: Dict[str, Type] = {}


class ModelRegistry(BaseRegistry):
    """Model classes keyed by name (``models/locca_decoder.py``)."""

    _registry: Dict[str, Type] = {}


class LossRegistry(BaseRegistry):
    """Contrastive losses keyed by loss_name (``losses/contrastive.py``)."""

    _registry: Dict[str, Type] = {}


_REGISTERED: set[str] = set()


def register_all() -> None:
    """Import every module under ``runners/`` and ``projects/``."""
    for sub in ("runners", "projects"):
        pkg_name = f"deepcoro_clip_tpu_torch.{sub}"
        if pkg_name in _REGISTERED:
            continue
        pkg = importlib.import_module(pkg_name)
        for info in pkgutil.walk_packages(pkg.__path__, prefix=pkg_name + "."):
            importlib.import_module(info.name)
        _REGISTERED.add(pkg_name)
