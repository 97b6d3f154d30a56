"""Model registry (counterpart of dojo_tpu/models/__init__.py).

    get_mechanism(name, device=None, **kwargs) -> Mechanism
    initialize(mech, name, **kwargs) -> BodyState

Only the quadruped is ported so far.
"""

from importlib import import_module

_REGISTRY = {}
_INIT_REGISTRY = {}
_MODULES = ["quadruped"]


def register(name):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn

    return deco


def register_init(name):
    def deco(fn):
        _INIT_REGISTRY[name] = fn
        return fn

    return deco


def _load_all():
    for m in _MODULES:
        import_module(f"dojo_tpu_torch.models.{m}")


def get_mechanism(name, **kwargs):
    """Build a registered mechanism; ``device=None`` means CUDA."""
    _load_all()
    if name not in _REGISTRY:
        raise KeyError(f"unknown mechanism '{name}'; have {sorted(_REGISTRY)}")
    return _REGISTRY[name](**kwargs)


def initialize(mech, name, **kwargs):
    """Initial state of a registered mechanism, on the mechanism's device."""
    _load_all()
    if name not in _INIT_REGISTRY:
        return mech.zero_state()
    return _INIT_REGISTRY[name](mech, **kwargs)
