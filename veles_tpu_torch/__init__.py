"""veles_tpu_torch — the PyTorch/CUDA port of ``veles_tpu``.

The JAX package ``veles_tpu`` stays the reference; this package grows
beside it slice by slice and is tested against it on the same inputs and
weights (tests/test_torch_*.py).  It imports ``torch`` and numpy and never
``jax`` or anything of ``veles_tpu``: modules it needs from there that are
free of JAX (``config.py``, ``logger.py``, ``normalization.py``, the
loaders and model factories) are kept here as copies.

Module paths and names mirror the JAX package so a reader finds each
counterpart (``veles_tpu_torch/runtime/engine.py`` ports
``veles_tpu/runtime/engine.py``).  Inside, PyTorch idiom: units are plain
functions over tensor dictionaries, the device is explicit, and random
generators are explicit ``torch.Generator`` objects.

Device policy (``ops.resolve_device``): entry points run on the CUDA card
unless the caller passes ``device="cpu"``; with no card and no explicit
CPU request they raise.  Hand-written CUDA kernels (``ops/kernels``) run
for tensors on a Hopper card; tensors on the CPU take each kernel's plain
PyTorch version.

The public namespace is lazy (PEP 562), as in ``veles_tpu/__init__.py``:
``import veles_tpu_torch`` imports no torch-heavy submodule until an
attribute is touched.
"""

__version__ = "0.1.0"

import importlib as _importlib

#: public attribute -> (submodule, attribute-in-submodule or None for the
#: submodule itself).  This IS the package namespace.
_LAZY = {
    "config": ("config", None),
    "logger": ("logger", None),
    "normalization": ("normalization", None),
    "ops": ("ops", None),
    "units": ("units", None),
    "parallel": ("parallel", None),
    "models": ("models", None),
    "runtime": ("runtime", None),
    "Config": ("config", "Config"),
    "root": ("config", "root"),
    "Logger": ("logger", "Logger"),
    "setup_logging": ("logger", "setup_logging"),
    "Spec": ("units.base", "Spec"),
    "Workflow": ("units.workflow", "Workflow"),
    "StandardWorkflow": ("models.standard", "StandardWorkflow"),
    "DecodeEngine": ("runtime.engine", "DecodeEngine"),
    "RestfulServer": ("runtime.restful", "RestfulServer"),
    "Snapshotter": ("runtime.snapshotter", "Snapshotter"),
    "generate": ("runtime.generate", "generate"),
}

__all__ = sorted(_LAZY)


def __getattr__(name):
    if name not in _LAZY:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}")
    mod_name, attr = _LAZY[name]
    module = _importlib.import_module(f"{__name__}.{mod_name}")
    value = module if attr is None else getattr(module, attr)
    globals()[name] = value         # cache: __getattr__ runs once
    return value


def __dir__():
    return sorted(set(globals()) | set(_LAZY))
