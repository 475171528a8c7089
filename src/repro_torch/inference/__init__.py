"""Inference helpers (the port of ``repro.inference``): the load-time
norm fold and the deprecated ``Engine`` shim over
:mod:`repro_torch.serve`."""

from .fold_norms import fold_norms


def __getattr__(name):
    # Lazy: the shim pulls in the scheduler, which imports fold_norms
    # from this package.
    if name == "Engine":
        from .engine import Engine
        return Engine
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["Engine", "fold_norms"]
