"""Inference helpers (the port of ``repro.inference``)."""

from .fold_norms import fold_norms


class Engine:
    """The reference's deprecated continuous-batching shim over its serve
    scheduler; it comes with the scheduler (ROADMAP A.13)."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "inference.Engine wraps the serve scheduler, which is not "
            "ported yet (ROADMAP A.13: serve)")


__all__ = ["Engine", "fold_norms"]
