"""Model frontends of the port.  Only the ``.npz`` container is ported;
the frontend registry and the tracer are ROADMAP A.9."""

from .container import load_model, save_model

__all__ = ["load_model", "save_model"]
