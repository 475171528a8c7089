"""Command-line entry points of the port (the port of ``repro.launch``):
``python -m repro_torch.launch.serve`` and the mesh builders of
``repro_torch.launch.mesh``.  The reference's ``dryrun``, ``train`` and
``cells`` commands are ROADMAP A.14c and A.15."""
