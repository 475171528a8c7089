"""Command-line entry points of the port (the port of ``repro.launch``):
``python -m repro_torch.launch.serve``, ``python -m
repro_torch.launch.train`` and the mesh specs of
``repro_torch.launch.mesh``.  The reference's ``dryrun`` and ``cells``
commands are ROADMAP A.14c."""
