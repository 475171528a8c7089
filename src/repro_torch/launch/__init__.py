"""Command-line entry points of the port (the port of ``repro.launch``):
``python -m repro_torch.launch.serve``.  The reference's ``mesh``,
``dryrun``, ``train`` and ``cells`` commands are ROADMAP A.14 and A.15."""
