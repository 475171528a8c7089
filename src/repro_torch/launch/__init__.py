"""Command-line entry points of the port (the port of ``repro.launch``):
``python -m repro_torch.launch.serve``, ``python -m
repro_torch.launch.train``, ``python -m repro_torch.launch.dryrun`` (one
rank's program of a cell on the production mesh, counted on fake
tensors: ``cells``, ``op_analysis``) and the mesh specs of
``repro_torch.launch.mesh``."""
