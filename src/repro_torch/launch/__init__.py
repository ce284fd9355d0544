"""Entry points of the port (``python -m repro_torch.launch.serve``,
``.train`` and ``.dryrun``), the production meshes (``mesh``) and the op
recorder that tells two runs of a step apart (``oplog``)."""
