"""Entry points of the port (``python -m repro_torch.launch.serve``,
``.train`` and ``.dryrun``) and the production meshes (``mesh``)."""
