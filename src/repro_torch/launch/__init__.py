"""Launchers: the serving launcher (``serve``), the train loop
(``train``), the production meshes on DTensor (``mesh``) and the input
specs of each (arch x shape) cell (``specs``)."""
