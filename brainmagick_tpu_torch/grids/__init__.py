"""Experiment grids: the Dora-free launcher, the explorers and the grid
definitions.

Port of ``brainmagick_tpu.grids``: grid files are python programs over a
`launcher`; an explorer defines the metric table. The launcher collects
deduplicated config-override jobs, which the runner prints, trains in
this process or in subprocesses (``python -m brainmagick_tpu_torch.train``),
tabulates from each XP's history-torch.json, or exports as CSV, HTML or
an ``sbatch`` array script.

CLI: ``python -m brainmagick_tpu_torch.grids <grid_name> [--run | --table]``.
"""

from .launcher import BMExplorer, ClipExplorer, Explorer, Launcher  # noqa
from .runner import get_grid, list_grids, main  # noqa
