"""NMI-paper experiment grids: copies of ``brainmagick_tpu.grids.nmi``
(reference: bm/grids/nmi/)."""
