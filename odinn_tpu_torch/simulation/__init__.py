"""Time integration, forward prediction and inversion (``inversion``:
``train_ude`` with every gradient mode and LM stages, ``glacier_residuals``;
``region_inversion``: ``region_map``, ``region_split_inversion``)."""
