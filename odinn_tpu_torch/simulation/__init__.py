"""Time integration, forward prediction and inversion (``inversion``:
``train_ude`` with every gradient mode and LM stages, ``glacier_residuals``;
``region_inversion``: ``region_map``, ``region_split_inversion``;
``ensemble``: the member fold and ``multistart_train``; ``eki``:
``eki_train``)."""
