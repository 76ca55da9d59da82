"""One file a slot module of the reference, named as a config's ``NAME``
names it; its ``build(detector)`` makes the module from the detector's
config (``detector.model_cfg``), dataset sizes and compute dtype."""
