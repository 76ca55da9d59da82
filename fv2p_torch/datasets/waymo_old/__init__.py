"""The legacy Waymo pipeline's name (reference ``pcdet/datasets/waymo_old/``,
an older snapshot of ``waymo/`` that no registry or config uses): the
port's current ``WaymoDataset``, which loads the infos of either.

``create_waymo_infos`` is not re-exported: it reads the raw tfrecords
through the ``waymo_open_dataset`` package, and the port does not build
the infos (``datasets/waymo/waymo_dataset.py``)."""
from ..waymo.waymo_dataset import WaymoDataset  # noqa: F401
