"""The 3D backbones. ``SPARSE_BACKBONES`` maps the name of each sparse
voxel backbone to its class."""
from .spconv_backbone import BACKBONES
from .spconv_unet import UNetV2

SPARSE_BACKBONES = {**BACKBONES, 'UNetV2': UNetV2}


def reads_host_tables(backbone_name):
    """Whether the named backbone takes the loader's host rulebooks: FV2P's
    residual trunk and PartA2's UNetV2 do, SECOND's plain trunk builds its
    own, and a point backbone, PointNet2MSG, takes no voxels at all."""
    cls = SPARSE_BACKBONES.get(backbone_name)
    return cls is not None and cls.host_tables
