"""Box coders (reference ``pcdet/utils/box_coder_utils.py``)."""
import torch

from . import common_utils


class ResidualCoder:
    """SECOND-style residual coder: (xt, yt) normalized by the anchor BEV
    diagonal, zt by dza, log-dims, the raw angle difference or, with
    ``encode_angle_by_sincos``, the differences of its cosines and sines
    (one code column more). Box columns past the 7th (nuScenes' vx, vy) are
    coded as plain differences."""

    def __init__(self, code_size=7, encode_angle_by_sincos=False, **kwargs):
        self.code_size = code_size
        self.encode_angle_by_sincos = encode_angle_by_sincos
        if self.encode_angle_by_sincos:
            self.code_size += 1

    def encode(self, boxes, anchors):
        """boxes, anchors (N, 7 + C) -> (N, code_size); extents clamped to
        1e-5 on both sides first."""
        anchors = torch.cat([anchors[:, :3], anchors[:, 3:6].clamp(min=1e-5),
                             anchors[:, 6:]], dim=-1)
        boxes = torch.cat([boxes[:, :3], boxes[:, 3:6].clamp(min=1e-5),
                           boxes[:, 6:]], dim=-1)
        xa, ya, za, dxa, dya, dza, ra = [anchors[:, i] for i in range(7)]
        xg, yg, zg, dxg, dyg, dzg, rg = [boxes[:, i] for i in range(7)]
        diagonal = torch.sqrt(dxa ** 2 + dya ** 2)
        xt = (xg - xa) / diagonal
        yt = (yg - ya) / diagonal
        zt = (zg - za) / dza
        dxt = torch.log(dxg / dxa)
        dyt = torch.log(dyg / dya)
        dzt = torch.log(dzg / dza)
        if self.encode_angle_by_sincos:
            rts = [torch.cos(rg) - torch.cos(ra), torch.sin(rg) - torch.sin(ra)]
        else:
            rts = [rg - ra]
        cts = [boxes[:, i] - anchors[:, i] for i in range(7, boxes.shape[-1])]
        return torch.stack([xt, yt, zt, dxt, dyt, dzt, *rts, *cts], dim=-1)

    def decode(self, box_encodings, anchors):
        """box_encodings (..., code_size), anchors (..., 7 + C) -> (..., 7 + C)."""
        xa, ya, za, dxa, dya, dza = [anchors[..., i] for i in range(6)]
        ra = anchors[..., 6]
        xt, yt, zt, dxt, dyt, dzt = [box_encodings[..., i] for i in range(6)]

        diagonal = torch.sqrt(dxa ** 2 + dya ** 2)
        xg = xt * diagonal + xa
        yg = yt * diagonal + ya
        zg = zt * dza + za
        dxg = torch.exp(dxt) * dxa
        dyg = torch.exp(dyt) * dya
        dzg = torch.exp(dzt) * dza
        if self.encode_angle_by_sincos:
            cost, sint = box_encodings[..., 6], box_encodings[..., 7]
            rg = torch.atan2(sint + torch.sin(ra), cost + torch.cos(ra))
        else:
            rg = box_encodings[..., 6] + ra
        s = int(self.encode_angle_by_sincos)
        cgs = [box_encodings[..., i + s] + anchors[..., i]
               for i in range(7, anchors.shape[-1])]
        return torch.stack([xg, yg, zg, dxg, dyg, dzg, rg, *cgs], dim=-1)


class PointResidualCoder:
    """Point-based 8-dim coder (PointRCNN's point head): the offset of the
    box center from the point, normalised by the BEV diagonal and height of
    the class's mean size, log-dims against that size, and the heading as
    (cos, sin). Without ``use_mean_size`` the offsets are raw and the dims
    plain logs. Box columns past the 7th are copied through."""

    def __init__(self, code_size=8, use_mean_size=True, **kwargs):
        self.code_size = code_size
        self.use_mean_size = use_mean_size
        if self.use_mean_size:
            self.mean_size = [[float(v) for v in row] for row in kwargs['mean_size']]
            if min(min(row) for row in self.mean_size) <= 0:
                raise ValueError(f'mean_size must be positive: {self.mean_size}')

    def _sizes(self, classes, ref):
        """(..., 3) mean size of each class in [1, C] (clamped into range)."""
        ms = common_utils.device_constant(self.mean_size, ref.dtype, ref.device)
        return ms[(classes.long() - 1).clamp(0, ms.shape[0] - 1)]

    def encode(self, gt_boxes, points, gt_classes=None):
        """gt_boxes (N, 7 + C), points (N, 3), gt_classes (N,) in [1, C] ->
        (N, 8 + C); extents clamped to 1e-5 first."""
        gt_boxes = torch.cat([gt_boxes[:, :3], gt_boxes[:, 3:6].clamp(min=1e-5),
                              gt_boxes[:, 6:]], dim=-1)
        xg, yg, zg, dxg, dyg, dzg, rg = [gt_boxes[:, i] for i in range(7)]
        xa, ya, za = points[:, 0], points[:, 1], points[:, 2]
        if self.use_mean_size:
            sizes = self._sizes(gt_classes, gt_boxes)
            dxa, dya, dza = sizes[:, 0], sizes[:, 1], sizes[:, 2]
            diagonal = torch.sqrt(dxa ** 2 + dya ** 2)
            xt, yt, zt = (xg - xa) / diagonal, (yg - ya) / diagonal, (zg - za) / dza
            dxt, dyt, dzt = torch.log(dxg / dxa), torch.log(dyg / dya), torch.log(dzg / dza)
        else:
            xt, yt, zt = xg - xa, yg - ya, zg - za
            dxt, dyt, dzt = torch.log(dxg), torch.log(dyg), torch.log(dzg)
        extra = [gt_boxes[:, i] for i in range(7, gt_boxes.shape[-1])]
        return torch.stack([xt, yt, zt, dxt, dyt, dzt, torch.cos(rg), torch.sin(rg),
                            *extra], dim=-1)

    def decode(self, box_encodings, points, pred_classes=None):
        """box_encodings (..., 8 + C), points (..., 3), pred_classes (...)
        in [1, C] -> (..., 7 + C)."""
        xt, yt, zt, dxt, dyt, dzt, cost, sint = [box_encodings[..., i] for i in range(8)]
        xa, ya, za = points[..., 0], points[..., 1], points[..., 2]
        if self.use_mean_size:
            sizes = self._sizes(pred_classes, box_encodings)
            dxa, dya, dza = sizes[..., 0], sizes[..., 1], sizes[..., 2]
            diagonal = torch.sqrt(dxa ** 2 + dya ** 2)
            xg, yg, zg = xt * diagonal + xa, yt * diagonal + ya, zt * dza + za
            dxg, dyg, dzg = torch.exp(dxt) * dxa, torch.exp(dyt) * dya, torch.exp(dzt) * dza
        else:
            xg, yg, zg = xt + xa, yt + ya, zt + za
            dxg, dyg, dzg = torch.exp(dxt), torch.exp(dyt), torch.exp(dzt)
        rg = torch.atan2(sint, cost)
        extra = [box_encodings[..., i] for i in range(8, box_encodings.shape[-1])]
        return torch.stack([xg, yg, zg, dxg, dyg, dzg, rg, *extra], dim=-1)
