"""Box coders (reference ``pcdet/utils/box_coder_utils.py``)."""
import torch


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
