"""PointNet++ MSG backbone of PointRCNN (counterpart of
``fv2p_tpu/models/backbones_3d/pointnet2_backbone.py``): a hierarchy of set
abstraction levels (farthest-point sampled centers, kernel B2; multi-scale
ball grouping; a shared MLP and a max over each ball), then feature
propagation back to every input point (3-NN interpolation, kernel B3; the
skip features; an MLP).

The ball group is ``pointops.ball_query_rows`` + ``group_rows``: JAX
builds the dense (B, npoint, N) distance matrix (1.07 GB of f32 at the
first level of pointrcnn.yaml: 4 x 4096 centers x 16384 points); the port
searches the same rows in chunks of bounded size. Every layer computes in
f32, as flax does with f32 parameters and no dtype; BatchNorm runs over
the flattened rows (momentum 0.99, epsilon 1e-3)."""
import torch
from torch import nn

from ...ops import pointops
from ..layers import BatchNorm, Dense


def _mlp(owner, prefix, bn_prefix, in_channels, channels):
    """Dense (no bias) + BatchNorm layers named ``{prefix}{j}`` and
    ``{bn_prefix}{j}`` on ``owner``; returns the output width."""
    ch = in_channels
    for j, out in enumerate(channels):
        setattr(owner, f'{prefix}{j}', Dense(ch, int(out), False))
        setattr(owner, f'{bn_prefix}{j}', BatchNorm(int(out)))
        ch = int(out)
    return ch


def _run_mlp(owner, prefix, bn_prefix, n, x):
    for j in range(n):
        x = torch.relu(getattr(owner, f'{bn_prefix}{j}')(getattr(owner, f'{prefix}{j}')(x)))
    return x


class _MSGLevel(nn.Module):
    """One SA level: ``npoint`` FPS centers, then per radius the first
    ``nsample`` points of the ball (relative xyz and features), an MLP
    (``mlp{i}_{j}`` / ``bn{i}_{j}``) and a max over the ball."""

    def __init__(self, npoint, radii, nsamples, mlps, in_channels):
        super().__init__()
        self.npoint = int(npoint)
        self.radii = tuple(float(r) for r in radii)
        self.nsamples = tuple(int(n) for n in nsamples)
        self.depths = [len(m) for m in mlps]
        self.out_channels = sum(_mlp(self, f'mlp{i}_', f'bn{i}_', 3 + in_channels, m)
                                for i, m in enumerate(mlps))

    def forward(self, xyz, valid, feats):
        """xyz (B, N, 3), valid (B, N), feats (B, N, C) or None -> new_xyz
        (B, npoint, 3), new_valid (B, npoint), new_feats (B, npoint, out)."""
        b, n, _ = xyz.shape
        idx = pointops.farthest_point_sample_batch(xyz, valid, self.npoint)
        new_xyz = torch.gather(xyz, 1, idx[..., None].expand(-1, -1, 3))
        new_valid = torch.gather(valid, 1, idx)
        if feats is None:
            feats = xyz.new_zeros((b, n, 0))
        xyz_flat = xyz.reshape(b * n, 3)
        feats_flat = feats.reshape(b * n, -1)
        rows = pointops.ball_query_rows(new_xyz, xyz_flat, valid.reshape(-1),
                                        [i * n for i in range(b + 1)], self.radii,
                                        self.nsamples)
        outs = []
        for i, idx_i in enumerate(rows):
            gx, gf, _ = pointops.group_rows(new_xyz, xyz_flat, feats_flat, idx_i)
            g = _run_mlp(self, f'mlp{i}_', f'bn{i}_', self.depths[i],
                         torch.cat([gx, gf], dim=-1))
            outs.append(g.amax(dim=2))
        return new_xyz, new_valid, torch.cat(outs, dim=-1)


class _FPLevel(nn.Module):
    """Feature propagation: the deeper level's features interpolated onto
    this level's points (inverse-distance weights of the 3 nearest valid
    ones), after this level's own features, through an MLP (``fp{j}`` /
    ``fp_bn{j}``)."""

    def __init__(self, mlp, in_channels):
        super().__init__()
        self.depth = len(mlp)
        self.out_channels = _mlp(self, 'fp', 'fp_bn', in_channels, mlp)

    def forward(self, xyz, skip_feats, deep_xyz, deep_valid, deep_feats):
        x = pointops.three_nn_interpolate(deep_xyz, deep_valid, deep_feats, xyz)
        if skip_feats is not None:
            x = torch.cat([skip_feats.to(x.dtype), x], dim=-1)
        return _run_mlp(self, 'fp', 'fp_bn', self.depth, x)


class PointNet2MSG(nn.Module):
    """``points`` (B, P, 3 + C) and ``points_valid`` (B, P) -> per-point
    ``point_features`` (B, P, FP_MLPS[0][-1]) and ``point_coords`` (B, P, 3)."""

    def __init__(self, model_cfg, input_channels):
        super().__init__()
        sa = model_cfg.SA_CONFIG
        self.n_sa = len(sa.NPOINTS)
        skip = [int(input_channels) - 3]
        for i in range(self.n_sa):
            level = _MSGLevel(sa.NPOINTS[i], sa.RADIUS[i], sa.NSAMPLE[i], sa.MLPS[i],
                              skip[-1])
            setattr(self, f'sa{i}', level)
            skip.append(level.out_channels)
        fp_mlps = list(model_cfg.FP_MLPS)
        self.n_fp = len(fp_mlps)
        deep = skip[self.n_fp]
        for i in range(self.n_fp - 1, -1, -1):
            level = _FPLevel(fp_mlps[i], skip[i] + deep)
            setattr(self, f'fp{i}', level)
            deep = level.out_channels
        self.num_point_features = deep

    def forward(self, batch_dict):
        points = batch_dict['points'].float()
        valid = batch_dict['points_valid']
        xyz = points[..., :3].contiguous()
        feats = points[..., 3:] if points.shape[-1] > 3 else None
        l_xyz, l_valid, l_feats = [xyz], [valid], [feats]
        for i in range(self.n_sa):
            nx, nv, nf = getattr(self, f'sa{i}')(l_xyz[-1], l_valid[-1], l_feats[-1])
            l_xyz.append(nx)
            l_valid.append(nv)
            l_feats.append(nf)
        for i in range(self.n_fp - 1, -1, -1):
            l_feats[i] = getattr(self, f'fp{i}')(l_xyz[i], l_feats[i], l_xyz[i + 1],
                                                 l_valid[i + 1], l_feats[i + 1])
        batch_dict['point_features'] = l_feats[0]
        batch_dict['point_coords'] = l_xyz[0]
        return batch_dict
