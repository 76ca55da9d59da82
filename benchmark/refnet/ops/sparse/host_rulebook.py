# Frozen at commit c8e3fcd from fv2p_torch/ops/sparse/host_rulebook.py; the C++ builder left out: the tables come from the numpy builder. A backbone's topology may come from its slot file.
"""Host-side rulebook construction for the sparse backbone.

The rulebook is integer bookkeeping that depends only on voxel coordinates.
``build_sample_rulebooks`` builds all gather tables of a backbone's topology
for one sample in C++ (``native_rulebook.cpp``, built by g++ at first use;
a failed build raises). ``build_sample_rulebooks_plain`` is the numpy
version of the same function (``searchsorted``/``unique``), the reference
the C++ one is held to. ``collate_rulebooks`` stacks the per-sample tables
into the batch layout (per-sample row blocks, one shared zero-pad row at
the end, added by the backbone).

Row convention per level L with capacity C_L: sample b's voxels occupy rows
[b*C_L, b*C_L + n_b); the global zero row is B*C_L (gather sentinel).
"""
import itertools

import numpy as np


def _as3(v):
    if isinstance(v, (tuple, list)):
        return tuple(int(x) for x in v)
    return (int(v),) * 3


def level_capacities(base_capacity):
    """Default fixed per-sample capacities for levels 1..4 + conv_out.

    Strided sparse convs on LiDAR surfaces mostly merge neighbouring cells,
    but isolated cells dilate; the multipliers carry margin over the counts
    measured on ray-cast surface scans, and the additive 256 covers tiny
    inputs whose few isolated voxels dilate up to 8x per level. Builds are
    strict: an overflow raises instead of truncating.
    """
    c = base_capacity
    return {'x_conv1': c, 'x_conv2': int(1.4 * c) + 256,
            'x_conv3': int(0.85 * c) + 256, 'x_conv4': int(0.42 * c) + 256,
            'out': int(0.36 * c) + 256}


def select_mode_caps(caps_override, training):
    """The level capacities a yaml's ``MODEL.BACKBONE_3D.LEVEL_CAPACITIES``
    sets for one mode, or None for the derived defaults.

    A flat ``{level: rows}`` dict applies to both modes; a nested
    ``{'train': {...}, 'test': {...}}`` dict (either key optional) selects by
    mode, and a missing mode key means the derived defaults. A dict that
    mixes mode keys with flat level keys raises ValueError: a
    ``_BASE_CONFIG_`` merge of a child's flat pins over a base's nested caps
    gives that shape, and preferring the mode keys would drop the pins."""
    if not caps_override:
        return None
    has_mode = 'train' in caps_override or 'test' in caps_override
    flat_keys = set(caps_override) - {'train', 'test'}
    if has_mode and flat_keys:
        raise ValueError(
            'LEVEL_CAPACITIES mixes per-mode keys with flat level keys '
            f'({sorted(flat_keys)}); give the override as nested '
            "{'train': {...}, 'test': {...}}")
    if has_mode:
        return caps_override.get('train' if training else 'test')
    return caps_override


def backbone_spec(backbone_name, grid_size, voxel_capacity,
                  caps_override=None, strict=True):
    """Static conv topology of a backbone (sparse z = nz + 1): its slot
    file's ``table_spec`` where it gives one, else the topology the 8x
    sparse backbones share (UNetV2's decoder runs the strided layers'
    tables backwards). The level
    capacities are ``level_capacities(voxel_capacity)``, with the entries of
    ``caps_override`` (level -> rows, one mode's: ``select_mode_caps``) in
    their place, but x_conv1's: that level holds the voxels themselves, so
    its rows are the voxel capacity. (waymo_fv2p_e30.yaml sets x_conv1 to
    90000 for both modes and trains at 80000 voxels: tables of 90000 rows
    over 80000 inputs, on which JAX's backbone fails with a shape error.)"""
    from ...models.detectors.detector3d_template import slot_module
    own = getattr(slot_module(backbone_name), 'table_spec', None)
    if own is not None:
        return own(grid_size, voxel_capacity, caps_override, strict)
    nx, ny, nz = grid_size
    caps = level_capacities(voxel_capacity)
    if caps_override:
        caps.update({k: int(v) for k, v in caps_override.items() if k != 'x_conv1'})
    return {
        'levels': ['x_conv1', 'x_conv2', 'x_conv3', 'x_conv4', 'out'],
        'caps': caps,
        'shapes': {'x_conv1': (nz + 1, ny, nx)},
        'downs': [
            ('x_conv1', 'x_conv2', 3, 2, 1),
            ('x_conv2', 'x_conv3', 3, 2, 1),
            ('x_conv3', 'x_conv4', 3, 2, (0, 1, 1)),
            ('x_conv4', 'out', (3, 1, 1), (2, 1, 1), 0),
        ],
        'subm_levels': ['x_conv1', 'x_conv2', 'x_conv3', 'x_conv4'],
        'strict': bool(strict),
    }


def _out_shape(shape, kernel, stride, padding):
    kd, kh, kw = _as3(kernel)
    sd, sh, sw = _as3(stride)
    pd, ph, pw = _as3(padding)
    d, h, w = shape
    return ((d + 2 * pd - kd) // sd + 1, (h + 2 * ph - kh) // sh + 1,
            (w + 2 * pw - kw) // sw + 1)


def _encode(z, y, x, shape):
    d, h, w = shape
    return ((y.astype(np.int64) * w + x) * d + z)


def _taps(kernel):
    kd, kh, kw = _as3(kernel)
    return np.array(list(itertools.product(range(kd), range(kh), range(kw))),
                    dtype=np.int64)


def _subm_table(coords, n_valid, shape, cap, kernel=3):
    """coords: (n_valid, 3) int (z, y, x) sorted by key -> (K, cap) int32,
    -1 where the neighbour is absent."""
    d, h, w = shape
    kd, kh, kw = _as3(kernel)
    center = np.array([kd // 2, kh // 2, kw // 2], np.int64)
    rel = _taps(kernel) - center                         # (K, 3)
    k = rel.shape[0]
    keys = _encode(coords[:, 0], coords[:, 1], coords[:, 2], shape)

    z = coords[None, :, 0] + rel[:, 0:1]
    y = coords[None, :, 1] + rel[:, 1:2]
    x = coords[None, :, 2] + rel[:, 2:3]
    ok = ((z >= 0) & (z < d) & (y >= 0) & (y < h) & (x >= 0) & (x < w))
    q = _encode(z, y, x, shape)
    pos = np.searchsorted(keys, q.ravel()).reshape(k, -1)
    pos = np.clip(pos, 0, max(n_valid - 1, 0))
    found = ok & (keys[pos] == q) if n_valid > 0 else np.zeros_like(ok)
    out = np.full((k, cap), -1, np.int32)
    out[:, :n_valid] = np.where(found, pos, -1)
    return out


def _down_tables(coords, n_valid, shape, kernel, stride, padding, out_cap):
    """Strided conv: (out_coords (m, 3), m, table (K, out_cap), n_total)."""
    sd, sh, sw = _as3(stride)
    pd, ph, pw = _as3(padding)
    d, h, w = shape
    od, oh, ow = _out_shape(shape, kernel, stride, padding)
    taps = _taps(kernel)

    z_num = coords[None, :, 0] + pd - taps[:, 0:1]
    y_num = coords[None, :, 1] + ph - taps[:, 1:2]
    x_num = coords[None, :, 2] + pw - taps[:, 2:3]
    oz, oy, ox = z_num // sd, y_num // sh, x_num // sw
    ok = ((z_num % sd == 0) & (y_num % sh == 0) & (x_num % sw == 0)
          & (oz >= 0) & (oz < od) & (oy >= 0) & (oy < oh)
          & (ox >= 0) & (ox < ow))
    out_keys = np.unique(_encode(oz, oy, ox, (od, oh, ow))[ok])
    n_total = len(out_keys)
    m = min(n_total, out_cap)
    out_keys = out_keys[:m]

    o_z = (out_keys % od).astype(np.int64)
    col = out_keys // od
    out_coords = np.stack([o_z, col // ow, col % ow], axis=1)

    # gather table from the output side
    in_keys = _encode(coords[:, 0], coords[:, 1], coords[:, 2], shape)
    iz = out_coords[None, :, 0] * sd - pd + taps[:, 0:1]
    iy = out_coords[None, :, 1] * sh - ph + taps[:, 1:2]
    ix = out_coords[None, :, 2] * sw - pw + taps[:, 2:3]
    okk = ((iz >= 0) & (iz < d) & (iy >= 0) & (iy < h)
           & (ix >= 0) & (ix < w))
    q = _encode(iz, iy, ix, shape)
    pos = np.searchsorted(in_keys, q.ravel()).reshape(q.shape)
    pos = np.clip(pos, 0, max(n_valid - 1, 0))
    found = okk & (in_keys[pos] == q) if n_valid > 0 else np.zeros_like(okk)
    out = np.full((taps.shape[0], out_cap), -1, np.int32)
    out[:, :m] = np.where(found, pos, -1)
    return out_coords.astype(np.int32), m, out, n_total


def build_sample_rulebooks_plain(voxel_coords_zyx, n_valid, spec):
    """All backbone tables for ONE sample, in numpy.

    Args:
        voxel_coords_zyx: (cap1, 3) int32; the first n_valid rows are valid
            and already in z-last key order.
        spec: from ``backbone_spec``.
    Returns dict of numpy arrays (local row indices; -1 == missing neighbour):
        subm_<lvl>: (27, cap_lvl); down_<src>-><dst>: (K, cap_dst);
        down_inv_<src>-><dst>: (K, cap_src); coords_<lvl>: (cap_lvl, 3);
        nvalid_<lvl>, ntotal_<lvl>: int.
    """
    caps = spec['caps']
    shape = spec['shapes']['x_conv1']
    coords = voxel_coords_zyx[:n_valid].astype(np.int64)
    out = {'coords_x_conv1': _pad_coords(voxel_coords_zyx, caps['x_conv1']),
           'nvalid_x_conv1': n_valid, 'ntotal_x_conv1': n_valid,
           'subm_x_conv1': _subm_table(coords, n_valid, shape,
                                       caps['x_conv1'])}
    level_coords = {'x_conv1': coords}
    level_shape = {'x_conv1': shape}
    level_nv = {'x_conv1': n_valid}

    for src, dst, k, s, p in spec['downs']:
        oc, m, table, n_total = _down_tables(
            level_coords[src], level_nv[src], level_shape[src], k, s, p,
            caps[dst])
        out[f'down_{src}->{dst}'] = table
        # inverse table: inv[k, i] = o with table[k, o] = i (unique per tap)
        inv = np.full((table.shape[0], caps[src]), -1, np.int32)
        for ki in range(table.shape[0]):
            valid_o = table[ki] >= 0
            inv[ki, table[ki][valid_o]] = np.nonzero(valid_o)[0]
        out[f'down_inv_{src}->{dst}'] = inv
        dst_shape = _out_shape(level_shape[src], k, s, p)
        level_coords[dst] = oc.astype(np.int64)
        level_shape[dst] = dst_shape
        level_nv[dst] = m
        out[f'coords_{dst}'] = _pad_coords(oc, caps[dst])
        out[f'nvalid_{dst}'] = m
        out[f'ntotal_{dst}'] = n_total
        if dst in spec['subm_levels']:
            out[f'subm_{dst}'] = _subm_table(oc.astype(np.int64), m,
                                             dst_shape, caps[dst])

    out['shapes'] = dict(level_shape)
    _check_strict(out, spec)
    return out


def _check_strict(sample_out, spec):
    """Raise on level-capacity overflow: truncation would silently drop a
    contiguous spatial region (rows past the cap in key order)."""
    if not spec.get('strict', False):
        return
    over = {lvl: (int(sample_out[f'ntotal_{lvl}']), spec['caps'][lvl])
            for lvl in spec['levels']
            if int(sample_out[f'ntotal_{lvl}']) > spec['caps'][lvl]}
    if over:
        raise RuntimeError(
            'sparse level capacity overflow (active > cap): %s' % over)


def _pad_coords(coords, cap):
    out = np.zeros((cap, 3), np.int32)
    n = min(len(coords), cap)
    out[:n] = coords[:n]
    return out


def collate_rulebooks(samples, spec):
    """Stack per-sample tables with the batch axis leading. Row indices stay
    sample-local with -1 == missing neighbour."""
    caps = spec['caps']
    out = {}
    for lvl in spec['subm_levels']:
        out[f'subm_{lvl}'] = np.stack(
            [s[f'subm_{lvl}'] for s in samples]).astype(np.int32)
    for src, dst, *_ in spec['downs']:
        out[f'down_{src}->{dst}'] = np.stack(
            [s[f'down_{src}->{dst}'] for s in samples]).astype(np.int32)
        out[f'down_inv_{src}->{dst}'] = np.stack(
            [s[f'down_inv_{src}->{dst}'] for s in samples]).astype(np.int32)
    for lvl in spec['levels']:
        out[f'coords_{lvl}'] = np.stack([s[f'coords_{lvl}'] for s in samples])
        out[f'valid_{lvl}'] = np.stack([
            np.arange(caps[lvl]) < s[f'nvalid_{lvl}'] for s in samples])
    return out


def sort_voxels_by_key(voxel_coords_zyx, shape_zyx):
    """The argsort that puts one sample's voxels in z-last key order."""
    d, h, w = shape_zyx
    keys = ((voxel_coords_zyx[:, 1].astype(np.int64) * w
             + voxel_coords_zyx[:, 2]) * d + voxel_coords_zyx[:, 0])
    return np.argsort(keys, kind='stable')


# Per-level overflow accounting: samples_over[lvl] counts the samples whose
# active count before truncation exceeded the level capacity, max_active[lvl]
# the largest count seen, dropped[lvl] the rows cut. Per process: a loader
# worker keeps its own.
_OVERFLOW_STATS = {'samples': 0, 'samples_over': {}, 'max_active': {},
                   'dropped': {}}


def reset_overflow_stats():
    _OVERFLOW_STATS.update(samples=0, samples_over={}, max_active={},
                           dropped={})


def get_overflow_stats():
    """Snapshot of the counters since the last reset (plain dict)."""
    return {'samples': _OVERFLOW_STATS['samples'],
            'samples_over': dict(_OVERFLOW_STATS['samples_over']),
            'max_active': dict(_OVERFLOW_STATS['max_active']),
            'dropped': dict(_OVERFLOW_STATS['dropped'])}


def _record_overflow(sample_out, spec):
    st = _OVERFLOW_STATS
    st['samples'] += 1
    for lvl in spec['levels']:
        tot = int(sample_out[f'ntotal_{lvl}'])
        cap = spec['caps'][lvl]
        st['max_active'][lvl] = max(st['max_active'].get(lvl, 0), tot)
        if tot > cap:
            st['samples_over'][lvl] = st['samples_over'].get(lvl, 0) + 1
            st['dropped'][lvl] = st['dropped'].get(lvl, 0) + (tot - cap)


def prepare_batch_rulebooks(batch_np, backbone_name, grid_size,
                            caps_override=None, strict=True):
    """Sort a numpy batch's voxels into key order and attach collated
    rulebooks. Mutates and returns ``batch_np`` (numpy arrays).
    ``caps_override``: one mode's level capacities, as ``backbone_spec``.

    batch_np needs: voxel_coords (B, cap, 3) zyx, voxel_valid (B, cap),
    voxels, voxel_num_points.
    """
    coords = batch_np['voxel_coords']
    valid = batch_np['voxel_valid']
    b, cap = coords.shape[:2]
    nx, ny, nz = grid_size
    shape1 = (nz + 1, ny, nx)
    spec = backbone_spec(backbone_name, grid_size, cap,
                         caps_override=caps_override, strict=strict)

    samples = []
    for i in range(b):
        n = int(valid[i].sum())
        order = sort_voxels_by_key(coords[i, :n], shape1)
        for key in ('voxels', 'voxel_coords', 'voxel_num_points'):
            arr = batch_np[key][i]
            arr[:n] = arr[:n][order]
        samples.append(build_sample_rulebooks_plain(batch_np['voxel_coords'][i], n,
                                              spec))
    batch_np['rulebooks'] = collate_rulebooks(samples, spec)
    return batch_np
