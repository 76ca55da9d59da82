"""The port's device-built sparse rulebooks against the JAX package's, on
the CPU.

``fv2p_torch.ops.sparse.rulebook`` builds the neighbour tables from the
voxel keys with sorts and binary searches, where JAX uses occupancy bits
and popcounts; the tables must be equal all the same, integer for integer
(the port's (N_out, K) layout is the transpose of JAX's (K, N_out)). The
tests also hold the device tables to the port's own host tables after the
per-sample row mapping, run a sparse backbone both ways, and show the one
place where the port departs from JAX on purpose: JAX's device branch
applies the yaml's per-sample ``LEVEL_CAPACITIES`` to the whole batch and
drops the rows past them without a word; the port scales them by the
batch size and counts what it drops.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fv2p_tpu.config import StaticConfig
from fv2p_tpu.models.backbones_3d import spconv_backbone as jax_backbone
from fv2p_tpu.ops.sparse import rulebook as jax_rulebook
from fv2p_tpu.ops.sparse import sparse_tensor as jax_st
from tests.jitu import japply, jinit
from tests.test_torch_model import assert_close, assert_equal

from fv2p_torch.models.backbones_3d import spconv_backbone as torch_backbone
from fv2p_torch.ops.sparse import host_rulebook
from fv2p_torch.ops.sparse import rulebook as torch_rulebook
from fv2p_torch.ops.sparse import sparse_tensor as torch_st
from fv2p_torch.weights import init_random_
from tests.test_torch_model import one_torch_thread  # noqa: F401 (an autouse fixture)

SHAPE = (9, 20, 24)                   # (D, H, W) of the single-layer tests
GRID = (24, 20, 40)                   # (nx, ny, nz) of the backbone tests
BB_SHAPE = (41, 20, 24)               # its sparse shape: z = nz + 1


def random_voxels(batch_size, cap, seed, fill=(0.5, 1.0), shape=SHAPE):
    """Unique unsorted voxels per sample, padded with zero rows: coords
    (B*cap, 4) [b, z, y, x], valid (B*cap,), features (B*cap, 4)."""
    rng = np.random.RandomState(seed)
    d, h, w = shape
    coords = np.zeros((batch_size, cap, 4), np.int64)
    valid = np.zeros((batch_size, cap), bool)
    for b in range(batch_size):
        n = rng.randint(int(fill[0] * cap), int(fill[1] * cap) + 1)
        lin = rng.choice(d * h * w, n, replace=False)
        coords[b, :n] = np.stack([np.full(n, b), lin % d, (lin // d) % h, lin // (d * h)], 1)
        valid[b, :n] = True
    feats = rng.rand(batch_size * cap, 4).astype(np.float32)
    return coords.reshape(-1, 4), valid.reshape(-1), feats


def both(coords, valid, feats, batch_size):
    js = jax_st.from_coords(jnp.asarray(coords.astype(np.int32)), jnp.asarray(feats),
                            SHAPE, batch_size, jnp.asarray(valid))
    ts = torch_st.from_coords(torch.from_numpy(coords), torch.from_numpy(feats),
                              SHAPE, batch_size, torch.from_numpy(valid))
    return js, ts


CASES = [(3, 2, 1), (3, 2, (0, 1, 1)), ((3, 1, 1), (2, 1, 1), 0)]


@pytest.mark.parametrize('batch_size', [1, 2, 3])
@pytest.mark.parametrize('conv', CASES, ids=['k3s2p1', 'k3s2p011', 'k311s211'])
def test_tables_equal_jax(batch_size, conv):
    """from_coords' keys and feature order, the submanifold table, and the
    strided layer's output keys, gather table and inverse table."""
    coords, valid, feats = random_voxels(batch_size, 160, seed=batch_size)
    js, ts = both(coords, valid, feats, batch_size)
    assert_equal(ts.keys, np.asarray(js.keys).astype(np.int64))
    assert_equal(ts.features, np.asarray(js.features))
    assert_equal(torch_rulebook.subm_rulebook(ts, 3).T,
                 np.asarray(jax_rulebook.subm_rulebook(js, 3)))
    k, s, p = conv
    jo, jn, ji = jax_rulebook.downsample_rulebook(js, k, s, p, 8 * 160 * batch_size)
    to, tn, ti, dropped = torch_rulebook.downsample_rulebook(ts, k, s, p, 8 * 160 * batch_size)
    assert_equal(to.keys, np.asarray(jo.keys).astype(np.int64))
    assert_equal(tn.T, np.asarray(jn))
    assert_equal(ti.T, np.asarray(ji))
    assert int(dropped) == 0
    assert int(to.valid_mask().sum()) > 0


@pytest.mark.parametrize('short', [0, 1], ids=['cap_reached', 'cap_exceeded_by_one'])
def test_capacity_edge_equals_jax(short):
    """An output capacity equal to the active cell count, and one row short
    of it: the same rows as JAX (the smallest keys), and the port counts
    the row it drops."""
    coords, valid, feats = random_voxels(2, 120, seed=7)
    js, ts = both(coords, valid, feats, 2)
    full = torch_rulebook.downsample_rulebook(ts, 3, 2, 1, 2000)[0]
    cap = int(full.valid_mask().sum()) - short
    jo, jn, ji = jax_rulebook.downsample_rulebook(js, 3, 2, 1, cap)
    to, tn, ti, dropped = torch_rulebook.downsample_rulebook(ts, 3, 2, 1, cap)
    assert_equal(to.keys, np.asarray(jo.keys).astype(np.int64))
    assert_equal(tn.T, np.asarray(jn))
    assert_equal(ti.T, np.asarray(ji))
    assert int(dropped) == short
    assert bool(to.valid_mask().all())


def _host_batch(batch_size, cap, seed):
    """Voxel arrays (B, cap, ...) in shuffled order, and a copy sorted with
    host rulebooks attached."""
    coords, valid, feats = random_voxels(batch_size, cap, seed, fill=(0.3, 0.6),
                                         shape=BB_SHAPE)
    rng = np.random.RandomState(seed + 1)
    c = coords.reshape(batch_size, cap, 4)[..., 1:].astype(np.int32)
    v = valid.reshape(batch_size, cap)
    f = feats.reshape(batch_size, cap, 4)
    for b in range(batch_size):               # shuffle the valid rows
        n = int(v[b].sum())
        perm = rng.permutation(n)
        c[b, :n], f[b, :n] = c[b, :n][perm], f[b, :n][perm]
    shuffled = {'voxel_coords': c, 'voxel_valid': v, 'voxel_features': f}
    host = {'voxel_coords': c.copy(), 'voxel_valid': v.copy(),
            'voxels': f[:, :, None, :].copy(),
            'voxel_num_points': v.astype(np.int32)}
    host_rulebook.prepare_batch_rulebooks(host, 'VoxelResBackBone8x', GRID)
    host['voxel_features'] = host.pop('voxels')[:, :, 0]
    return shuffled, host


def _to_torch(batch):
    return {k: ({kk: torch.from_numpy(np.asarray(vv)) for kk, vv in v.items()}
                if isinstance(v, dict) else torch.from_numpy(np.asarray(v)))
            for k, v in batch.items()}


def test_device_tables_equal_host_tables():
    """The device tables, their rows mapped to the host layout's per-sample
    rows, equal the host tables: each level's voxels, the submanifold
    tables and both tables of every strided layer."""
    shuffled, host = _host_batch(2, 150, seed=3)
    shapes = torch_backbone.VoxelResBackBone8x(4, GRID).shapes
    big = {'x_conv2': 400, 'x_conv3': 400, 'x_conv4': 400, 'out': 400}
    dev = torch_backbone.Rulebooks.on_device(_to_torch(shuffled), shapes, big, False)
    hst = torch_backbone.Rulebooks.from_host(_to_torch(host), shapes)
    assert int(dev.overflow.sum()) == 0

    def row_map(h, d):
        """Host row -> device row (the zero rows map onto each other)."""
        hv, dv = h.valid_mask(), d.valid_mask()
        assert_equal(d.keys[dv], h.keys[hv].numpy())    # same voxels, same order
        m = torch.full((h.capacity + 1,), d.capacity, dtype=torch.int64)
        m[torch.nonzero(hv)[:, 0]] = torch.nonzero(dv)[:, 0]
        return m

    levels = {'x_conv1': (hst.input, dev.input)}
    levels.update({lvl: (hst.down[lvl][0], dev.down[lvl][0]) for lvl in hst.down})
    maps = {lvl: row_map(h, d) for lvl, (h, d) in levels.items()}
    for lvl in hst.subm:
        hv = levels[lvl][0].valid_mask()
        assert_equal(dev.subm[lvl][maps[lvl][:-1][hv]], maps[lvl][hst.subm[lvl][hv]].numpy())
    srcs = dict(zip(torch_backbone.LEVELS[1:], torch_backbone.LEVELS[:-1]))
    for dst, (h_out, h_nbr, h_inv) in hst.down.items():
        _, d_nbr, d_inv = dev.down[dst]
        hv, hs = h_out.valid_mask(), levels[srcs[dst]][0].valid_mask()
        assert_equal(d_nbr[maps[dst][:-1][hv]], maps[srcs[dst]][h_nbr[hv]].numpy())
        assert_equal(d_inv[maps[srcs[dst]][:-1][hs]], maps[dst][h_inv[hs]].numpy())


def test_backbone_same_both_ways():
    """VoxelResBackBone8x on host tables and on device tables gives the same
    features for every voxel of every level."""
    shuffled, host = _host_batch(2, 150, seed=5)
    model = init_random_(torch_backbone.VoxelResBackBone8x(4, GRID), seed=1).eval()
    with torch.no_grad():
        h = model(_to_torch(host))
        d = model(_to_torch(shuffled))
    assert int(d['rulebook_overflow'].sum()) == 0 and 'rulebook_overflow' not in h
    pairs = [(h['multi_scale_3d_features'][k], d['multi_scale_3d_features'][k])
             for k in ('x_conv1', 'x_conv2', 'x_conv3', 'x_conv4')]
    pairs.append((h['encoded_spconv_tensor'], d['encoded_spconv_tensor']))
    for hs, ds in pairs:
        hv, dv = hs.valid_mask(), ds.valid_mask()
        assert_equal(ds.keys[dv], hs.keys[hv].numpy())
        assert_close(ds.features[dv], hs.features[hv].numpy(), tol=1e-5)


def _two_scans():
    """Sample 0: random voxels; sample 1: the same voxels and one more, at
    even coordinates in an empty neighbourhood, which a k3 s2 p1 layer maps
    onto exactly one new x_conv2 cell. So the samples have n and n + 1
    x_conv2 rows, 2n + 1 together. Returns (coords, valid, feats, n)."""
    coords, valid, feats = random_voxels(1, 150, 11, fill=(0.5, 0.7), shape=BB_SHAPE)
    n_in = int(valid.sum())
    occupied = coords[:n_in, 1:]
    for cand in np.ndindex(*(s // 2 for s in BB_SHAPE)):
        cell = 2 * np.array(cand)
        if (np.abs(occupied - cell) > 1).any(1).all():
            break
    else:
        raise AssertionError('no empty neighbourhood')
    two = np.zeros((2, 150, 4), np.int64)
    two[0], two[1] = coords, coords
    two[1, :, 0] = 1
    two[1, n_in] = (1, *cell)
    valid2 = np.zeros((2, 150), bool)
    valid2[0, :n_in], valid2[1, :n_in + 1] = True, True
    feats2 = np.concatenate([feats, feats])
    ts = torch_st.from_coords(torch.from_numpy(two.reshape(-1, 4)),
                              torch.from_numpy(feats2), BB_SHAPE, 2,
                              torch.from_numpy(valid2.reshape(-1)))
    out = torch_rulebook.downsample_rulebook(ts, 3, 2, 1, 4000)[0]
    b = out.coords()[out.valid_mask(), 0]
    n = [int((b == i).sum()) for i in range(2)]
    assert n[1] == n[0] + 1, n
    return two.reshape(-1, 4), valid2.reshape(-1), feats2, n[0]


def test_jax_device_mode_drops_rows_under_per_sample_caps():
    """JAX's device branch (``spconv_backbone.py:130-137``) takes the yaml's
    per-sample LEVEL_CAPACITIES as batch-flat capacities: with an x_conv2
    cap that one sample fits and two do not, it keeps fewer x_conv2 rows
    than the two samples have, and says nothing. The port scales the cap by
    the batch size, keeps every row and counts 0 dropped; with the cap one
    row short of the batch's total it counts 1."""
    coords, valid, feats, n = _two_scans()
    cap = n + 1                  # sample 1's rows: both fit, the batch (2n + 1) not
    batch = {'voxel_coords': coords.reshape(2, 150, 4)[..., 1:].astype(np.int32),
             'voxel_valid': valid.reshape(2, 150),
             'voxel_features': feats.reshape(2, 150, 4)}
    cfg = StaticConfig({'NAME': 'VoxelResBackBone8x',
                        'LEVEL_CAPACITIES': {'x_conv2': cap}})
    jmodel = jax_backbone.VoxelResBackBone8x(model_cfg=cfg, input_channels=4,
                                            grid_size=GRID, voxel_capacity=150)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    variables = jinit(jmodel, jax.random.PRNGKey(0), dict(jb))
    jout = japply(jmodel, variables, dict(jb))
    kept_jax = int(jout['multi_scale_3d_features']['x_conv2'].valid_mask().sum())
    assert kept_jax == cap < 2 * n + 1

    for per_sample, want_drop in ((cap, 0), (n, 1)):
        model = torch_backbone.VoxelResBackBone8x(4, GRID, level_caps={'x_conv2': per_sample})
        model = init_random_(model, seed=0).eval()
        with torch.no_grad():
            out = model(_to_torch(batch))
        kept = int(out['multi_scale_3d_features']['x_conv2'].valid_mask().sum())
        assert kept == min(2 * n + 1, 2 * per_sample)
        assert out['rulebook_overflow'].tolist()[0] == want_drop


def test_device_capacities():
    """Derived caps from the batch's voxel capacity, as JAX's; the yaml's
    per-sample caps (by mode) times the batch size."""
    derived = host_rulebook.level_capacities(4 * 16000)
    assert torch_backbone.device_capacities(4, 16000, None, True) == derived
    nested = {'train': {'x_conv2': 32768, 'out': 8192}}
    got = torch_backbone.device_capacities(4, 16000, nested, True)
    assert got == dict(derived, x_conv2=4 * 32768, out=4 * 8192)
    assert torch_backbone.device_capacities(4, 16000, nested, False) == derived


@pytest.mark.parametrize('batch_size, ok', [(23, True), (24, False)])
def test_key_range_is_checked(batch_size, ok):
    """second.yaml's grid (41 x 1600 x 1408, 92.4M cells a scan) keeps its
    keys below INVALID_KEY up to batch 23; at 24 a valid key would reach it
    and the builders raise instead of corrupting the sort."""
    shape = (41, 1600, 1408)
    coords = torch.tensor([[batch_size - 1, 40, 1599, 1407]])
    feats, valid = torch.ones(1, 4), torch.ones(1, dtype=torch.bool)
    if ok:
        st = torch_st.from_coords(coords, feats, shape, batch_size, valid)
        assert int(st.keys[0]) == batch_size * 41 * 1600 * 1408 - 1 < torch_st.INVALID_KEY
        return
    with pytest.raises(ValueError, match='keys overflow'):
        torch_st.from_coords(coords, feats, shape, batch_size, valid)
    coords_zyx = torch.zeros((batch_size, 1, 3), dtype=torch.int64)
    with pytest.raises(ValueError, match='keys overflow'):
        torch_st.from_host_coords(coords_zyx, torch.ones((batch_size, 1), dtype=torch.bool),
                                  torch.ones((batch_size, 4)), shape, batch_size)
