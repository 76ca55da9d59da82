"""The port's ``PointNeighborTransformer`` (``fv2p_torch/ops/transformer_pool.py``)
against the JAX package's on the CPU, from JAX's weights: eval mode, and
one train-mode call with the positional encoding's running statistics
after it (its BatchNorm is called twice a forward, the target's points and
then the memory's, and both updates must land in that order); one and two
decoder layers, two and four heads. ``load_flax_variables`` must place
every flax leaf (the attention's DenseGeneral kernels, the LayerNorms),
and ``flax_variables`` must give the tree back.

Tolerance: ``assert_close``'s 1e-4 (relative, and absolute against
min(1, max|ref|)) on outputs and running statistics."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fv2p_tpu.ops.transformer_pool import PointNeighborTransformer as JaxPNT
from tests.test_torch_model import assert_close, perturb_bn

from fv2p_torch.ops.transformer_pool import PointNeighborTransformer
from fv2p_torch.weights import flax_variables, init_random_, load_flax_variables
from tests.test_torch_model import one_torch_thread  # noqa: F401 (an autouse fixture)

M, N_MEM, DIM = 12, 7, 16
CASES = {'1_layer_4_heads': dict(nhead=4, num_layers=1),
         '2_layers_2_heads': dict(nhead=2, num_layers=2)}


def _inputs(seed):
    rng = np.random.RandomState(seed)
    xyz_tgt = rng.uniform(-2, 2, (M, 3)).astype(np.float32)
    xyz_mem = (xyz_tgt[:, None] + rng.uniform(-0.5, 0.5, (M, N_MEM, 3))).astype(np.float32)
    f_tgt = rng.randn(M, DIM).astype(np.float32)
    f_mem = rng.randn(M, N_MEM, DIM).astype(np.float32)
    return xyz_tgt, xyz_mem, f_tgt, f_mem


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if hasattr(v, 'items'):
            yield from _flat(v, prefix + (k,))
        else:
            yield '/'.join(prefix + (k,)), np.asarray(v)


@pytest.mark.parametrize('train', [False, True], ids=['eval', 'train'])
@pytest.mark.parametrize('case', sorted(CASES))
def test_point_neighbor_transformer_matches_jax(case, train):
    kw = dict(dim_in=DIM, dim_out=8, dim_feature=DIM, **CASES[case])
    inputs = _inputs(0)
    jmod = JaxPNT(**kw)
    jin = [jnp.asarray(x) for x in inputs]
    variables = jmod.init(jax.random.PRNGKey(0), *jin)
    vnp = perturb_bn(jax.tree_util.tree_map(np.asarray, dict(variables)),
                     np.random.RandomState(1))
    for path, leaf in _flat(vnp['params']):          # LayerNorm affines off identity
        if path.endswith('scale') and 'norm' in path:
            leaf *= np.random.RandomState(len(path)).uniform(0.5, 1.5, leaf.shape)
    jvars = jax.tree_util.tree_map(jnp.asarray, vnp)
    if train:
        ref, new = jmod.apply(jvars, *jin, train=True, mutable=['batch_stats'])
    else:
        ref = jmod.apply(jvars, *jin)

    tmod = load_flax_variables(PointNeighborTransformer(**kw), vnp).train(train)
    with torch.no_grad():
        got = tmod(*(torch.from_numpy(x) for x in inputs))
    assert tuple(got.shape) == (M, 1, 8)
    assert_close(got, ref)
    if train:
        stats = dict(_flat(flax_variables(tmod)['batch_stats']))
        ref_stats = dict(_flat(jax.tree_util.tree_map(np.asarray, new['batch_stats'])))
        assert sorted(stats) == sorted(ref_stats) == ['pe/bn/mean', 'pe/bn/var']
        for k, v in ref_stats.items():
            assert_close(torch.from_numpy(stats[k]), v)
        # both calls' updates: one call's alone would not match
        once = load_flax_variables(PointNeighborTransformer(**kw), vnp).train()
        with torch.no_grad():
            once.pe(torch.from_numpy(inputs[0])[:, None])
        assert not np.allclose(once.pe.bn.running_mean.numpy(), ref_stats['pe/bn/mean'])


def test_weight_trees_round_trip():
    """The port's flax tree has JAX's paths and shapes (DenseGeneral
    kernels (E, H, D) and (H, D, E), LayerNorm scale and bias), and seeded
    weights survive a round trip through it."""
    kw = dict(dim_in=DIM, dim_out=8, dim_feature=DIM, nhead=4, num_layers=1)
    variables = JaxPNT(**kw).init(jax.random.PRNGKey(0),
                                  *(jnp.asarray(x) for x in _inputs(0)))
    ref = {k: v.shape for k, v in _flat(jax.tree_util.tree_map(np.asarray, dict(variables)))}
    tmod = init_random_(PointNeighborTransformer(**kw), seed=3)
    tree = flax_variables(tmod)
    assert {k: v.shape for k, v in _flat(tree)} == ref
    assert ref['params/layer0/multihead_attn/query/kernel'] == (DIM, 4, DIM // 4)
    assert ref['params/layer0/multihead_attn/out/kernel'] == (4, DIM // 4, DIM)
    back = load_flax_variables(PointNeighborTransformer(**kw), tree)
    for (k, a), b in zip(tmod.state_dict().items(), back.state_dict().values()):
        assert torch.equal(a, b), k
