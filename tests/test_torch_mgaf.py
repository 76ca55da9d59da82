"""The PyTorch port of MGAF-3DSSD inference against the JAX package on the
CPU.

The tiny MGAF model of ``tests/test_mgaf_model.py`` is initialised in JAX on
the tiny batch with host rulebooks (built by each package's own copy), its
BatchNorm statistics perturbed as ``perturb_bn`` does and its deformable
blocks' offset convs moved off their zero initialisation, and its variables
are carried into ``fv2p_torch``. Each port module runs on the JAX module's
own inputs; the whole slice runs end to end from the same numpy batch.

Three weight variants:

* ``jax_init``: ``hm_out``'s bias as JAX initialises it (-2.19). Every
  local maximum of the heat map is negative, so the max-pool NMS's 0.0
  cells outrank them and the top-K is a run of 0.0 ties: this pins the tie
  order (lower flat index first, as ``jax.lax.top_k``).
* ``hm_bias_0``: ``hm_out``'s bias raised to 0 and its kernel redrawn as
  |N(0, 1)|, so detections survive the 0.501 score threshold. (The tiny
  model's activations are small: with bias 0 alone its largest logit is
  0.0038, under the 0.004 the threshold asks for; a positive kernel over
  the ReLU features makes every class's logits positive.)
* ``three_classes``: the class list of ``mgaf-3dssd_3classes.yaml``, with
  ``hm_out`` raised as in ``hm_bias_0``, for the per-class-then-global
  top-K and the labels.

Tolerances: indices, valid flags and labels are exact; float outputs use
rtol 1e-4 (``assert_close``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from fv2p_tpu.models import build_network as jax_build_network
from fv2p_tpu.utils import center_utils as jax_center_utils
from tests.jitu import japply, jinit
from tests.test_mgaf_model import TINY_MODEL_CFG
from tests.test_torch_dcn import perturb_offset_conv
from tests.test_torch_model import (assert_close, assert_equal,
                                    make_rulebook_batches, perturb_bn, t,
                                    to_jax)

import fv2p_torch.models as torch_models
from fv2p_torch.utils import center_utils
from fv2p_torch.utils.synthetic import batch_to_torch
from fv2p_torch.weights import load_flax_variables
from tests.test_torch_model import one_torch_thread  # noqa: F401 (an autouse fixture)

VARIANTS = {'jax_init': ['Car'], 'hm_bias_0': ['Car'],
            'three_classes': ['Car', 'Pedestrian', 'Cyclist']}
PRED_NAMES = ('hm', 'offset', 'height', 'dim', 'rot', 'segm', 'iouscore')


@pytest.fixture(scope='module', params=sorted(VARIANTS))
def run(request):
    variant = request.param
    classes = VARIANTS[variant]
    jax_np, torch_np, meta = make_rulebook_batches()
    jmodel = jax_build_network(TINY_MODEL_CFG, num_class=len(classes),
                               class_names=classes, dataset_meta=meta)
    jb = to_jax(jax_np)
    variables = jinit(jmodel, jax.random.PRNGKey(0), dict(jb))
    rng = np.random.RandomState(1)
    vnp = jax.tree_util.tree_map(np.asarray, dict(variables))
    vnp = perturb_bn(vnp, rng)
    vnp['params'] = perturb_offset_conv(vnp['params'], rng)
    if variant != 'jax_init':
        hm_out = vnp['params']['dense_head']['hm_out']
        hm_out['bias'][:] = 0.0
        hm_out['kernel'] = np.abs(rng.randn(*hm_out['kernel'].shape)).astype(np.float32)
    out = japply(jmodel, jax.tree_util.tree_map(jnp.asarray, vnp), dict(jb))

    tmodel = torch_models.build_network(TINY_MODEL_CFG, len(classes), classes,
                                        meta, device='cpu')
    load_flax_variables(tmodel, vnp)
    tout = tmodel(batch_to_torch(torch_np, 'cpu'))
    return {'variant': variant, 'out': out, 'tmodel': tmodel, 'tout': tout}


def test_dcn_bev_backbone(run):
    bd = run['tmodel'].backbone_2d(
        {'spatial_features': t(run['out']['spatial_features'])})
    assert_close(bd['spatial_features_2d'], run['out']['spatial_features_2d'])


def test_center_af_head_predictions(run):
    out = run['out']
    bd = run['tmodel'].dense_head(
        {'spatial_features_2d': t(out['spatial_features_2d'])})
    assert_close(bd['spatial_features_before_head'],
                 out['spatial_features_before_head'])
    for name in PRED_NAMES:
        assert_close(bd['head_ret'][f'{name}_pred'],
                     out['head_ret'][f'{name}_pred'])


def test_decode_topk_indices_exact(run):
    """The decode on the JAX head's own predictions: the top-K of the
    max-pool-suppressed heat map index for index, then the boxes."""
    out = run['out']
    hm = np.asarray(out['head_ret']['hm_pred'])
    jheat = jax_center_utils.heatmap_maxpool_nms(jnp.asarray(hm))
    heat = center_utils.heatmap_maxpool_nms(t(hm))
    assert_equal(heat, jheat)
    k = int(TINY_MODEL_CFG.DENSE_HEAD.NUM_INFERENCE_SAMPLES)
    ref = jax_center_utils.topk_heatmap(jheat, k)
    got = center_utils.topk_heatmap(heat, k)
    for g, r in zip(got, ref):
        assert_equal(g, r)
    ret = {f'{n}_pred': t(out['head_ret'][f'{n}_pred']) for n in PRED_NAMES}
    dec = run['tmodel'].dense_head.decode_predhm_ssd(ret, k, stride=8)
    for key in ('batch_box_preds', 'batch_cls_preds', 'batch_iouscore_preds'):
        assert_close(dec[key], out[key])
    if run['variant'] == 'jax_init':        # every pick is a suppressed 0.0 cell
        assert (np.asarray(ref[0]) == 0.0).all()


def test_full_slice_predictions(run):
    out, tout = run['out'], run['tout']
    for key in ('batch_box_preds', 'batch_cls_preds', 'batch_iouscore_preds'):
        assert_close(tout[key], out[key])
    assert_equal(tout['pred_valid'], out['pred_valid'])
    assert_equal(tout['pred_labels'], out['pred_labels'])
    assert_close(tout['pred_boxes'], out['pred_boxes'])
    assert_close(tout['pred_scores'], out['pred_scores'])
    n_valid = int(np.asarray(out['pred_valid']).sum())
    if run['variant'] == 'jax_init':
        assert n_valid == 0
    else:
        assert n_valid > 0
    if run['variant'] == 'three_classes':
        labels = np.asarray(out['pred_labels'])[np.asarray(out['pred_valid'])]
        assert len(set(labels.tolist())) > 1
