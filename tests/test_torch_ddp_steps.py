"""Two data-parallel train steps over two gloo ranks spawned from
``tests/ddp_worker.py`` (split from ``tests/test_torch_ddp.py``, which holds
one step against JAX's ``make_dp_train_step``): the tiny MGAF-3DSSD and
PointRCNN, every loss term of both steps finite and equal on both ranks,
the loss moved by the first update, and both ranks ending with the same
parameters and statistics."""
import numpy as np
import pytest

from tests import ddp_worker
from tests.test_torch_train import flat_paths

from fv2p_torch import parallel

from tests.test_torch_ddp import (  # noqa: F401 (launch_limits: an autouse fixture)
    WORLD, launch_limits, mgaf_setup, pointrcnn_setup, write_spec)
from tests.test_torch_model import one_torch_thread  # noqa: F401 (an autouse fixture)


@pytest.mark.parametrize('name', ['mgaf', 'pointrcnn'])
def test_dp_two_steps_leave_the_ranks_replicated(name, tmp_path):
    """Two data-parallel steps over two ranks (DDP raises at a step's
    forward when a parameter got no reduced gradient in the step before):
    every loss term of both steps finite and the same on both ranks (the
    ranks' mean), the loss moved by the first update, and both ranks end
    with the same parameters and statistics. PointRCNN's RCNN regression
    has foreground RoIs in both steps."""
    s = {'mgaf': mgaf_setup, 'pointrcnn': pointrcnn_setup}[name]()
    spec = write_spec(s, tmp_path / 'spec.pkl', 2, steps=2)
    ranks = parallel.launch(ddp_worker.dp_step, WORLD, (str(spec),), 'cpu',
                            result_path=tmp_path / 'result.pkl')
    assert ranks[0]['steps'] == ranks[1]['steps'] and len(ranks[0]['steps']) == 2
    for terms in ranks[0]['steps']:
        assert all(np.isfinite(v) for v in terms.values()), terms
        if name == 'pointrcnn':
            assert terms['rcnn_loss_reg'] > 0, terms
    assert ranks[0]['steps'][1]['loss'] != ranks[0]['steps'][0]['loss']
    a, b = (flat_paths(r['variables']) for r in ranks)
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
