"""Cross-rank helpers of the eval merge (counterpart of
``fv2p_tpu/utils/misc.py:all_gather`` and ``reduce_dict``): over
``torch.distributed`` where JAX gathers over its processes. Both return
their input as it is without a process group."""
import torch
import torch.distributed as dist

from .. import parallel
from . import tracing


def all_gather(data):
    """[every rank's picklable ``data``], in rank order."""
    if parallel.world_size() == 1:
        return [data]
    out = [None] * parallel.world_size()
    dist.all_gather_object(out, data)
    return out


def reduce_dict(input_dict, average=True):
    """A dict of scalars summed over the ranks (divided by their number with
    ``average``), in f64."""
    if parallel.world_size() == 1:
        return dict(input_dict)
    names = sorted(input_dict)
    values = torch.tensor([float(input_dict[k]) for k in names], dtype=torch.float64)
    out = parallel.sum_over_ranks(values)
    if average:
        out = out / parallel.world_size()
    tracing.count('host_reads.misc.reduce_dict')
    return dict(zip(names, out.tolist()))
