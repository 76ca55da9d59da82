"""Dataset package: the meta derivation used by model building and the
dataset dispatch, the loader and the batch conversions around it."""
import functools
import time

import numpy as np
import torch
import torch.utils.data

from .. import parallel


def dataset_meta_from_cfg(data_cfg, split='train'):
    """Static model-construction metadata from a DATA_CONFIG: grid and voxel
    size, point cloud range, point features and the voxel capacity."""
    pc_range = np.array(data_cfg.POINT_CLOUD_RANGE, np.float32)
    voxel_size = None
    voxel_caps = None
    max_ppv = 0
    for proc in data_cfg.DATA_PROCESSOR:
        if proc.NAME == 'transform_points_to_voxels':
            voxel_size = np.array(proc.VOXEL_SIZE, np.float32)
            voxel_caps = proc.MAX_NUMBER_OF_VOXELS
            max_ppv = int(proc.MAX_POINTS_PER_VOXEL)
    if voxel_size is None:
        # point-only pipelines: nominal 0.05 m grid for the modules that
        # consume voxel_size/grid_size metadata
        voxel_size = np.array([0.05, 0.05, 0.1], np.float32)
        voxel_caps = {split: 0}
    grid_size = np.round((pc_range[3:6] - pc_range[0:3]) / voxel_size).astype(int)
    num_point_features = len(data_cfg.POINT_FEATURE_ENCODING['used_feature_list'])
    return {
        'grid_size': tuple(int(g) for g in grid_size),  # (nx, ny, nz)
        'voxel_size': tuple(float(v) for v in voxel_size),
        'point_cloud_range': tuple(float(v) for v in pc_range),
        'num_point_features': num_point_features,
        'voxel_capacity': int(voxel_caps[split]),
        'max_points_per_voxel': max_ppv,
    }


def build_dataset(data_cfg, class_names, root_path=None, training=True,
                  logger=None, rng=None):
    """The dataset named by DATA_CONFIG.DATASET (KITTI, nuScenes or Waymo),
    drawing its random numbers from ``rng`` (a ``np.random.RandomState``;
    None: unseeded)."""
    name = data_cfg.get('DATASET', 'KittiDataset')
    if name == 'KittiDataset':
        from .kitti.kitti_dataset import KittiDataset as cls
    elif name == 'NuScenesDataset':
        from .nuscenes.nuscenes_dataset import NuScenesDataset as cls
    elif name == 'WaymoDataset':
        from .waymo.waymo_dataset import WaymoDataset as cls
    else:
        raise KeyError(f'unknown dataset: {name}')
    return cls(dataset_cfg=data_cfg, class_names=class_names, root_path=root_path,
               training=training, logger=logger, rng=rng)


def collate_to_tensors(collate, batch_list):
    """``collate(batch_list)`` with its numeric arrays as tensors (the same
    memory): a loader worker hands tensors to the main process through
    shared memory, where numpy arrays would be pickled through a pipe."""
    def conv(v):
        if isinstance(v, np.ndarray) and v.dtype.kind in 'biuf':
            return torch.from_numpy(v)
        if isinstance(v, dict):
            return {k: conv(x) for k, x in v.items()}
        return v
    return {k: conv(v) for k, v in collate(batch_list).items()}


def batch_to_numpy(batch):
    """A loader's batch with its tensors as numpy arrays (the same memory)."""
    def conv(v):
        if torch.is_tensor(v):
            return v.numpy()
        if isinstance(v, dict):
            return {k: conv(x) for k, x in v.items()}
        return v
    return {k: conv(v) for k, v in batch.items()}


class GlobalBatchSampler(torch.utils.data.Sampler):
    """The training order of rank ``rank`` of ``world``: each epoch one
    permutation of the ``n`` samples, the same on every rank, cut into
    global batches of ``batch_size`` (a partial last one dropped), of which
    the rank yields its slice (``parallel.global_batch_slice``). So rank r's
    step k takes the samples that JAX's device r takes at step k, and the
    steps of an epoch do not depend on the number of ranks. The epoch's seed
    is drawn from torch's global generator on rank 0, as ``RandomSampler``
    draws it, and broadcast: with one rank this is ``RandomSampler`` with
    the last partial batch dropped."""

    def __init__(self, n, batch_size, rank=0, world=1):
        self.n, self.batch_size = n, batch_size
        self.part = parallel.global_batch_slice(batch_size, rank, world)

    def __iter__(self):
        seed = parallel.broadcast_int(torch.empty((), dtype=torch.int64).random_().item())
        perm = torch.randperm(self.n, generator=torch.Generator().manual_seed(seed)).tolist()
        b = self.batch_size
        for k in range(self.n // b):
            yield from perm[k * b:(k + 1) * b][self.part]

    def __len__(self):
        return self.n // self.batch_size * (self.part.stop - self.part.start)


def build_dataloader(dataset, batch_size, workers, training, pin_memory=False, rank=0,
                     world=1):
    """A DataLoader over ``dataset`` whose batches hold tensors
    (``collate_to_tensors``), copied into pinned memory when ``pin_memory``.
    Training: rank ``rank`` of ``world`` takes its slice of each shuffled
    global batch of ``batch_size`` (``GlobalBatchSampler``), batch_size /
    world samples a step. Eval: the rank takes the samples ``rank::world``
    (``parallel.stride_shard``) in batches of ``batch_size``. Workers are
    spawned, not forked (the main process holds a CUDA context, which a
    forked child cannot use), persist across epochs and seed their dataset
    copy's generator from torch's worker seed."""
    from .dataset import worker_init_fn
    if training:
        sampler = GlobalBatchSampler(len(dataset), batch_size, rank, world)
        batch_size = batch_size // world
    else:
        sampler = parallel.stride_shard(len(dataset), rank, world) if world > 1 else None
    return torch.utils.data.DataLoader(
        dataset, batch_size=batch_size, num_workers=workers, sampler=sampler,
        collate_fn=functools.partial(collate_to_tensors, dataset.collate_batch),
        pin_memory=pin_memory,
        worker_init_fn=worker_init_fn if workers > 0 else None,
        persistent_workers=workers > 0,
        multiprocessing_context='spawn' if workers > 0 else None)


def prefetch(loader, convert):
    """Iterate ``loader`` one batch ahead: the next batch is taken from the
    loader and ``convert``-ed (its copies to the card queued) before the
    current one is handed out. Yields (numpy batch, converted batch,
    seconds the loader made the caller wait for it)."""
    it = iter(loader)
    pending = None
    while True:
        t0 = time.perf_counter()
        try:
            batch_np = next(it)
        except StopIteration:
            break
        wait = time.perf_counter() - t0
        item = (batch_np, convert(batch_np), wait)
        if pending is not None:
            yield pending
        pending = item
    if pending is not None:
        yield pending
