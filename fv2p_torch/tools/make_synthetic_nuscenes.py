"""Write a tiny synthetic nuScenes tree (the info pickles, the key frames'
.bin lidar and the gt database) that the port's ``NuScenesDataset`` reads,
so that the nuScenes pipeline (info pickle, CBGS resampling, multi-sweep
points, fixed-shape batch, multihead forward) runs without the nuScenes
devkit or the real data:

    python -m fv2p_torch.tools.make_synthetic_nuscenes data/nuscenes/v1.0-trainval

The directory is the dataset's root, ``DATA_PATH / VERSION``: the yaml's
VERSION is the directory's name. 4 train and
2 val frames of 25000 points, uniform clutter with each object's points
written over its first rows, every one of the ten classes in every frame
(the gt sampler needs every ``SAMPLE_GROUPS`` class in the database), no
sweeps. The frames draw from ``RandomState(seed)``; the gt database of the
train infos comes from ``NuScenesDataset.create_groundtruth_database`` (10
sweeps). For the same arguments the tree is the one
``tools/make_synthetic_nuscenes.py`` writes, byte for byte (the pickles
equal by content)."""
import pickle
import sys
from pathlib import Path

import numpy as np

from ..config import REPO_ROOT, EasyDict, cfg_from_yaml_file
from ..datasets.nuscenes.nuscenes_dataset import NuScenesDataset

CLASSES = ['car', 'truck', 'construction_vehicle', 'bus', 'trailer',
           'barrier', 'motorcycle', 'bicycle', 'pedestrian', 'traffic_cone']
DIMS = {'car': (4.6, 1.9, 1.7), 'truck': (6.9, 2.5, 2.8),
        'construction_vehicle': (6.4, 2.7, 3.2), 'bus': (11.0, 2.9, 3.5),
        'trailer': (12.3, 2.9, 3.9), 'barrier': (0.5, 2.5, 1.0),
        'motorcycle': (2.1, 0.8, 1.5), 'bicycle': (1.7, 0.6, 1.3),
        'pedestrian': (0.7, 0.7, 1.8), 'traffic_cone': (0.4, 0.4, 1.1)}
LARGE = ('car', 'truck', 'bus')       # 300 points an object, the others 100


def _frame(rng, objs, n=25000):
    """(n, 5) [x, y, z, intensity, ring/timestamp slot] raw lidar."""
    pts = np.zeros((n, 5), np.float32)
    pts[:, 0] = rng.uniform(-50.0, 50.0, n)
    pts[:, 1] = rng.uniform(-50.0, 50.0, n)
    pts[:, 2] = rng.uniform(-3.0, 2.0, n)
    pts[:, 3] = rng.rand(n) * 255
    cursor = 0
    for (cx, cy, name) in objs:
        l, w, h = DIMS[name]
        m = 300 if name in LARGE else 100
        sl = slice(cursor, cursor + m)
        cursor += m
        pts[sl, 0] = rng.uniform(cx - l / 2, cx + l / 2, m)
        pts[sl, 1] = rng.uniform(cy - w / 2, cy + w / 2, m)
        pts[sl, 2] = rng.uniform(-1.8, -1.8 + h, m)
    return pts


def main(root, n_train=4, n_val=2, seed=0):
    root = Path(root)
    rng = np.random.RandomState(seed)
    (root / 'samples' / 'LIDAR_TOP').mkdir(parents=True, exist_ok=True)

    split_infos = {'train': [], 'val': []}
    for i in range(n_train + n_val):
        split = 'train' if i < n_train else 'val'
        name = 'synth_%04d' % i
        # every class in every frame, so CBGS duplicates each frame
        # int(frac * class-frame pairs) = 4x a class (an epoch grows 4 -> 40)
        objs = [(12.0 + 3 * i, 4.0, 'car'), (-18.0 + 2 * i, -6.0, 'car')]
        for ci, cname in enumerate(CLASSES[1:]):
            ang = 2 * np.pi * ci / 9
            objs.append((30.0 * np.cos(ang) + i, 30.0 * np.sin(ang), cname))
        rel = 'samples/LIDAR_TOP/%s.bin' % name
        _frame(rng, objs).tofile(root / rel)
        boxes = np.zeros((len(objs), 9), np.float32)
        for j, (cx, cy, cname) in enumerate(objs):
            l, w, h = DIMS[cname]
            boxes[j] = [cx, cy, -1.8 + h / 2, l, w, h, 0.0, 0.0, 0.0]
        split_infos[split].append({
            'lidar_path': rel,
            'token': 'token_%04d' % i,
            'sweeps': [],
            'gt_boxes': boxes,
            'gt_names': np.array([o[2] for o in objs]),
            'num_lidar_pts': np.array([300 if o[2] in LARGE else 100 for o in objs]),
        })

    for split, infos in split_infos.items():
        with open(root / ('nuscenes_infos_10sweeps_%s.pkl' % split), 'wb') as f:
            pickle.dump(infos, f)

    cfg = EasyDict()
    cfg_from_yaml_file(str(REPO_ROOT / 'tools/cfgs/dataset_configs/nuscenes_dataset.yaml'), cfg)
    # the dataset roots itself at the path it is given / VERSION
    cfg.VERSION = root.name
    # test mode: a train-mode dataset builds the gt-sampling augmentor, which
    # reads the database this call writes
    ds = NuScenesDataset(cfg, CLASSES, training=False, root_path=root.parent)
    ds.infos = split_infos['train']
    ds.create_groundtruth_database(max_sweeps=10)
    print('synthetic nuScenes tree at', root)


if __name__ == '__main__':
    if len(sys.argv) != 2:
        sys.exit('usage: python -m fv2p_torch.tools.make_synthetic_nuscenes '
                 '<output directory: DATA_PATH/VERSION>')
    main(sys.argv[1])
