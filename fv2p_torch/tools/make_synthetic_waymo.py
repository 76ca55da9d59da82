"""Write a small synthetic Waymo tree (per-sequence info pkls, per-frame .npy
lidar, the merged train infos and the gt database) that the port's
``WaymoDataset`` reads, so that Waymo models train and are scored without
tensorflow or tfrecords:

    python -m fv2p_torch.tools.make_synthetic_waymo data/waymo_gate

Three sequences of two frames (train 2, val 1), 30000 points a frame, each
frame with two vehicles and a pedestrian planted on the ground, every
vehicle filled front-heavy (75% of its points in the half it heads to), so
that its heading is observable modulo 2 pi. The frames come from numpy's
``RandomState(seed)``; the gt database from
``WaymoDataset.create_groundtruth_database``. For the same arguments the
tree is the one ``tools/make_synthetic_waymo.py`` writes, byte for byte.
"""
import pickle
import sys
from pathlib import Path

import numpy as np

from ..config import REPO_ROOT, EasyDict, cfg_from_yaml_file
from ..datasets.waymo.waymo_dataset import WaymoDataset

CLASSES = ['Vehicle', 'Pedestrian', 'Cyclist']
POINTS_PER_OBJECT = {'Vehicle': 400, 'Pedestrian': 120}


def _frame_points(rng, objs, n=30000):
    """(n, 6) [x, y, z, intensity, elongation, NLZ flag -1]: uniform clutter
    with the objects' points written over its first rows."""
    pts = np.zeros((n, 6), np.float32)
    pts[:, 0] = rng.uniform(-70.0, 70.0, n)
    pts[:, 1] = rng.uniform(-70.0, 70.0, n)
    pts[:, 2] = rng.uniform(-1.8, 3.0, n)
    pts[:, 3] = rng.rand(n)
    pts[:, 4] = rng.rand(n)
    pts[:, 5] = -1.0
    cursor = 0
    for (cx, cy, l, w, h, name) in objs:
        m = POINTS_PER_OBJECT[name]
        sl = slice(cursor, cursor + m)
        cursor += m
        # front-heavy along x (the heading, 0): a box filled evenly would
        # leave its heading unobservable modulo pi
        n_front = int(m * 0.75)
        pts[sl, 0] = np.concatenate([rng.uniform(cx, cx + l / 2, n_front),
                                     rng.uniform(cx - l / 2, cx, m - n_front)])
        pts[sl, 1] = rng.uniform(cy - w / 2, cy + w / 2, m)
        pts[sl, 2] = rng.uniform(0.0, h, m)
    return pts


def _info(seq, fi, objs):
    # z center: objects stand on the z = 0 ground, the box center at h / 2
    boxes = np.array([[cx, cy, h / 2, l, w, h, 0.0] for cx, cy, l, w, h, _ in objs],
                     np.float32)
    names = np.array([o[5] for o in objs])
    n_obj = len(objs)
    return {
        'point_cloud': {'lidar_sequence': seq, 'sample_idx': fi, 'num_features': 5},
        'frame_id': '%s_%03d' % (seq, fi),
        'metadata': {'context_name': seq, 'timestamp_micros': fi},
        'annos': {
            'name': names,
            'difficulty': np.zeros(n_obj, np.int32),
            'dimensions': boxes[:, [3, 5, 4]],   # l, h, w
            'location': boxes[:, :3],
            'heading_angles': boxes[:, 6],
            'obj_ids': np.array(['%s_obj%d' % (seq, i) for i in range(n_obj)]),
            'tracking_difficulty': np.zeros(n_obj, np.int32),
            'num_points_in_gt': np.array([POINTS_PER_OBJECT[nm] for nm in names]),
            'gt_boxes_lidar': boxes,
        },
    }


def main(root, n_train_seq=2, n_val_seq=1, n_frames=2, seed=0):
    root = Path(root)
    rng = np.random.RandomState(seed)
    tag = 'waymo_processed_data'
    (root / 'ImageSets').mkdir(parents=True, exist_ok=True)

    seqs = ['segment-%07d_synth' % i for i in range(n_train_seq + n_val_seq)]
    (root / 'ImageSets' / 'train.txt').write_text(
        '\n'.join(s + '.tfrecord' for s in seqs[:n_train_seq]) + '\n')
    (root / 'ImageSets' / 'val.txt').write_text(
        '\n'.join(s + '.tfrecord' for s in seqs[n_train_seq:]) + '\n')

    all_train_infos = []
    for si, seq in enumerate(seqs):
        seq_dir = root / tag / seq
        seq_dir.mkdir(parents=True, exist_ok=True)
        infos = []
        for fi in range(n_frames):
            objs = [(12.0 + 4 * si + 2 * fi, 3.0, 4.7, 2.1, 1.7, 'Vehicle'),
                    (-20.0 + 3 * fi, -8.0 - 2 * si, 4.7, 2.1, 1.7, 'Vehicle'),
                    (8.0 + fi, -15.0, 0.9, 0.8, 1.8, 'Pedestrian')]
            np.save(seq_dir / ('%04d.npy' % fi), _frame_points(rng, objs))
            infos.append(_info(seq, fi, objs))
        with open(seq_dir / ('%s.pkl' % seq), 'wb') as f:
            pickle.dump(infos, f)
        if si < n_train_seq:
            all_train_infos.extend(infos)

    merged = root / 'waymo_infos_train.pkl'
    with open(merged, 'wb') as f:
        pickle.dump(all_train_infos, f)

    cfg = EasyDict()
    cfg_from_yaml_file(str(REPO_ROOT / 'tools/cfgs/dataset_configs/waymo_dataset.yaml'), cfg)
    cfg.DATA_PATH = str(root)
    # test mode: a train-mode dataset builds the gt-sampling augmentor,
    # which reads the database this call writes
    ds = WaymoDataset(cfg, CLASSES, training=False, root_path=root)
    ds.create_groundtruth_database(merged, root, split='train', sampled_interval=10,
                                   used_classes=CLASSES)
    print('synthetic Waymo tree at', root)


if __name__ == '__main__':
    if len(sys.argv) != 2:
        sys.exit('usage: python -m fv2p_torch.tools.make_synthetic_waymo <output directory>')
    main(sys.argv[1])
