"""Write a small synthetic KITTI tree (velodyne, calib, label_2, image_2
stubs and planes, then the info pickles and the gt database) that the
port's ``KittiDataset`` reads, so that KITTI models train and are scored
without the real data:

    python -m fv2p_torch.tools.make_synthetic_kitti data/kitti

32 train and 24 val scans by default. Each scan is a ray-cast LiDAR surface
scan (``utils/lidar_sim.py``): the ground plane, clutter walls and poles,
and 2-4 cars and 1-2 pedestrians planted on the ground at varied positions
in the camera's field of view and varied headings. Scan ``i`` draws from
``RandomState(seed * 100003 + i)``. A planted object with fewer than 5
points is left out of the labels; the labels carry two decimals, and each
object's 2-D box and alpha are projected from those rounded values. The
infos and the gt database come from ``create_kitti_infos`` (2 worker
threads). For the same arguments the tree is the one
``tools/make_synthetic_kitti.py`` writes, byte for byte (the pickles equal
by content)."""
import struct
import sys
import zlib
from pathlib import Path

import numpy as np

from ..config import REPO_ROOT, EasyDict, cfg_from_yaml_file
from ..datasets.kitti.kitti_dataset import create_kitti_infos
from ..utils import box_utils
from ..utils.calibration_kitti import Calibration
from ..utils.lidar_sim import GROUND_Z, simulate_scan

CAR_DIMS = [(3.9, 1.6, 1.56), (4.2, 1.7, 1.5), (3.6, 1.55, 1.4)]
PED_DIMS = [(0.8, 0.6, 1.73), (0.9, 0.65, 1.8)]
IMAGE_SHAPE = (384, 1280)       # (height, width) of the stub images

# the same calibration for every scan: the velodyne frame is the rectified
# camera frame up to the axes' order and signs
CALIB_TXT = '\n'.join([
    'P0: 700 0 600 0 0 700 180 0 0 0 1 0',
    'P1: 700 0 600 0 0 700 180 0 0 0 1 0',
    'P2: 700 0 600 0 0 700 180 0 0 0 1 0',
    'P3: 700 0 600 0 0 700 180 0 0 0 1 0',
    'R0_rect: 1 0 0 0 1 0 0 0 1',
    'Tr_velo_to_cam: 0 -1 0 0 0 0 -1 0 1 0 0 0',
    'Tr_imu_to_velo: 1 0 0 0 0 1 0 0 0 0 1 0',
]) + '\n'


def _place_objects(rng):
    """Boxes that keep 30 m^2 of squared centre distance apart where 20
    draws allow: (K, 7) lidar [cx, cy, cz, l, w, h, ry], cz the centre of a
    box resting on the ground, and the class names."""
    boxes, names = [], []
    n_car = rng.randint(2, 5)
    n_ped = rng.randint(1, 3)
    for kind, n in (('Car', n_car), ('Pedestrian', n_ped)):
        for _ in range(n):
            dims = CAR_DIMS[rng.randint(len(CAR_DIMS))] if kind == 'Car' \
                else PED_DIMS[rng.randint(len(PED_DIMS))]
            l, w, h = dims
            for _try in range(20):
                cx = rng.uniform(6.0, 52.0)
                cy = rng.uniform(-0.62 * cx, 0.62 * cx)  # inside the FOV
                cy = float(np.clip(cy, -18, 18))
                if all((cx - b[0]) ** 2 + (cy - b[1]) ** 2 > 30.0 for b in boxes):
                    break
            ry = rng.uniform(-np.pi, np.pi)
            boxes.append([cx, cy, GROUND_Z + h / 2, l, w, h, ry])
            names.append(kind)
    return np.asarray(boxes, np.float32), names


def _points_in_box(pts, box):
    """Points within the box grown by 5 cm on every side."""
    cx, cy, cz, l, w, h, ry = box
    c, s = np.cos(-ry), np.sin(-ry)
    dx, dy = pts[:, 0] - cx, pts[:, 1] - cy
    lx = c * dx - s * dy
    ly = s * dx + c * dy
    return int(np.sum((np.abs(lx) < l / 2 + 0.05)
                      & (np.abs(ly) < w / 2 + 0.05)
                      & (np.abs(pts[:, 2] - cz) < h / 2 + 0.05)))


def _write_png(path, wpx=IMAGE_SHAPE[1], hpx=IMAGE_SHAPE[0]):
    """A grey 8-bit PNG of the image size (its header is all the dataset reads)."""
    row = b'\x00' + b'\x80' * wpx
    raw = zlib.compress(row * hpx)

    def chunk(tag, data):
        c = struct.pack('>I', len(data)) + tag + data
        return c + struct.pack('>I', zlib.crc32(tag + data) & 0xffffffff)
    png = (b'\x89PNG\r\n\x1a\n'
           + chunk(b'IHDR', struct.pack('>IIBBBBB', wpx, hpx, 8, 0, 0, 0, 0))
           + chunk(b'IDAT', raw) + chunk(b'IEND', b''))
    path.write_bytes(png)


def _label_line(name, box, calib):
    """The KITTI label row of one lidar box: camera frame, bottom centre,
    ry = -heading - pi/2, two decimals; the 2-D box and alpha projected
    from the rounded values."""
    cx, cy, cz, l, w, h, ry_lidar = [float(v) for v in box]
    z_bottom = cz - h / 2
    ry_cam = -ry_lidar - np.pi / 2
    ry_cam = (ry_cam + np.pi) % (2 * np.pi) - np.pi
    cy, z_bottom, cx = round(cy, 2), round(z_bottom, 2), round(cx, 2)
    h, w, l, ry_cam = round(h, 2), round(w, 2), round(l, 2), round(ry_cam, 2)
    box_cam = np.array([[-cy, -z_bottom, cx, l, h, w, ry_cam]], np.float32)
    x1, y1, x2, y2 = box_utils.boxes3d_kitti_camera_to_imageboxes(
        box_cam, calib, image_shape=IMAGE_SHAPE)[0]
    # alpha as the prediction dicts compute it: -arctan2(-y_lidar, x_lidar) + ry_cam
    alpha = -np.arctan2(-cy, cx) + ry_cam
    alpha = (alpha + np.pi) % (2 * np.pi) - np.pi
    return (f'{name} 0.00 0 {alpha:.2f} '
            f'{x1:.2f} {y1:.2f} {x2:.2f} {y2:.2f} '
            f'{h:.2f} {w:.2f} {l:.2f} '
            f'{-cy:.2f} {-z_bottom:.2f} {cx:.2f} {ry_cam:.2f}')


def main(root, n_train=32, n_val=24, seed=0):
    root = Path(root)
    (root / 'ImageSets').mkdir(parents=True, exist_ok=True)
    for sub in ['velodyne', 'calib', 'label_2', 'image_2', 'planes']:
        (root / 'training' / sub).mkdir(parents=True, exist_ok=True)

    ids = ['%06d' % i for i in range(n_train + n_val)]
    (root / 'ImageSets' / 'train.txt').write_text('\n'.join(ids[:n_train]) + '\n')
    (root / 'ImageSets' / 'val.txt').write_text('\n'.join(ids[n_train:]) + '\n')

    for i, sid in enumerate(ids):
        rng = np.random.RandomState(seed * 100003 + i)
        boxes, names = _place_objects(rng)
        pts = simulate_scan(rng, boxes)
        pts.astype(np.float32).tofile(root / 'training' / 'velodyne' / f'{sid}.bin')
        calib_file = root / 'training' / 'calib' / f'{sid}.txt'
        calib_file.write_text(CALIB_TXT)
        calib = Calibration(calib_file)
        # a planted object with fewer than 5 points is hidden: no label
        objs = [_label_line(name, box, calib) for box, name in zip(boxes, names)
                if _points_in_box(pts, box) >= 5]
        (root / 'training' / 'label_2' / f'{sid}.txt').write_text('\n'.join(objs) + '\n')
        _write_png(root / 'training' / 'image_2' / f'{sid}.png')
        (root / 'training' / 'planes' / f'{sid}.txt').write_text(
            '# Plane\nWidth 4\nHeight 1\n0 -1 0 %.2f\n' % -GROUND_Z)

    cfg = EasyDict()
    cfg_from_yaml_file(str(REPO_ROOT / 'tools/cfgs/dataset_configs/kitti_dataset.yaml'), cfg)
    create_kitti_infos(cfg, ['Car', 'Pedestrian', 'Cyclist'], root, root, workers=2)
    print('synthetic KITTI tree at', root)


if __name__ == '__main__':
    if len(sys.argv) != 2:
        sys.exit('usage: python -m fv2p_torch.tools.make_synthetic_kitti <output directory>')
    main(sys.argv[1])
