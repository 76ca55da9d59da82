"""Evaluation entry point (counterpart of ``tools/test.py``): one checkpoint,
or ``--eval_all``, which watches the checkpoint directory and evaluates each
new checkpoint once, keeping a record file of the evaluated epochs.

    python -m fv2p_torch.tools.test --cfg_file tools/cfgs/kitti_models/FV2P/fv2p.yaml \\
        --ckpt output/torch/kitti_models/FV2P/fv2p/default/ckpt/checkpoint_epoch_80.pth

Results go to ``output/torch/<group>/<tag>/<extra_tag>/eval/`` (or under
``--output_dir``). The model runs on the CUDA card; ``--device cpu`` runs
the kernels' plain versions on the CPU. Without ``--ckpt`` the model keeps
seeded random weights.

Data parallel (``--dist`` under torchrun, ``--num_devices N``, or a process
group that already exists): each rank evaluates the scans ``rank::world``
in batches of ``--batch_size``; rank 0 gathers the detections back into
dataset order, sums the recall counters, scores and writes the results.
"""
import argparse
import datetime
import re
import time
from pathlib import Path

import torch

from .. import parallel
from ..config import REPO_ROOT, EasyDict, cfg_from_list, cfg_from_yaml_file
from ..datasets import build_dataloader, build_dataset, dataset_meta_from_cfg
from ..models import build_network
from ..models.backbones_3d import reads_host_tables
from ..utils import common_utils
from ..weights import init_random_
from .eval_utils import eval_one_epoch

CKPT_PATTERN = re.compile(r'^checkpoint_epoch_(\d+)\.pth$')


def add_common_args(parser):
    """The arguments both runners take."""
    parser.add_argument('--cfg_file', type=str, required=True,
                        help='model yaml, e.g. tools/cfgs/kitti_models/FV2P/fv2p.yaml')
    parser.add_argument('--batch_size', type=int, default=None)
    parser.add_argument('--dtype', choices=['bfloat16', 'float32'], default='bfloat16',
                        help='compute dtype of the model')
    parser.add_argument('--device', choices=['cuda', 'cpu'], default='cuda',
                        help='cuda: the card, which must be present; cpu: the '
                             "kernels' plain versions")
    parser.add_argument('--workers', type=int, default=4,
                        help='loader worker processes (spawned)')
    parser.add_argument('--extra_tag', type=str, default='default')
    parser.add_argument('--output_dir', type=str, default=None,
                        help='default: output/torch/<group>/<tag>/<extra_tag>')
    parser.add_argument('--set', dest='set_cfgs', default=None, nargs=argparse.REMAINDER,
                        help='KEY VALUE pairs that override the yaml')
    parser.add_argument('--dist', action='store_true', default=False,
                        help='join the ranks torchrun started (env://): NCCL on '
                             'the card, gloo on the CPU')
    parser.add_argument('--num_devices', type=int, default=None,
                        help='start this many ranks, one a card (cuda:0..N-1), '
                             'or on the CPU with --device cpu')
    parser.add_argument('--rulebooks', choices=['host', 'device'], default='host',
                        help='host: per-sample rulebooks built in the loader '
                             'workers (C++); device: built in the forward from '
                             'the voxels. A backbone that takes no host tables '
                             '(VoxelBackBone8x) always builds its own')


def load_config(args):
    """The yaml with --set applied."""
    cfg = EasyDict()
    cfg_from_yaml_file(args.cfg_file, cfg)
    cfg.TAG = Path(args.cfg_file).stem
    parts = Path(args.cfg_file).parts
    group = parts[parts.index('cfgs') + 1:-1] if 'cfgs' in parts else ()
    cfg.EXP_GROUP_PATH = '/'.join(group)
    if args.set_cfgs is not None:
        cfg_from_list(args.set_cfgs, cfg)
    return cfg


def output_dir_of(cfg, args):
    if args.output_dir is not None:
        return Path(args.output_dir)
    return REPO_ROOT / 'output' / 'torch' / cfg.EXP_GROUP_PATH / cfg.TAG / args.extra_tag


def make_dataset(cfg, training, logger, rulebooks='host', rng=None):
    """The yaml's dataset for one mode, drawing from ``rng``. With host
    rulebooks, and a backbone that reads them, each sample carries its
    tables at the mode's level capacities; otherwise the samples carry the
    voxels alone, unsorted."""
    dataset = build_dataset(cfg.DATA_CONFIG, class_names=cfg.CLASS_NAMES,
                            training=training, logger=logger, rng=rng)
    backbone = cfg.MODEL.get('BACKBONE_3D')
    if rulebooks == 'host' and backbone is not None and reads_host_tables(backbone.NAME):
        dataset.set_rulebook_spec(cfg.MODEL.BACKBONE_3D.NAME,
                                  caps_override=cfg.MODEL.BACKBONE_3D.get('LEVEL_CAPACITIES'))
    return dataset


def make_model(cfg, args, split):
    """The yaml's model with seeded random weights (seed 0), on the device
    the arguments name."""
    meta = dataset_meta_from_cfg(cfg.DATA_CONFIG, split)
    model = build_network(cfg.MODEL, num_class=len(cfg.CLASS_NAMES),
                          class_names=cfg.CLASS_NAMES, dataset_meta=meta,
                          compute_dtype=getattr(torch, args.dtype),
                          device=None if args.device == 'cuda' else args.device)
    init_random_(model, seed=0)
    return model


def checkpoint_list(ckpt_dir):
    """[(epoch, path)] of the complete checkpoints in ckpt_dir, oldest
    first. A checkpoint is written under a temporary name and renamed into
    place, so a file that matches the name is whole."""
    found = []
    for path in Path(ckpt_dir).glob('checkpoint_epoch_*.pth'):
        m = CKPT_PATTERN.match(path.name)
        if m:
            found.append((int(m.group(1)), path))
    return sorted(found)


def load_model_state(model, path):
    device = next(model.parameters()).device
    ckpt = torch.load(path, map_location=device, weights_only=True)
    model.load_state_dict(ckpt['model_state'])
    return ckpt


def get_no_evaluated_ckpt(ckpt_dir, record_file, start_epoch):
    """The oldest complete checkpoint not yet in the record file, at or
    after start_epoch: (epoch, path), or (-1, None)."""
    evaluated = set()
    if Path(record_file).exists():
        evaluated = {int(float(x)) for x in Path(record_file).read_text().split()}
    for epoch_id, path in checkpoint_list(ckpt_dir):
        if epoch_id not in evaluated and epoch_id >= start_epoch:
            return epoch_id, path
    return -1, None


def parse_config(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    add_common_args(parser)
    parser.add_argument('--ckpt', type=str, default=None, help='checkpoint to evaluate')
    parser.add_argument('--save_to_file', action='store_true', default=False,
                        help='write KITTI-format detection files')
    parser.add_argument('--eval_all', action='store_true', default=False,
                        help='evaluate every checkpoint of ckpt_dir as it appears')
    parser.add_argument('--ckpt_dir', type=str, default=None,
                        help='--eval_all: default <output_dir>/ckpt')
    parser.add_argument('--max_waiting_mins', type=float, default=30,
                        help='--eval_all: give up after this many idle minutes')
    parser.add_argument('--start_epoch', type=int, default=0)
    args = parser.parse_args(argv)
    return args, load_config(args)


def main(argv=None):
    """Returns the result dict of the last evaluation (None when --eval_all
    found no checkpoint; with --num_devices, rank 0's; on the other ranks
    of a data-parallel run, {})."""
    args, cfg = parse_config(argv)
    if args.num_devices is not None and not parallel.is_distributed():
        eval_dir = output_dir_of(cfg, args) / 'eval'
        eval_dir.mkdir(parents=True, exist_ok=True)
        return parallel.launch(main, args.num_devices, (argv,), args.device,
                               result_path=eval_dir / 'rank0_result.pkl')
    own_group = args.dist and not parallel.is_distributed()
    if own_group:
        parallel.init_process_group(args.device)
    try:
        return _evaluate(args, cfg)
    finally:
        if own_group:
            torch.distributed.destroy_process_group()


def _evaluate(args, cfg):
    rank, world = parallel.rank(), parallel.world_size()
    batch_size = args.batch_size or cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU
    output_dir = output_dir_of(cfg, args)
    eval_dir = output_dir / 'eval'
    eval_dir.mkdir(parents=True, exist_ok=True)
    logger = common_utils.create_logger(
        eval_dir / ('log_eval_%s.txt' % datetime.datetime.now().strftime('%Y%m%d-%H%M%S'))
        if rank == 0 else None, rank=rank)

    test_set = make_dataset(cfg, training=False, logger=logger, rulebooks=args.rulebooks)
    if len(test_set) < world:
        raise ValueError(f'{len(test_set)} scans cannot be shared by {world} ranks')
    loader = build_dataloader(test_set, batch_size, args.workers, training=False,
                              pin_memory=args.device == 'cuda', rank=rank, world=world)
    if world > 1:
        logger.info(f'rank {rank} of {world}: {len(loader.sampler)} of {len(test_set)} scans')
    model = make_model(cfg, args, 'test')

    def evaluate(out_dir):
        ret, _ = eval_one_epoch(cfg, model, loader, test_set, out_dir, logger, batch_size,
                                save_to_file=args.save_to_file, merge_ranks=world > 1)
        return ret

    if not args.eval_all:
        if args.ckpt:
            load_model_state(model, args.ckpt)
            logger.info(f'restored {args.ckpt}')
        ret = evaluate(eval_dir)
        logger.info('****************End evaluation****************')
        return ret

    ckpt_dir = Path(args.ckpt_dir) if args.ckpt_dir else output_dir / 'ckpt'
    record_file = eval_dir / ('eval_list_%s.txt' % cfg.DATA_CONFIG.DATA_SPLIT['test'])
    wait_second, total_time, ret = 30, 0, None
    while True:
        # rank 0 picks the checkpoint, so that every rank takes the same one
        epoch_id, _ = get_no_evaluated_ckpt(ckpt_dir, record_file, args.start_epoch)
        epoch_id = parallel.broadcast_int(epoch_id)
        if epoch_id == -1:
            total_time += wait_second
            if total_time > args.max_waiting_mins * 60:
                logger.info('max waiting time reached; exiting')
                break
            logger.info('waiting %d s for the next checkpoint in %s'
                        % (wait_second, ckpt_dir))
            time.sleep(wait_second)
            continue
        total_time = 0
        load_model_state(model, ckpt_dir / f'checkpoint_epoch_{epoch_id}.pth')
        cur_eval_dir = eval_dir / ('epoch_%d' % epoch_id)
        cur_eval_dir.mkdir(parents=True, exist_ok=True)
        ret = evaluate(cur_eval_dir)
        if rank == 0:
            with open(record_file, 'a') as f:
                print('%d' % epoch_id, file=f)
        logger.info('Epoch %d has been evaluated' % epoch_id)
    logger.info('****************End evaluation****************')
    return ret


if __name__ == '__main__':
    main()
