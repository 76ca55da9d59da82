"""Training entry point (counterpart of ``tools/train.py``): the epoch loop
over ``train_utils.train_state.TrainStep`` and the yaml's optimizer
(``adam_onecycle``, ``adam`` or ``sgd``), a checkpoint every
``--ckpt_save_interval`` epochs with rotation to ``--max_ckpt_save_num``,
auto-resume from the newest checkpoint, ``--eval_after_train``, and
``--profile_steps START,END``: a ``torch.profiler`` trace (host and, on the
card, CUDA activity) of the global steps START .. END - 1 (counted from 0),
as JAX's runner traces them, written by each rank to
``<output_dir>/profile/rank<r>_steps_<START>_<END>.json`` (a Chrome trace:
open it in Perfetto or ``chrome://tracing``), with the program's spans as
ranges, and their aggregates (``utils/tracing``'s snapshot) beside it in
``rank<r>_steps_<START>_<END>.spans.json``.

    python -m fv2p_torch.tools.train --cfg_file tools/cfgs/kitti_models/FV2P/fv2p.yaml
    torchrun --nproc_per_node N -m fv2p_torch.tools.train --dist --cfg_file ...
    python -m fv2p_torch.tools.train --num_devices N --cfg_file ...

Data parallel (``--dist`` under torchrun, or ``--num_devices N``, which
starts the N ranks itself; a run inside a process group that already
exists joins it): ``--batch_size`` (default the yaml's BATCH_SIZE_PER_GPU)
is the global batch, split over the ranks as JAX splits it over its mesh,
so an epoch has as many steps at any rank count (``parallel``). Rank 0
alone writes the log file, ``metrics.jsonl`` and the checkpoints and runs
``--eval_after_train``; every rank resumes from the same checkpoint.

Checkpoints are ``torch.save`` files ``<output_dir>/ckpt/checkpoint_epoch_<n>.pth``
holding the model's ``state_dict``, the optimizer's state (the one-cycle
step and the Adam moments) and the epoch; each is written under a temporary
name and renamed into place. ``<output_dir>/metrics.jsonl`` gets every
step's loss terms. The output directory is
``output/torch/<group>/<tag>/<extra_tag>`` unless ``--output_dir`` names one.
"""
import argparse
import datetime
import json
import os
import time

import numpy as np
import torch

from .. import parallel
from ..config import log_config_to_file
from ..datasets import build_dataloader, prefetch
from ..models.backbones_3d.spconv_backbone import LEVELS
from ..ops.sparse import host_rulebook
from ..train_utils.train_state import TrainStep
from ..utils import common_utils, tracing
from ..utils.synthetic import batch_to_torch
from . import test as test_runner
from .eval_utils import eval_one_epoch

FIXED_SEED = 666
LOG_INTERVAL = 50                 # steps between loss lines and overflow checks


def parse_config(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__.split('\n\n')[0],
        epilog='--max_rss_gb (a workaround for a remote-TPU client) has no counterpart.')
    test_runner.add_common_args(parser)
    parser.add_argument('--epochs', type=int, default=None)
    parser.add_argument('--max_ckpt_save_num', type=int, default=30)
    parser.add_argument('--ckpt_save_interval', type=int, default=1,
                        help='save a checkpoint every N epochs (and after the last)')
    parser.add_argument('--eval_after_train', action='store_true', default=False,
                        help='evaluate the last --num_epochs_to_eval checkpoints')
    parser.add_argument('--num_epochs_to_eval', type=int, default=10)
    parser.add_argument('--fix_random_seed', action='store_true', default=False,
                        help=f'seed python, numpy, torch and the dataset with {FIXED_SEED}')
    parser.add_argument('--profile_steps', type=str, default=None,
                        help='"START,END": a torch.profiler trace of the global steps '
                             'START..END-1 into <output_dir>/profile')
    args = parser.parse_args(argv)
    if args.profile_steps is not None:
        args.profile_steps = parse_profile_steps(args.profile_steps)
    return args, test_runner.load_config(args)


def parse_profile_steps(text):
    """'START,END' -> (START, END), 0 <= START < END."""
    try:
        start, end = (int(x) for x in text.split(','))
    except ValueError:
        raise ValueError(f'--profile_steps {text!r}: expected START,END') from None
    if not 0 <= start < end:
        raise ValueError(f'--profile_steps {text!r}: expected 0 <= START < END')
    return start, end


class StepProfiler:
    """A ``torch.profiler`` trace of the global steps [start, end): call
    ``before(step)`` and ``after(step)`` around each step, ``close()`` at the
    end (it writes a trace cut short by the run's end too). The program's
    spans (``utils/tracing``) record while the profiler does: they are ranges
    of the trace, and their aggregates are written beside it as
    ``<trace>.spans.json``."""

    def __init__(self, steps, output_dir, device, rank):
        self.start, self.end = steps
        self.path = output_dir / 'profile' / f'rank{rank}_steps_{self.start}_{self.end}.json'
        self.spans_path = self.path.with_suffix('.spans.json')
        self.device = device
        self.prof = None
        self.written = False

    def before(self, step):
        if step == self.start:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if self.device.type == 'cuda':
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts)
            self.prof.__enter__()

    def after(self, step):
        if self.prof is not None and step + 1 == self.end:
            self.close()

    def close(self):
        if self.prof is None:
            return
        if self.device.type == 'cuda':
            torch.cuda.synchronize(self.device)
        self.prof.__exit__(None, None, None)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.prof.export_chrome_trace(str(self.path))
        self.spans_path.write_text(json.dumps(tracing.snapshot(), indent=1))
        self.prof = None
        self.written = True


def check_device_overflow(trainer, epoch, it):
    """Raise if the device rulebooks have dropped sparse rows at a level's
    capacity in any step so far (``TrainStep.dropped_rows`` summed over the
    ranks, one read from the device), naming each level and the yaml key to
    raise, as the host builder raises at its first overflow. Every rank
    raises together, none is left waiting in a collective. The train loop
    calls it every LOG_INTERVAL steps and before each checkpoint, so a run
    raises within LOG_INTERVAL steps of the first step that drops a row and
    writes no checkpoint after it."""
    if trainer.dropped_rows is None:
        return
    dropped = parallel.sum_over_ranks(trainer.dropped_rows).tolist()
    if any(dropped):
        over = {lvl: int(n) for lvl, n in zip(LEVELS[1:], dropped) if n}
        keys = ', '.join(f'MODEL.BACKBONE_3D.LEVEL_CAPACITIES.{lvl}' for lvl in over)
        raise RuntimeError(
            f'device rulebooks: level capacities dropped sparse rows {over} by step '
            f'{it} (epoch {epoch + 1}); raise {keys}')


def save_checkpoint(trainer, epoch, ckpt_dir):
    """checkpoint_epoch_<epoch>.pth, written to a temporary name first."""
    path = ckpt_dir / f'checkpoint_epoch_{epoch}.pth'
    tmp = ckpt_dir / f'{path.name}.{os.getpid()}.tmp'
    torch.save({'epoch': epoch, 'model_state': trainer.module.state_dict(),
                'optimizer_state': trainer.optimizer.state_dict()}, tmp)
    os.replace(tmp, path)
    return path


def load_checkpoint(trainer, path):
    """Restore the model and the optimizer in place; returns the epoch."""
    ckpt = test_runner.load_model_state(trainer.module, path)
    trainer.optimizer.load_state_dict(ckpt['optimizer_state'])
    return int(ckpt['epoch'])


def rotate_checkpoints(ckpt_dir, keep):
    """Delete all but the newest ``keep`` checkpoints."""
    ckpts = test_runner.checkpoint_list(ckpt_dir)
    for _, path in ckpts[:max(len(ckpts) - keep, 0)]:
        path.unlink()


def _rank_main(argv):
    """One rank of a ``--num_devices`` run: the record without the trainer."""
    return {k: v for k, v in main(argv).items() if k != 'trainer'}


def main(argv=None, on_resume=None):
    """Train. ``on_resume(trainer, path)``, if given, is called right after
    an auto-resume has restored ``path``. Returns a record: the trainer, the
    checkpoint it resumed from, every step's loss terms (host floats; over
    the ranks, their mean), the host seconds between step ends (the
    loader's waits included) and the loader's wait per step, and the eval
    results of --eval_after_train. With --num_devices, rank 0's record
    without the trainer."""
    args, cfg = parse_config(argv)
    if args.num_devices is not None and not parallel.is_distributed():
        out_dir = test_runner.output_dir_of(cfg, args)
        out_dir.mkdir(parents=True, exist_ok=True)
        return parallel.launch(_rank_main, args.num_devices, (argv,), args.device,
                               result_path=out_dir / 'rank0_record.pkl')
    own_group = args.dist and not parallel.is_distributed()
    if own_group:
        parallel.init_process_group(args.device)
    try:
        return _train(args, cfg, on_resume)
    finally:
        if own_group:
            torch.distributed.destroy_process_group()


def _train(args, cfg, on_resume):
    rank, world = parallel.rank(), parallel.world_size()
    if args.fix_random_seed:
        common_utils.set_random_seed(FIXED_SEED)
    batch_size = args.batch_size or cfg.OPTIMIZATION.BATCH_SIZE_PER_GPU
    epochs = args.epochs or cfg.OPTIMIZATION.NUM_EPOCHS

    output_dir = test_runner.output_dir_of(cfg, args)
    ckpt_dir = output_dir / 'ckpt'
    if rank == 0:
        ckpt_dir.mkdir(parents=True, exist_ok=True)
    logger = common_utils.create_logger(
        output_dir / ('log_train_%s.txt' % datetime.datetime.now().strftime('%Y%m%d-%H%M%S'))
        if rank == 0 else None, rank=rank)
    logger.info('**********************Start logging**********************')
    log_config_to_file(cfg, logger=logger)

    train_set = test_runner.make_dataset(
        cfg, training=True, logger=logger, rulebooks=args.rulebooks,
        rng=np.random.RandomState(FIXED_SEED) if args.fix_random_seed else None)
    loader = build_dataloader(train_set, batch_size, args.workers, training=True,
                              pin_memory=args.device == 'cuda', rank=rank, world=world)
    steps_per_epoch = len(loader)
    model = test_runner.make_model(cfg, args, 'train')
    trainer = TrainStep(parallel.wrap_model(model), cfg.OPTIMIZATION, steps_per_epoch * epochs)
    device = trainer.device
    logger.info('model: %d parameters' % sum(p.numel() for p in model.parameters()))

    start_epoch, resumed_from = 0, None
    ckpts = test_runner.checkpoint_list(ckpt_dir)
    if ckpts:
        resumed_from = ckpts[-1][1]
        start_epoch = load_checkpoint(trainer, resumed_from)
        logger.info(f'auto-resumed from {resumed_from} (epoch {start_epoch}, '
                    f'step {trainer.step_count})')
        if on_resume is not None:
            on_resume(trainer, resumed_from)

    logger.info(f'start training: epochs {start_epoch}..{epochs} x {steps_per_epoch} '
                f'steps, global batch {batch_size} over {world} rank(s), on {device}')
    record = {'trainer': trainer, 'resumed_from': resumed_from, 'start_epoch': start_epoch,
              'steps': [], 'step_s': [], 'loader_wait_s': [], 'checkpoints': []}
    metrics_file = open(output_dir / 'metrics.jsonl', 'a') if rank == 0 else None
    profiler = None if args.profile_steps is None else \
        StepProfiler(args.profile_steps, output_dir, device, rank)
    try:
        for epoch in range(start_epoch, epochs):
            terms = []
            t_prev = time.perf_counter()
            for _, batch, wait in prefetch(loader, lambda b: batch_to_torch(b, device)):
                step = epoch * steps_per_epoch + len(terms)
                if profiler is not None:
                    profiler.before(step)
                terms.append(trainer.step(batch))
                if profiler is not None:
                    profiler.after(step)
                now = time.perf_counter()
                record['step_s'].append(now - t_prev)
                record['loader_wait_s'].append(wait)
                t_prev = now
                if len(terms) % LOG_INTERVAL == 0:
                    check_device_overflow(trainer, epoch, epoch * steps_per_epoch + len(terms))
            check_device_overflow(trainer, epoch, epoch * steps_per_epoch + len(terms))
            # one read of the epoch's loss terms from the device
            names = sorted(terms[0])
            table = torch.stack([torch.stack([m[k].float() for k in names])
                                 for m in terms]).cpu().numpy()
            for i, row in enumerate(table):
                line = dict(zip(names, (float(x) for x in row)),
                            epoch=epoch, it=epoch * steps_per_epoch + i + 1)
                record['steps'].append(line)
                if metrics_file is not None:
                    metrics_file.write(json.dumps(line) + '\n')
                if line['it'] % LOG_INTERVAL == 0:
                    logger.info('epoch %d it %d loss %.4f grad_norm %.2f'
                                % (epoch, line['it'], line['loss'], line['grad_norm']))
            if metrics_file is not None:
                metrics_file.flush()
            logger.info('epoch %d: mean loss %.4f' % (epoch + 1, table[:, names.index('loss')].mean()))
            if rank == 0 and ((epoch + 1) % args.ckpt_save_interval == 0 or epoch + 1 == epochs):
                record['checkpoints'].append(save_checkpoint(trainer, epoch + 1, ckpt_dir))
                rotate_checkpoints(ckpt_dir, args.max_ckpt_save_num)
                logger.info(f'saved checkpoint epoch {epoch + 1}')
            of = host_rulebook.get_overflow_stats()
            if of['samples_over']:
                logger.warning('rulebook capacity overflow: %s' % of)
            host_rulebook.reset_overflow_stats()
    finally:
        if metrics_file is not None:
            metrics_file.close()
        if profiler is not None:
            profiler.close()
            if profiler.written:
                record['profile'] = profiler.path
                logger.info(f'profiler trace written to {profiler.path}')
    logger.info('**********************End training**********************')

    if args.eval_after_train and rank == 0:
        record['eval'] = evaluate_checkpoints(cfg, args, output_dir, batch_size, logger)
    return record


def evaluate_checkpoints(cfg, args, output_dir, batch_size, logger):
    """eval_one_epoch of the newest --num_epochs_to_eval checkpoints, the
    whole val set in this process (rank 0 of a data-parallel run, alone, as
    JAX evaluates on process 0); returns {epoch: result dict}."""
    eval_dir = output_dir / 'eval' / 'eval_with_train'
    test_set = test_runner.make_dataset(cfg, training=False, logger=logger,
                                        rulebooks=args.rulebooks)
    loader = build_dataloader(test_set, batch_size, args.workers, training=False,
                              pin_memory=args.device == 'cuda')
    model = test_runner.make_model(cfg, args, 'test')
    results = {}
    for epoch, path in test_runner.checkpoint_list(output_dir / 'ckpt')[-args.num_epochs_to_eval:]:
        test_runner.load_model_state(model, path)
        cur_dir = eval_dir / ('epoch_%d' % epoch)
        cur_dir.mkdir(parents=True, exist_ok=True)
        logger.info(f'--- eval_with_train: epoch {epoch} ---')
        results[epoch], _ = eval_one_epoch(cfg, model, loader, test_set, cur_dir, logger,
                                           batch_size)
    return results


if __name__ == '__main__':
    main()
