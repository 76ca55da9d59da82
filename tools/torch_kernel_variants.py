#!/usr/bin/env python3
"""Times variants of the 3-NN (B3), rotated-IoU (B1) and FPS (B2) CUDA
kernels of the PyTorch port on the inputs that the forwards give them.

    python3 tools/torch_kernel_variants.py      # repository root, one CUDA card

The tree keeps one kernel per function, its shape as plain ``constexpr``
constants. A variant here is a copy of the kernel's source under
``build/variants/`` with some of those constants set to other values (for
B1, also with the shared-memory queue taken out so that every thread clips
its own surviving pairs; for B2's 180000-point instantiation, with the
one-level exchange of the 8-block shapes in place of its two-level one),
built with the port's own flags and loaded in place of the kept library.
The script runs the bench forward of ``chip_smoke.py`` once to capture the
B3 and B1 calls, and takes B2's call from the Waymo FV2P forward's inputs
(``chip_smoke.waymo_batch``: 16384 picks from 2 x 180000 points of
data/waymo); it checks that each variant's outputs equal the kept kernel's
bit for bit, and prints the time the card is busy in one forward's calls
(``chip_smoke.device_ms``, mean of 20 replays; 3 for B2), for B2 beside the
variant's chain floor, with the card's name and power limit. A fuller
record goes to ``chiprun_out/kernel_variants.json``.
"""
import json
import re
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402
from fv2p_torch.ops import cuda as kcuda  # noqa: E402
from fv2p_torch.ops.cuda import fps, rotated_iou, three_nn  # noqa: E402

THREE_NN = [{}] + [{'kTileRows': v} for v in (64, 128, 384, 512)] + [
    {'kWarps': v} for v in (2, 8, 16)] + [
    {'kQueriesPerBlock': v} for v in (8, 32, 64)] + [
    {'kTileRows': 128, 'kWarps': 8, 'kQueriesPerBlock': 64},
    {'kWarps': 8, 'kQueriesPerBlock': 32}]
ROTATED_IOU = [{}, {'kThreads': 128}, {'kThreads': 512}, {'kTile': 16},
               {'kTile': 64}, {'queue': False}, {'queue': False, 'kThreads': 128}]
FPS = [{}, {'kWideTwoLevel': 'false'}]

# B1 without the queue: where a surviving pair would be queued, clip it
QUEUE_PUSH = '''    const unsigned mask = __ballot_sync(kFull, live);
    if (mask) {
      const int lane = tid & 31;
      int base = 0;
      if (lane == __ffs(mask) - 1) base = atomicAdd(&queued, __popc(mask));
      base = __shfl_sync(kFull, base, __ffs(mask) - 1);
      if (live) queue[base + __popc(mask & ((1u << lane) - 1))] = (unsigned short)e;
    }
'''
CLIP_IN_PLACE = '''    if (live) {
      float ax[4], ay[4], bx[4], by[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        ax[c] = rows.x[ti][c];
        ay[c] = rows.y[ti][c];
        bx[c] = cols.x[tj][c];
        by[c] = cols.y[tj][c];
      }
      float v = clip_area(ax, ay, bx, by);
      if (kBoxes) v = v / fmaxf((rows.area[ti] + cols.area[tj]) - v, 1e-6f);
      out[(size_t)i * m + j] = v;
    }
'''


def variant_source(name, changes):
    src = (kcuda.CSRC / f'{name}.cu').read_text()
    for const, value in changes.items():
        if const == 'queue':
            if src.count(QUEUE_PUSH) != 1:
                raise RuntimeError('rotated_iou.cu no longer queues as this '
                                   'script expects')
            src = src.replace(QUEUE_PUSH, CLIP_IN_PLACE)
            continue
        src, n = re.subn(rf'(constexpr (?:int|bool) {const} = )[^;]+;', rf'\g<1>{value};',
                         src)
        if n != 1:
            raise RuntimeError(f'{name}.cu has no constant {const}')
    return src


def label(changes):
    return ', '.join(f'{k} = {v}' for k, v in changes.items()) or 'as kept'


def outputs(k):
    out = []
    for call in k.calls:
        res = k.launch(call)
        out += list(res) if isinstance(res, tuple) else [res]
    cs.sync()
    return out


def main():
    if not torch.cuda.is_available():
        print('needs a CUDA card')
        return 2
    smi = cs.nvidia_smi()
    kernels = {
        'three_nn': (cs.Kernel('three_nn', three_nn, {'three_nn_cuda': 'three_nn_plain'},
                               '', ''), THREE_NN),
        'rotated_iou': (cs.Kernel('rotated_iou', rotated_iou,
                                  {'iou_bev_cuda': 'iou_bev_plain',
                                   'iou_bev_upper_cuda': 'iou_bev_upper_plain'}, '', ''),
                        ROTATED_IOU),
        'fps': (cs.Kernel('fps', fps, {'fps_cuda': 'fps_plain'}, '', ''), FPS),
    }
    jobs, libs = {}, {}
    out_dir = kcuda.BUILD_DIR.parent / 'variants'
    out_dir.mkdir(parents=True, exist_ok=True)
    for name, (_, variants) in kernels.items():
        for i, changes in enumerate(variants):
            src = out_dir / f'{name}-{i}.cu'
            src.write_text(variant_source(name, changes))
            libs[name, i] = out_dir / f'lib{name}-{i}.so'
            jobs[f'{name}: {label(changes)}'] = (src, libs[name, i])
    built = kcuda.compile_sources(jobs)
    print(f'# card: {smi}; built {len(built)} variants in '
          f'{max(s for s, _ in built.values()):.1f} s', flush=True)

    from fv2p_torch.utils.synthetic import batch_to_torch
    cfg, meta, batch_np, _ = cs.build_inputs()
    model = cs.make_model(cfg, meta, torch.bfloat16)
    with cs.patched([kernels['three_nn'][0], kernels['rotated_iou'][0]], cs.capturing):
        cs.forward(model, batch_to_torch(batch_np, 'cuda'))
    cs.sync()
    # B2 as Waymo FV2P's decoder calls it (pointops.farthest_point_sample_batch)
    wcfg = cs.load_cfg(cs.WAYMO_FV2P_CFG)
    wbatch, _ = cs.waymo_batch(wcfg, training=False)
    kernels['fps'][0].calls.append(('fps_cuda', (
        wbatch['points'][..., :3].float().contiguous(), wbatch['points_valid'].contiguous(),
        int(wcfg.MODEL.POST_PFE.NUM_KEYPOINTS))))

    record = {'nvidia_smi': smi, 'variants': []}
    for name, (k, variants) in kernels.items():
        kept = outputs(k)
        print(f'# {name}: {len(k.calls)} calls a forward')
        for i, changes in enumerate(variants):
            kcuda._libs[name] = kcuda.load(libs[name, i], name)
            same = all(torch.equal(a, b) for a, b in zip(outputs(k), kept))
            ms = cs.device_ms(lambda: [k.launch(c) for c in k.calls],
                              reps=3 if name == 'fps' else 20)
            regs = re.findall(r'Used (\d+) registers', built[f'{name}: {label(changes)}'][1])
            row = {'kernel': name, 'changes': changes, 'device_ms': ms,
                   'equal_to_kept': same, 'registers': [int(r) for r in regs]}
            if name == 'fps':
                row['chain_floor_ms'] = cs.time_events(
                    lambda: [fps.fps_chain_floor_cuda(*a) for _, a in k.calls], reps=3)
            record['variants'].append(row)
            print(f'{name:12s} {label(changes):40s} {ms:.4f} ms  '
                  f'{"equal" if same else "DIFFERS"}  registers {regs}'
                  + (f'  chain floor {row["chain_floor_ms"]:.3f} ms (events)'
                     if name == 'fps' else ''), flush=True)
        del kcuda._libs[name]
    cs.OUT_DIR.mkdir(exist_ok=True)
    (cs.OUT_DIR / 'kernel_variants.json').write_text(json.dumps(record, indent=1))
    print(smi)
    return 0 if all(v['equal_to_kept'] for v in record['variants']) else 1


if __name__ == '__main__':
    sys.exit(main())
