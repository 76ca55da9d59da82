"""The readings that a cell's limits are set from, for many seeds in one
process (set-up and the kernel build are paid once):

    python3 benchmark/readings.py --workload <name> --side program --seeds 1 2 3 --seconds 5
    python3 benchmark/readings.py --workload <name> --side control --seeds 1 2 3

``program``: a run of the cell per seed with a short window, its readings
of every number that decides ``correct``. ``control``: the reference in the
program's place one precision below (``fvbench.control``). ``reorder``: the
reference summing its products in another order, in the program's place
(a sound witness). ``half_batch`` (training cells): the reference with
half of each batch left out, in the program's place. One JSON line a seed. It needs the CUDA card; the benchmark's own runs never run it."""
import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
sys.path.insert(1, str(BENCH.parent))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--side', choices=('program', 'control', 'reorder', 'half_batch'), required=True)
    p.add_argument('--seeds', type=int, nargs='+', required=True)
    p.add_argument('--seconds', type=float, default=5.0)
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print('readings.py needs the CUDA card', file=sys.stderr)
        return 2
    from fvbench import control, harness
    from fvbench.cell import Cell
    cell = Cell(args.workload)
    for seed in args.seeds:
        t0 = time.perf_counter()
        if args.side == 'program':
            fields = harness.run(cell, seed, args.seconds, False, t0)
            line = {'readings': fields['readings'], 'correct': fields['correct'],
                    'metrics': fields['metrics'],
                    'memory_peak_bytes': fields['device'].get('memory_peak_bytes')}
        else:
            line = {'readings': control.readings(cell, seed, side=args.side)}
        line.update(workload=cell.name, side=args.side, seed=seed,
                    seconds=time.perf_counter() - t0)
        print(json.dumps(line, default=str), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == '__main__':
    sys.exit(main())
