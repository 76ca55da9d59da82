"""Run one cell of the port's benchmark once and print its result.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell (``BENCHMARK.json``'s ``workloads``) names a configuration file
under ``benchmark/configs/`` and a traffic file under ``benchmark/traffic/``;
its limits are ``benchmark/limits/<name>.json`` and each per-layer metric is
read by ``benchmark/metrics/<metric>.py``. With ``--trace 0`` the result
holds the cell's end-to-end metrics, with ``--trace 1`` its per-layer ones.
The last line of standard output is the result as one JSON object; the
numbers that decided ``correct`` are also the last lines of standard error.
It needs the CUDA card(s) the cell asks for, and exits with 2 (printing no
result) without them."""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
REPO = BENCH.parent
# build and kernel caches of the program live in the checkout, at fixed paths
os.environ['TRITON_CACHE_DIR'] = str(REPO / 'build' / 'triton')
os.environ['TORCH_EXTENSIONS_DIR'] = str(REPO / 'build' / 'torch_extensions')
sys.path.insert(1, str(REPO))

FORBIDDEN = ('jax', 'jaxlib', 'flax', 'fv2p_tpu')


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split('.')[0] for m in list(sys.modules)} & set(FORBIDDEN))


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None):
    args = parse(argv)
    import torch

    from fvbench.cell import Cell
    cell = Cell(args.workload)
    chips = int(cell.entry['chips'])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f'{cell.name} needs {chips} CUDA card(s); this machine has '
              f'{torch.cuda.device_count() if torch.cuda.is_available() else 0}',
              file=sys.stderr)
        return 2
    from fvbench import harness
    fields = harness.run(cell, args.seed, args.seconds, bool(args.trace), T_START)
    loaded = forbidden_modules()
    if loaded:
        print(f'modules of JAX or the JAX package were loaded: {loaded}', file=sys.stderr)
        return 3
    metrics = fields['metrics']
    if not args.trace:
        units = {m['name']: m['unit'] for m in cell.end_to_end}
        metrics = {k: {'value': v, 'unit': units[k]} for k, v in metrics.items()}
    checks = {k: {'value': c['value'], 'limit': c['limit']} for k, c in fields['checks'].items()}
    result = {'correct': fields['correct'], 'attempted': fields['attempted'],
              'failed': fields['failed'], 'metrics': metrics, 'device': fields['device']}
    if 'breakdown' in fields:
        result['breakdown'] = fields['breakdown']
    result['checks'] = checks
    print(json.dumps({'readings': fields['readings']}, default=str), file=sys.stderr)
    for name, c in fields['checks'].items():
        print(f'check {name}: {c["value"]!r} (limit {c["limit"]!r}) '
              f'{"ok" if c["ok"] else "FAILED"}', file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
